"""The pure-Python parts of the port's kernel launches, on the CPU: the
tensor-map plans of the two flash-attention kernels (bf16 and float32) and
their alignment checks, the dtype dispatch between them, the SSD chunk
kernel's launch plan (heads per block, shared memory) and the waterfill
kernel's on-chip list budget. The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import re

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.waterfill import ops as wf


# ---- flash attention: the tensor-map plan ----------------------------------
@pytest.mark.parametrize("dtype,hd,swizzle,cols,boxes", [
    (torch.bfloat16, 16, 32, 16, 1), (torch.bfloat16, 32, 64, 32, 1),
    (torch.bfloat16, 64, 128, 64, 1), (torch.bfloat16, 128, 128, 64, 2),
    (torch.float32, 16, 64, 16, 1), (torch.float32, 32, 128, 32, 1),
    (torch.float32, 64, 128, 32, 2), (torch.float32, 128, 128, 32, 4)])
@pytest.mark.parametrize("B,N,X", [(4, 512, 32), (1, 300, 8), (3, 1, 1)])
def test_tma_plan_per_head_width(B, N, X, dtype, hd, swizzle, cols, boxes):
    """(hd, X, N, B) innermost first; byte strides of heads, rows and
    batches; a box of 64 rows of one head, at most 128 bytes wide, swizzled
    at its own width; wider rows take several boxes (bf16 hd 128 two,
    float32 hd 64 two and hd 128 four)."""
    size = 2 if dtype == torch.bfloat16 else 4
    plan = fa.tma_plan((B, N, X, hd), dtype)
    assert plan.dims == (hd, X, N, B)
    assert plan.strides == (size * hd, size * X * hd, size * N * X * hd)
    assert plan.box == (cols, 1, fa.TILE_ROWS, 1)
    assert plan.swizzle == swizzle and plan.boxes == boxes
    assert plan.box[0] * plan.boxes == hd
    assert plan.box[0] * size == plan.swizzle       # one box row = the swizzle
    assert all(s % 16 == 0 for s in plan.strides)
    flat = plan.flat()
    assert len(flat) == fa.PLAN_LEN
    assert flat == [*plan.dims, *plan.strides, *plan.box, plan.swizzle]


@pytest.mark.parametrize("hd", [8, 24, 96, 256])
def test_tma_plan_rejects_unbuilt_head_widths(hd):
    with pytest.raises(ValueError, match="head_dim"):
        fa.tma_plan((1, 64, 2, hd))


@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_tma_operand_base_alignment(offset):
    """A contiguous bf16 view ``offset`` elements into its storage: TMA
    takes it only on a 16-byte boundary."""
    store = torch.zeros(2 * 64 * 4 * 16 + 16, dtype=torch.bfloat16)
    t = store[offset:offset + 2 * 64 * 4 * 16].view(2, 64, 4, 16)
    assert t.is_contiguous()
    if t.data_ptr() % 16 == 0:
        fa.check_tma_operand("q", t.data_ptr(), t.shape)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa.check_tma_operand("q", t.data_ptr(), t.shape)


@pytest.mark.parametrize("shape,dtype,ok", [
    ((1, 8, 1, 4), torch.bfloat16, False), ((1, 8, 3, 4), torch.bfloat16, False),
    ((1, 8, 4, 4), torch.bfloat16, True), ((2, 10, 3, 16), torch.bfloat16, True),
    ((1, 8, 1, 2), torch.float32, False), ((1, 8, 3, 3), torch.float32, False),
    ((1, 8, 1, 4), torch.float32, True), ((2, 10, 3, 16), torch.float32, True)])
def test_tma_operand_row_stride(shape, dtype, ok):
    """The row stride X·hd bytes per element must be a multiple of 16
    (always so for the head widths the kernels are built for)."""
    if ok:
        fa.check_tma_operand("k", 4096, shape, dtype)
    else:
        with pytest.raises(ValueError, match="row stride"):
            fa.check_tma_operand("k", 4096, shape, dtype)


# ---- flash attention: dispatch by dtype ------------------------------------
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "bf16"),
                                          (torch.float32, "f32")])
def test_dtype_dispatch(dtype, kernel):
    """bf16 goes to the bf16-product kernel, f32 to the split-TF32 one: one
    TF32 or bf16 product would round float32 inputs past the 2e-5
    tolerance (tests/test_torch_split_tf32.py)."""
    assert fa.kernel_for(dtype) == kernel


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_dtype_dispatch_rejects_other_types(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.kernel_for(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    """Either dtype on the CPU runs the plain version and counts no launch."""
    before = fa.LAUNCHES
    q = torch.randn(1, 70, 4, 32).to(dtype)
    k = torch.randn(1, 90, 2, 32).to(dtype)
    out = fa.flash_attention(q, k, k, causal=True)
    assert out.dtype == dtype and out.shape == q.shape
    assert fa.LAUNCHES == before


# ---- SSD chunk: the launch plan ---------------------------------------------
@pytest.mark.parametrize("Bsz,H,nc,group,blocks", [
    (4, 64, 4, 8, 128),      # zamba2-1.2b serving: 4 x 512 tokens, N 64
    (4, 32, 4, 4, 128),      # mamba2-370m at the same prompts, N 128
    (2, 3, 2, 1, 12),        # few heads: one a block
    (4, 10, 8, 3, 128),      # groups of 3, 3, 3 and 1 heads
    (8, 64, 64, 64, 512),    # long prompts: every head of a chunk at once
    (1, 1, 1, 1, 1)])
def test_ssd_plan_heads_per_block(Bsz, H, nc, group, blocks):
    """Heads of one (batch, chunk) share a block, as few groups as fill one
    wave of 132 blocks (one block per SM) and no more, since every group
    forms C·Bᵀ again; every head lands in exactly one block."""
    plan = ssd.ssd_plan(Bsz, H, nc, 128, 64, 64)
    assert (plan.group, plan.blocks) == (group, blocks)
    n_groups = blocks // (Bsz * nc)
    assert (n_groups - 1) * group < H <= n_groups * group


@pytest.mark.parametrize("N,smem", [(64, 186_368), (128, 219_136),
                                    (1, 186_368), (72, 219_136)])
def test_ssd_plan_shared_memory(N, smem):
    """xᵀ hi and lo (64 KB), the next head's x (32 KB), C·Bᵀ (48 KB), B raw
    [128][N padded to 64, + 4], six [128] vectors (cum, dt and weights of
    two heads) and 1 KB of alignment: under the 232,448 bytes a block may
    take at N 64 and N 128."""
    plan = ssd.ssd_plan(4, 64, 4, 128, 64, N)
    assert plan.smem_bytes == ssd.smem_bytes(N) == smem
    assert smem <= ssd.SMEM_LIMIT == 232_448


def test_ssd_plan_tiles_match_the_kernel_source():
    src = ssd.SOURCE.read_text()
    for name, value in (("kQ", ssd.MAX_Q), ("kP", ssd.MAX_P)):
        hit = re.search(rf"constexpr int {name} = (\d+);", src)
        assert hit and int(hit.group(1)) == value


@pytest.mark.parametrize("shape", [(4, 64, 4, 0, 64, 64), (4, 64, 4, 129, 64, 64),
                                   (4, 64, 4, 128, 65, 64), (4, 64, 4, 128, 0, 64),
                                   (4, 64, 4, 128, 64, 129), (4, 64, 4, 128, 64, 0),
                                   (0, 64, 4, 128, 64, 64), (4, 0, 4, 128, 64, 64)])
def test_ssd_plan_refuses_unbuilt_shapes(shape):
    with pytest.raises(ValueError):
        ssd.ssd_plan(*shape)


# ---- waterfill: the on-chip list ---------------------------------------------
def test_list_budget_fits_the_card():
    """The list of LIST_BUDGET flows needs no opt-in above 48 KB and leaves
    room for several blocks on one SM (227 KB of shared memory)."""
    smem = wf.list_smem_bytes()
    assert smem == wf.LIST_BUDGET * wf.LIST_ENTRY_BYTES
    assert smem <= 48 * 1024
    assert 227 * 1024 // smem >= 4


def test_list_entry_matches_the_kernel_source():
    src = wf.SOURCE.read_text()
    hit = re.search(r"constexpr int kListEntryBytes = (\d+);", src)
    assert hit and int(hit.group(1)) == wf.LIST_ENTRY_BYTES


@pytest.mark.parametrize("budget", [0, 1, 5, wf.LIST_BUDGET])
def test_streamed_rows_are_those_over_budget(budget):
    """A row streams from device memory exactly when its masked flows
    (nonzero mask entries, whatever their value) exceed the budget."""
    F = wf.LIST_BUDGET + 3
    counts = [0, budget, budget + 1, F]
    mask = torch.zeros(len(counts), F)
    for row, n in enumerate(counts):
        mask[row, :n] = 0.5 if row % 2 else 1.0
    got = wf.streamed_rows(mask, budget).tolist()
    assert got == [n > budget for n in counts]


def test_list_budget_rejects_negative():
    with pytest.raises(ValueError, match=">= 0"):
        wf.list_smem_bytes(-1)
