// Flash attention forward (online softmax, GQA, optional causal mask) for
// Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:78
// (flash_attention_pallas, body _flash_kernel at :31), the Pallas TPU kernel
// behind repro.kernels.flash_attention.ops.flash_attention. Reached here from
// repro_torch.models.lm._attn_block (every prefill application of an
// attention block) through repro_torch.kernels.flash_attention.ops, which
// dispatches by dtype to one of the two kernels below.
//
// Semantics, as in the Pallas kernel and ref.py::attention_plain:
//   s_ij = (q_i . k_j) * 1/sqrt(hd), masked to -1e30 where j > i (causal);
//   running row max m (from -1e30, so exp(m_prev - m_new) stays finite),
//   running sum l and accumulator acc in float32; out = acc / max(l, 1e-30)
//   in q's dtype. Query head h reads KV head h / (H / K): KV is never
//   repeated. Masked keys (j > i, j >= T) give p = 0 exactly.
//
// Layout: q [B,S,H,hd], k/v [B,T,K,hd], o [B,S,H,hd], read and written in
// place (the model's layout; no transposes around the call). One thread
// block per (b*h, tile of 64 query rows; 128 in float32 up to hd 64), a
// loop over 64-key K/V tiles.
// Causal tiles wholly above the diagonal are skipped; rows >= S are never
// stored, so S and T need not be multiples of 64.
//
// Both kernels share one shape: one producer warp issues TMA copies (the Q
// tile once, then a ring of K/V tiles, each completing on an mbarrier, and
// waits on an "empty" mbarrier before reusing a stage); each consumer
// warpgroup (4 warps, 64 query rows) runs S = Q K^T and O += P V as wgmma
// and the online softmax in registers on the accumulator fragment (row max
// and sum across the four lanes of a quad; base 2, the scale folded into
// one FMA before each exp2; O rescaled only when a row max moved); the
// heaviest causal query tiles are scheduled first. Tensor maps describe K
// and V as 4-D (hd, K, T, B) and Q as (hd, H, S, B): a tile past T or S is
// zero-filled by TMA and never reads the next batch's rows, and 0 * v of a
// zero v keeps masked keys exact. The wgmma descriptors declare the swizzle
// TMA writes (ops.py::tma_plan holds the plan the host encodes; a mismatch
// would give wrong numbers, not an error).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 and 495 TFLOP/s tf32 on
// the tensor cores): at the serving shape (B 4, H = K = 32, S = T = 512,
// hd 64) the function moves q, k, v and o once and does 4.3 GFLOP causal.
// In bf16 that is 33.5 MB -> 0.010 ms against 0.004 ms of products, so
// bytes bind; in float32, 67 MB -> 0.020 ms against three tf32 products per
// float32 product (below) -> 0.026 ms, so operations bind.
//
// bfloat16 (the serving path): S = Q K^T as wgmma m64n64k16 with A and B in
// shared memory; O += P V as wgmma m64n{hd}k16 with P as the A operand in
// registers (the score fragment is already the bf16 A fragment's layout)
// and V [keys][hd] as B in MN-major form (the transpose bit). A box row is
// hd*2 bytes swizzled at 32, 64 or 128 bytes (hd 16, 32, 64); hd 128 takes
// two 64-wide boxes. O leaves through shared memory as 16-byte pieces of
// whole rows. What bounds it now: within a tile the tensor cores, the exp2
// unit and the FMA pipe take turns rather than overlapping, only the ~4
// blocks on an SM overlap one another, and each block pays its set-up, the
// latency of its Q tile and its epilogue around its 1-8 tiles. Numerics:
// products of bf16 operands are exact in float32, so Q K^T matches the JAX
// kernel's upcast-then-multiply up to summation order. P is rounded to bf16
// before P V, at most 2^-9 relative per term: inside the 2e-2 bf16
// tolerance and at the output's own bf16 rounding.
//
// float32: both products as split-TF32 wgmma (wgmma.cuh: each operand as
// tf32 hi and lo, lo*hi + hi*lo + hi*hi into one float32 accumulator), near
// float32 where one tf32 product would break the 2e-5 tolerance (and the
// 1e-5 relative card-vs-CPU check of a float32 model). TMA lands float32
// tiles (a row of hd floats as boxes of 32, the 128-byte swizzle; hd 16 as
// one 64-byte box); the consumers split Q once and each K tile in place (hi
// over the tile, lo beside it, the swizzle kept). tf32 operands are K-major only, so V is transposed while it is
// split into V^T [hd][keys] hi and lo, its keys permuted within each block
// of 8 so that P goes from the score accumulator straight into A fragments
// (the tf32 A fragment lays out columns differently from the accumulator;
// wgmma.cuh). Up to hd 64 a block has two consumer warpgroups (128 query
// rows) that share each K/V tile's split; V is split while S = Q K^T runs
// and the next K while P V runs. What bounds it now: the split passes (a
// shared-memory read and two writes of every K and V element, and the
// split of P) and the softmax still take about as long as the products,
// and the register-A products of P V issue below the tensor rate; one
// block runs per SM (177 KB of shared memory at hd 64), and hd 128 has one
// warpgroup and one K/V stage.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "../../wgmma.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per K/V tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAlign = 1024;            // a 128-byte swizzle's period

using wg::smem_addr;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map, (c0, c1, c2, c3) innermost first, into
// shared memory; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// Barrier 1 over the NC consumer threads alone (the producer has left).
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// One tile's online-softmax step on the score fragment (rows i0 and i1,
// this thread's keys key0 + 8j + {0,1}), in base 2: the running max m is
// kept in units of scale*log2(e), so exp(scale*s - max) is one
// exp2(fma(s, scale2, -m)). Masked keys (kMask) give p = 0 exactly; the
// running max starts at -1e30, so exp2(m_prev - m_new) stays finite. Leaves
// P in sc and the factors that rescale the accumulator rows in corr0, corr1.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& corr0, float& corr1,
                                             int key0, int i0, int i1,
                                             int T_len, int causal,
                                             float scale2) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * j + e;
      const bool ok0 = !kMask || (key < T_len && (!causal || key <= i0));
      const bool ok1 = !kMask || (key < T_len && (!causal || key <= i1));
      if (ok0) mx0 = fmaxf(mx0, sc[4 * j + e]);
      if (ok1) mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  // a row with no key yet keeps -1e30 (the scale is positive)
  const float mn0 = fmaxf(m0, mx0 == kNegInf ? kNegInf : mx0 * scale2);
  const float mn1 = fmaxf(m1, mx1 == kNegInf ? kNegInf : mx1 * scale2);
  corr0 = exp2f(m0 - mn0);
  corr1 = exp2f(m1 - mn1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * j + e;
      const bool ok0 = !kMask || (key < T_len && (!causal || key <= i0));
      const bool ok1 = !kMask || (key < T_len && (!causal || key <= i1));
      const float p0 = ok0 ? exp2f(fmaf(sc[4 * j + e], scale2, -mn0)) : 0.f;
      const float p1 =
          ok1 ? exp2f(fmaf(sc[4 * j + 2 + e], scale2, -mn1)) : 0.f;
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      sum0 += p0;
      sum1 += p1;
    }
  }
  sum0 += __shfl_xor_sync(kFull, sum0, 1);
  sum0 += __shfl_xor_sync(kFull, sum0, 2);
  sum1 += __shfl_xor_sync(kFull, sum1, 1);
  sum1 += __shfl_xor_sync(kFull, sum1, 2);
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// ===== float32: split-TF32 on the tensor cores, TMA =====================
namespace f32 {

// Up to hd 64 a block holds two consumer warpgroups (128 query rows) that
// share each K/V tile's split; hd 128 keeps one warpgroup and one K/V stage,
// as more would pass the 227 KB a block may use.
template <int HD>
struct Tile {
  static constexpr int kWG = HD == 128 ? 1 : 2;        // consumer warpgroups
  static constexpr int kNC = 128 * kWG;                // consumer threads
  static constexpr int kThreads = kNC + 32;            // + one producer warp
  static constexpr int kRows = 64 * kWG;               // query rows a block
  static constexpr int kStages = HD == 128 ? 1 : 2;    // K/V tiles in flight
  static constexpr int kSwizzle = HD * 4 < 128 ? HD * 4 : 128;
  static constexpr int kBoxCols = kSwizzle / 4;        // floats per box row
  static constexpr int kBoxes = HD / kBoxCols;         // boxes per tile
  static constexpr int kBoxBytes = 64 * kSwizzle;      // 64 rows
  static constexpr int kBytes = kBoxes * kBoxBytes;    // one 64 x HD tile
  static constexpr int kLayout = kSwizzle == 128 ? 1 : 2;   // 128 or 64 B
  // Q (hi in place) and Q lo per warpgroup; the K/V ring (K hi in place);
  // K lo; V^T hi and lo, each [HD][64 keys] as two boxes of 32 keys
  static constexpr int kSmem =
      kAlign + kBytes * (2 * kWG + 2 * kStages + 3);
};

// Float offset of (row, col) in a box whose rows are SW bytes, in the
// swizzle TMA writes: the 16-byte chunk index XOR address bits 7.. .
template <int SW>
__device__ __forceinline__ int box_off(int row, int col) {
  int o = row * SW + col * 4;
  o ^= ((o >> 7) & (SW / 16 - 1)) << 4;
  return o >> 2;
}

// Splits a tile in place: the float32 values at p become their tf32 hi, the
// lo go to the same offsets at lo. Offsets are kept, so the swizzle is.
template <int NC>
__device__ __forceinline__ void split_tile(float* p, float* lo, int n_floats) {
  for (int e = 4 * threadIdx.x; e < n_floats; e += 4 * NC) {
    const float4 v = *reinterpret_cast<const float4*>(p + e);
    uint32_t h[4], l[4];
    wg::split(v.x, h[0], l[0]);
    wg::split(v.y, h[1], l[1]);
    wg::split(v.z, h[2], l[2]);
    wg::split(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(p + e) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// V [64 keys][HD] as TMA landed it -> V^T hi and lo [HD][64 key slots],
// each slot holding key 8j + kSlotCol[slot % 8] (wgmma.cuh), in two boxes of
// 32 slots in the 128-byte swizzle. Thread item (d, m): keys
// 8(m/2) + (m%2) + 2u, u = 0..3, land at slots 8(m/2) + 4(m%2) + u, one
// 16-byte piece; neighbouring threads take neighbouring d, so neither the
// reads nor the writes meet on a bank.
template <int HD>
__device__ __forceinline__ void transpose_split_v(const float* v, float* vt_hi,
                                                 float* vt_lo) {
  using TL = Tile<HD>;
  for (int e = threadIdx.x; e < HD * 16; e += TL::kNC) {
    const int d = e % HD, m = e / HD;
    const float* vb = v + (d / TL::kBoxCols) * (TL::kBoxBytes / 4);
    const int col = d % TL::kBoxCols;
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = 8 * (m >> 1) + (m & 1) + 2 * u;
      wg::split(vb[box_off<TL::kSwizzle>(key, col)], h[u], l[u]);
    }
    const int slot = 8 * (m >> 1) + 4 * (m & 1);
    const int off = (slot >> 5) * (HD * 32) + wg::swz(d, slot & 31);
    *reinterpret_cast<uint4*>(vt_hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(vt_lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// q [B,S,H,hd], k/v [B,T,K,hd] (float32) through tensor maps over (hd,
// heads, rows, B); o [B,S,H,hd] written from registers. One block per
// (b*h, kRows query rows): warpgroup w computes rows 64w..64w+63, the last
// warp loads.
template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads) flash_f32_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int S,
    int T_len, int H, int K, float scale, int causal) {
  using TL = Tile<HD>;
  constexpr int kStages = TL::kStages;
  constexpr int kNC = TL::kNC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  float* q_s = reinterpret_cast<float*>(base);         // Q, then its tf32 hi
  float* q_lo = q_s + TL::kWG * TL::kBytes / 4;
  uint8_t* k_s = base + 2 * TL::kWG * TL::kBytes;      // [kStages] tiles
  uint8_t* v_s = k_s + kStages * TL::kBytes;           // [kStages] tiles
  float* k_lo = reinterpret_cast<float*>(v_s + kStages * TL::kBytes);
  float* vt_hi = k_lo + TL::kBytes / 4;
  float* vt_lo = vt_hi + TL::kBytes / 4;

  // the heaviest query tiles (most causal K/V tiles) are scheduled first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TL::kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    // the Pallas kernel's skip: tile kt runs iff kt*BK <= the last row
    const int last = (q0 + TL::kRows - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kNC / 32) {
    // ---- producer: Q once, then a ring of K/V tiles --------------------
    if (lane == 0) {
      mbar_expect_tx(&q_full, TL::kWG * TL::kBytes);
      for (int w = 0; w < TL::kWG; ++w)
        for (int c = 0; c < TL::kBoxes; ++c)
          tma_load(reinterpret_cast<uint8_t*>(q_s) + w * TL::kBytes +
                       c * TL::kBoxBytes,
                   &tq, &q_full, c * TL::kBoxCols, h, q0 + 64 * w, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TL::kBytes);
        for (int c = 0; c < TL::kBoxes; ++c) {
          tma_load(k_s + s * TL::kBytes + c * TL::kBoxBytes, &tk, &full[s],
                   c * TL::kBoxCols, kvh, kt * kBK, b);
          tma_load(v_s + s * TL::kBytes + c * TL::kBoxBytes, &tv, &full[s],
                   c * TL::kBoxCols, kvh, kt * kBK, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w, query rows q0w..q0w+63 --------------------
  // Accumulator fragments as in wgmma.cuh: rows r0 = 16*(warp%4) + lane/4
  // and r0 + 8, columns 8j + 2*(lane%4) + {0,1}.
  const int w = tid >> 7;
  const int q0w = q0 + 64 * w;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int i0 = q0w + r0, i1 = i0 + 8;         // the two query rows
  const float scale2 = scale * kLog2e;          // scores in base 2
  // tiles this warpgroup's rows see; the block's others it only helps split
  int n_own = n_tiles;
  if (causal) {
    const int last = (q0w + kBQ - 1) / kBK + 1;
    n_own = n_own < last ? n_own : last;
  }
  float acc[HD / 2];
#pragma unroll
  for (int t = 0; t < HD / 2; ++t) acc[t] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  constexpr uint32_t kSbo = 8 * TL::kSwizzle;   // 8 rows of one box

  mbar_wait(&q_full, 0);
  split_tile<kNC>(q_s, q_lo, TL::kWG * TL::kBytes / 4);
  const uint32_t qh_addr = wg::smem_addr(q_s) + w * TL::kBytes;
  const uint32_t ql_addr = wg::smem_addr(q_lo) + w * TL::kBytes;
  const uint32_t kl_addr = wg::smem_addr(k_lo);
  const uint32_t vh_addr = wg::smem_addr(vt_hi), vl_addr = wg::smem_addr(vt_lo);
  auto k_tile = [&](int kt) {
    return reinterpret_cast<float*>(k_s + (kt % kStages) * TL::kBytes);
  };
  // K of a tile is split as soon as it lands, V while S = Q K^T runs
  auto split_k = [&](int kt) {
    mbar_wait(&full[kt % kStages], (kt / kStages) & 1);
    split_tile<kNC>(k_tile(kt), k_lo, TL::kBytes / 4);
  };
  split_k(0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    const int k0 = kt * kBK;
    const bool own = kt < n_own;      // warpgroup-uniform
    wg::fence_async_smem();
    consumers_sync<kNC>();            // Q and this tile's K hi/lo are in
    const uint32_t kh_addr = wg::smem_addr(k_tile(kt));

    // S = Q K^T over hd in k8 steps, both operands K-major: step kk reads
    // box 8kk / kBoxCols at byte (8kk % kBoxCols) * 4 of its rows; the
    // split's three products, small terms first
    float sc[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) sc[t] = 0.f;
    if (own) {
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t off = (8 * kk / TL::kBoxCols) * TL::kBoxBytes +
                             (8 * kk % TL::kBoxCols) * 4;
        const uint64_t dqh = wg::make_desc(qh_addr + off, 16, kSbo, TL::kLayout);
        const uint64_t dql = wg::make_desc(ql_addr + off, 16, kSbo, TL::kLayout);
        const uint64_t dkh = wg::make_desc(kh_addr + off, 16, kSbo, TL::kLayout);
        const uint64_t dkl = wg::make_desc(kl_addr + off, 16, kSbo, TL::kLayout);
        wg::wgmma_tf32_ss(sc, dql, dkh);
        wg::wgmma_tf32_ss(sc, dqh, dkl);
        wg::wgmma_tf32_ss(sc, dqh, dkh);
      }
      wg::wgmma_commit();
    }
    transpose_split_v<HD>(reinterpret_cast<const float*>(v_s + s * TL::kBytes),
                          vt_hi, vt_lo);
    wg::fence_async_smem();
    wg::wgmma_wait<0>();
    wg::fence_regs(sc);
    consumers_sync<kNC>();            // V^T hi/lo are in

    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
    if (own) {
      // online softmax on the fragment, in base 2; only the diagonal tile
      // and a ragged last tile need the mask
      float corr0, corr1;
      if (k0 + kBK > T_len || (causal && k0 + kBK - 1 > q0w))
        softmax_tile<true>(sc, m0, m1, l0, l1, corr0, corr1, k0 + cq, i0, i1,
                           T_len, causal, scale2);
      else
        softmax_tile<false>(sc, m0, m1, l0, l1, corr0, corr1, k0 + cq, i0,
                            i1, T_len, causal, scale2);
      if (__any_sync(kFull, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j] *= corr0;
          acc[4 * j + 1] *= corr0;
          acc[4 * j + 2] *= corr1;
          acc[4 * j + 3] *= corr1;
        }
      }

      // O += P V over the tile's keys in k8 steps: P's fragment becomes the
      // A operand with its keys permuted (wgmma.cuh), V^T [hd][slots] is B
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        wg::acc_to_a(sc, kk, ph[kk], pl[kk]);
      // two commit groups with a wait between them: register-A products
      // issued without one run at a fraction of the tensor rate
      wg::fence_regs(acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 4 * half; kk < 4 * half + 4; ++kk) {
          const uint32_t off = (kk >> 2) * (HD * 128) + 32 * (kk & 3);
          const uint64_t dvh = wg::desc128(vh_addr + off);
          const uint64_t dvl = wg::desc128(vl_addr + off);
          wg::wgmma_tf32_rs(acc, pl[kk], dvh);
          wg::wgmma_tf32_rs(acc, ph[kk], dvl);
          wg::wgmma_tf32_rs(acc, ph[kk], dvh);
        }
        wg::wgmma_commit();
        if (half == 0) wg::wgmma_wait<1>();
      }
    }
    // the next tile's K is split while P V runs (S, the reader of k_lo, is
    // done); with one stage, only once this tile's stage is released
    if (kStages > 1 && kt + 1 < n_tiles) split_k(kt + 1);
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    if (kStages == 1 && kt + 1 < n_tiles) split_k(kt + 1);
  }

  // ---- epilogue: O / l, rows past S never stored -------------------------
  const long long q_stride = static_cast<long long>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r == 0 ? i0 : i1;
    if (i >= S) continue;
    const float inv = 1.f / fmaxf(r == 0 ? l0 : l1, 1e-30f);
    float* orow = o + (static_cast<long long>(b) * S + i) * q_stride +
                  static_cast<long long>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + cq) =
          make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, float* o, int B, int S, int T_len, int H,
           int K, int causal, cudaStream_t stream) {
  using TL = Tile<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + TL::kRows - 1) / TL::kRows);
  flash_f32_kernel<HD><<<grid, TL::kThreads, TL::kSmem, stream>>>(
      tq, tk, tv, o, S, T_len, H, K, 1.0f / sqrtf(static_cast<float>(HD)),
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32


// ===== bfloat16: tensor cores, TMA ======================================
namespace bf16 {

constexpr int kStages = 2;                   // K/V tiles in flight
constexpr int kConsumers = 128;              // one warpgroup: 64 query rows
constexpr int kThreads = kConsumers + 32;    // + one producer warp

// The swizzle TMA writes and wgmma reads: the row of one box in bytes
// (hd*2, at most 128; hd 128 takes two 64-wide boxes).
template <int HD>
struct Tile {
  static constexpr int kSwizzle = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kBoxCols = kSwizzle / 2;        // bf16 per box row
  static constexpr int kBoxes = HD / kBoxCols;         // boxes per tile
  static constexpr int kBoxBytes = 64 * kSwizzle;      // 64 rows
  static constexpr int kBytes = kBoxes * kBoxBytes;    // one 64 x HD tile
  // wgmma descriptor layout codes: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kSmem = kAlign + kBytes * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64x64] (+)= A[64x16] * B[64x16]^T, A and B K-major in shared memory;
// accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x64] = A[64x16] * B[64x16]^T, the first step of a product: D is
// written, not read, so it needs no initial value.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64x16] += A[64x16] * B[16x16], A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x32] += A[64x16] * B[16x32], A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x64] += A[64x16] * B[16x64], A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x128] += A[64x16] * B[16x128], A (bf16 pairs) in registers, B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// q [B,S,H,hd], k/v [B,T,K,hd] through tensor maps over (hd, heads, rows,
// B); o [B,S,H,hd] written from registers. One block per (b*h, 64 query
// rows): warps 0-3 compute, warp 4 loads.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int S, int T_len, int H, int K, float scale, int causal) {
  using TL = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  uint8_t* q_s = base;
  uint8_t* k_s = q_s + TL::kBytes;                   // [kStages] tiles
  uint8_t* v_s = k_s + kStages * TL::kBytes;         // [kStages] tiles

  // the heaviest query tiles (most causal K/V tiles) are scheduled first
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    // the Pallas kernel's skip: tile kt runs iff kt*BK <= q0 + BQ - 1
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: Q once, then a ring of K/V tiles --------------------
    if (lane == 0) {
      mbar_expect_tx(&q_full, TL::kBytes);
      for (int c = 0; c < TL::kBoxes; ++c)
        tma_load(q_s + c * TL::kBoxBytes, &tq, &q_full, c * TL::kBoxCols, h,
                 q0, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TL::kBytes);
        for (int c = 0; c < TL::kBoxes; ++c) {
          tma_load(k_s + s * TL::kBytes + c * TL::kBoxBytes, &tk, &full[s],
                   c * TL::kBoxCols, kvh, kt * kBK, b);
          tma_load(v_s + s * TL::kBytes + c * TL::kBoxBytes, &tv, &full[s],
                   c * TL::kBoxCols, kvh, kt * kBK, b);
        }
      }
    }
    return;
  }

  // ---- consumers: one warpgroup, 64 query rows ---------------------------
  // Accumulator fragment (wgmma m64nN, f32): thread (warp, lane) holds
  // rows r0 = 16*warp + lane/4 and r0 + 8; for each 8-column block j,
  // d[4j], d[4j+1] at (r0, 8j + 2*(lane%4) + {0,1}) and d[4j+2], d[4j+3]
  // at (r0 + 8, the same columns).
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int i0 = q0 + r0, i1 = i0 + 8;          // the two query rows
  const float scale2 = scale * kLog2e;          // scores in base 2
  float acc[HD / 2];
#pragma unroll
  for (int t = 0; t < HD / 2; ++t) acc[t] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  constexpr uint32_t kSbo = 8 * TL::kSwizzle;   // 8 rows of one box

  mbar_wait(&q_full, 0);
  const uint32_t q_addr = smem_addr(q_s);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t k_addr = smem_addr(k_s + s * TL::kBytes);
    const uint32_t v_addr = smem_addr(v_s + s * TL::kBytes);

    // S = Q K^T over hd in steps of 16, both operands K-major: step kk
    // reads box kk*16 / kBoxCols at byte (kk*16 % kBoxCols)*2 of its rows
    float sc[32];
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk * 16 / TL::kBoxCols) * TL::kBoxBytes +
                           (kk * 16 % TL::kBoxCols) * 2;
      const uint64_t da = wg::make_desc(q_addr + off, 16, kSbo, TL::kLayout);
      const uint64_t db = wg::make_desc(k_addr + off, 16, kSbo, TL::kLayout);
      if (kk == 0)
        wgmma_ss_n64_first(sc, da, db);
      else
        wgmma_ss_n64(sc, da, db, 1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(sc);

    // online softmax on the fragment, in base 2; only the diagonal tile
    // and a ragged last tile need the mask
    float corr0, corr1;
    if (k0 + kBK > T_len || (causal && k0 + kBK - 1 > q0))
      softmax_tile<true>(sc, m0, m1, l0, l1, corr0, corr1, k0 + cq, i0, i1,
                         T_len, causal, scale2);
    else
      softmax_tile<false>(sc, m0, m1, l0, l1, corr0, corr1, k0 + cq, i0, i1,
                          T_len, causal, scale2);
    if (__any_sync(kFull, corr0 != 1.f || corr1 != 1.f)) {
      // some row's max moved (corr is exactly 1 where it did not)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }
    }

    // O += P V over the tile's keys in steps of 16: P's fragment is the
    // A operand's register layout; V [keys][hd] is B in MN-major form,
    // 16 keys = 16 rows of every box, boxes kBoxBytes apart
    uint32_t pa[kBK / 16][4];   // all of P packed before the fence
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        pa[kk][t] = pack_bf16(sc[8 * kk + 2 * t], sc[8 * kk + 2 * t + 1]);
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               wg::make_desc(v_addr + kk * 16 * TL::kSwizzle, TL::kBoxBytes,
                         kSbo, TL::kLayout));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
  }

  // ---- epilogue: O / l in bf16, staged in the Q tile (free once every
  // consumer warp is past its last product) as 16-byte pieces
  // whose order within a row is XOR-swizzled by the row, so neither the
  // fragment writes nor the row reads conflict on banks; then stored as
  // whole rows
  constexpr int kPieces = HD / 8;                   // per row
  constexpr int kSwz = kPieces < 8 ? kPieces - 1 : 7;
  __nv_bfloat16* o_s = reinterpret_cast<__nv_bfloat16*>(q_s);
  auto staged = [&](int row, int piece) {
    return o_s + 8 * (row * kPieces + (piece ^ (row & kSwz)));
  };
  consumers_sync<kConsumers>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float inv = 1.f / fmaxf(r == 0 ? l0 : l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < kPieces; ++j)
      *reinterpret_cast<uint32_t*>(staged(row, j) + cq) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
  consumers_sync<kConsumers>();
  const long long q_stride = static_cast<long long>(H) * HD;
  for (int e = tid; e < kBQ * kPieces; e += kConsumers) {
    const int row = e / kPieces, piece = e % kPieces;
    if (q0 + row >= S) break;        // rows past S are never stored
    *reinterpret_cast<uint4*>(
        o + (static_cast<long long>(b) * S + q0 + row) * q_stride +
        static_cast<long long>(h) * HD + 8 * piece) =
        *reinterpret_cast<const uint4*>(staged(row, piece));
  }
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, __nv_bfloat16* o, int B, int S, int T_len,
           int H, int K, int causal, cudaStream_t stream) {
  const int smem = Tile<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, o, S, T_len, H, K, 1.0f / sqrtf(static_cast<float>(HD)),
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16
// cuTensorMapEncodeTiled, a driver-API call, fetched through the runtime so
// that the library links nothing beyond cudart.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Plan of one operand, as ops.py::tma_plan lays it out: dims[4] (elements,
// innermost first), strides[3] (bytes, of dims 1..3), box[4], swizzle
// bytes (32, 64 or 128).
constexpr int kPlanLen = 12;
constexpr int kEncodeMissing = -1000;   // the entry point was not found

int encode(CUtensorMap* map, const void* base, const long long* plan,
           CUtensorMapDataType dtype) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeMissing;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], one[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(plan[i]);
    box[i] = static_cast<cuuint32_t>(plan[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(plan[4 + i]);
  CUtensorMapSwizzle swizzle;
  switch (plan[11]) {
    case 32: swizzle = CU_TENSOR_MAP_SWIZZLE_32B; break;
    case 64: swizzle = CU_TENSOR_MAP_SWIZZLE_64B; break;
    case 128: swizzle = CU_TENSOR_MAP_SWIZZLE_128B; break;
    default: return -static_cast<int>(CUDA_ERROR_INVALID_VALUE);
  }
  const CUresult res = fn(map, dtype, 4,
                          const_cast<void*>(base), dims, strides, box, one,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -static_cast<int>(res);
}

// Encodes the q, k, v tensor maps from their plans and launches the kernel
// of this dtype. A plan whose box or swizzle is not the one the kernel's
// wgmma descriptors read is refused: it would give wrong numbers, not an
// error.
template <typename TL, typename Launch>
int launch_tma(const void* const (&bases)[3], const long long* plans,
               CUtensorMapDataType dtype, Launch launch) {
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long* plan = plans + i * kPlanLen;
    if (plan[7] != TL::kBoxCols || plan[9] != kBQ || plan[11] != TL::kSwizzle)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = encode(&maps[i], bases[i], plan, dtype);
    if (err != 0) return err;
  }
  return launch(maps[0], maps[1], maps[2]);
}

template <int HD>
int launch_f32(const void* const (&bases)[3], const long long* plans,
               float* o, int B, int S, int T_len, int H, int K, int causal,
               cudaStream_t stream) {
  return launch_tma<f32::Tile<HD>>(
      bases, plans, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      [&](const CUtensorMap& tq, const CUtensorMap& tk,
          const CUtensorMap& tv) {
        return f32::launch<HD>(tq, tk, tv, o, B, S, T_len, H, K, causal,
                               stream);
      });
}

template <int HD>
int launch_bf16(const void* const (&bases)[3], const long long* plans,
                __nv_bfloat16* o, int B, int S, int T_len, int H, int K,
                int causal, cudaStream_t stream) {
  return launch_tma<bf16::Tile<HD>>(
      bases, plans, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      [&](const CUtensorMap& tq, const CUtensorMap& tk,
          const CUtensorMap& tv) {
        return bf16::launch<HD>(tq, tk, tv, o, B, S, T_len, H, K, causal,
                                stream);
      });
}

}  // namespace

// Each launcher runs its kernel on `stream` and returns 0 on success, a
// cudaError_t (> 0) from the launch, or minus a CUresult (< 0) from the
// tensor-map encoding. Pointers are device pointers to contiguous tensors
// in the layouts above; `plans` holds three kPlanLen-long plans, for q, k
// and v; the caller allocates `o` and checks shapes (hd in {16, 32, 64,
// 128}).
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* plans, int B,
                                          int S, int T_len, int H, int K,
                                          int hd, int causal, void* stream) {
  const void* bases[3] = {q, k, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fo = static_cast<float*>(o);
  switch (hd) {
    case 16: return launch_f32<16>(bases, plans, fo, B, S, T_len, H, K, causal, st);
    case 32: return launch_f32<32>(bases, plans, fo, B, S, T_len, H, K, causal, st);
    case 64: return launch_f32<64>(bases, plans, fo, B, S, T_len, H, K, causal, st);
    case 128: return launch_f32<128>(bases, plans, fo, B, S, T_len, H, K, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o,
                                           const long long* plans, int B,
                                           int S, int T_len, int H, int K,
                                           int hd, int causal, void* stream) {
  const void* bases[3] = {q, k, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* bo = static_cast<__nv_bfloat16*>(o);
  switch (hd) {
    case 16: return launch_bf16<16>(bases, plans, bo, B, S, T_len, H, K, causal, st);
    case 32: return launch_bf16<32>(bases, plans, bo, B, S, T_len, H, K, causal, st);
    case 64: return launch_bf16<64>(bases, plans, bo, B, S, T_len, H, K, causal, st);
    case 128: return launch_bf16<128>(bases, plans, bo, B, S, T_len, H, K, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == kEncodeMissing)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (code < 0) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
