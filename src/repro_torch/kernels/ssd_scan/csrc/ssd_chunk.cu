// SSD intra-chunk compute (the Mamba2 hot loop) for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py:54 (ssd_chunk_pallas,
// body _ssd_chunk_kernel at :22), the Pallas TPU kernel behind
// repro.kernels.ssd_scan.ops.ssd_scan. Reached here from
// repro_torch.models.blocks.mamba2_forward (every Mamba2 layer's prefill)
// through repro_torch.kernels.ssd_scan.ops.ssd_scan / ssd_chunk.
//
// Per (batch*head bh, chunk c), as the Pallas kernel and
// ref.py::ssd_chunk_plain, all float32:
//   cum     = cumsum(dt * A)                                [Q]
//   M_ij    = (C_i . B_j) * exp(cum_i - cum_j) * dt_j,  j <= i; else 0
//   y_intra = M x                                           [Q, P]
//   state   = x^T (B * (dt * exp(cum_end - cum)))           [P, N]
// B and C are read from batch row bh / H: the heads of a batch share them.
// exp(cum_i - cum_j) is evaluated only where j <= i: above the diagonal the
// difference is positive and can overflow, and inf * 0 would be NaN.
//
// Bound on an H100 SXM (3.35 TB/s; 495 TFLOP/s dense tf32): at the serving
// shape (Bsz 4, H 64, 4 chunks of 128, P 64, N 64) the function moves ~86 MB
// (x and y 33.5 MB each, states 16.8 MB) -> 0.026 ms; its float32-accurate
// work is three tf32 products per float32 product on ~3.2 GFLOP -> 0.019 ms,
// so bytes bind.
//
// Design:
//   - All three products run as split-TF32 wgmma (wgmma.cuh: hi and lo of
//     each operand, lo*hi + hi*lo + hi*hi into one float32 accumulator),
//     which keeps the result near float32 where one tf32 product would not
//     meet the 1e-4 tolerance of the chunked scan.
//   - One block takes one (batch, chunk) and a group of heads: C B^T
//     (shared by the heads of a batch) is formed once for the group, and
//     each head only applies its own decay and dt. The host picks the group
//     size so that about one block runs per SM (ops.py::ssd_plan); the block
//     holds 182 KB of shared memory at N 64 (214 KB at N 128).
//   - Three warpgroups, each with its own products per head: warpgroup 0
//     rows 0-63 of C B^T, M and y (M x sums over 64 causal columns) and, at
//     N > 64, state rows 64-127; warpgroup 1 rows 64-127 of C B^T, M and y
//     (128 columns); warpgroup 2 state rows 0-63, and its first warp copies
//     and scans the next head's dt while this head's products run (cum, dt
//     and the state weights are double-buffered by head), so a head costs
//     two block-wide barriers. C B^T leaves its accumulators for shared
//     memory, each thread's own fragment as float4 per k8 block, so no
//     warpgroup holds more than one 64 x 64 accumulator through the head
//     loop: with C B^T in registers the kernel needed 255 registers,
//     spilled, and ptxas serialised its wgmma.
//   - wgmma takes tf32 operands K-major only. C B^T reads C as the A
//     operand from registers and B [Q][N] as B, split into hi/lo in 32-wide
//     column chunks. y = M x and state^T = (B * w)^T x share one copy of
//     x^T [P][Q] as hi and lo in shared memory, made in the pass that splits
//     it. Each thread builds M on its own C B^T accumulator elements and
//     passes them as A fragments: the accumulator and the tf32 A fragment
//     lay out columns differently, so x^T stores its Q index permuted
//     within each block of 8 to match (wgmma.cuh), and the state's A
//     fragments, (B * w)^T read from a raw copy of B, take the same
//     permutation. No exchange between threads.
//   - The A values of the next two k8 steps (loads, exp) are computed while
//     the current two steps' products run, and split into A registers only
//     after waiting for them (xt_products): ptxas serialises register-A
//     products whose registers are rewritten while any product is in
//     flight.
//   - Copies: B, and the next head's x tile and dt, are copied into shared
//     memory by cp.async (16 bytes where rows allow, else 4; zero-filled
//     past Q, P and N, so any shape takes the same path) while other work
//     runs; every operand passes through registers once to be split (and x
//     to be transposed), which TMA would not save.
//   - exp(cum_i - cum_j) is ex2.approx of (cum_i - cum_j) * log2(e): its
//     relative error grows with |cum_i - cum_j| (~2^-24 per unit) while the
//     value falls as exp(-|cum_i - cum_j|), so it adds at most ~4e-8 of
//     C_i . B_j dt_j to any M_ij. Masked entries take exp(-inf) = 0, with no
//     branch. The state weights, one per row, use expf.
//   - Chunk rows past Q (a prompt shorter than the chunk) are zero: x, B, C
//     and dt read as 0, so cum stays at cum_end there, M and w are 0, and
//     neither y's real rows, the state nor cum_end move. Every product runs
//     its full 8 or 16 steps (a product on a divergent path is serialised),
//     so a short chunk multiplies zeros.
// What bounds it now: products whose A operand comes from registers that
// were just computed run well below the tensor rate (the three
// warpgroups' 120 products of a head take several times their 32 cycles
// each); warpgroup 1's 16 y steps, each with four exps and splits a thread,
// are the longest path of a head, while warpgroup 0 has 8 and warpgroup 2's
// 16 state steps are light; the per-head split of x and two barriers run
// between the heads' products; one block per SM leaves the prologue
// (C B^T) unhidden.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "../../wgmma.cuh"

namespace {

using wg::split;
using wg::swz;

constexpr int kThreads = 384;          // three warpgroups
constexpr int kQ = 128;                // chunk rows, padded
constexpr int kP = 64;                 // head dim, padded
constexpr int kBoxFloats = kP * 32;    // one 32-column box of x^T
constexpr int kXtFloats = kP * kQ;     // x^T hi (or lo): 32 KB
// C B^T fragments of warpgroups 0 and 1 (64 and 128 columns of their 64
// rows), each thread's own, as float4 per k8 block: 48 KB
constexpr int kGmFloats = 4 * 128 * (8 + 16);
constexpr int kAlign = 1024;           // the 128-byte swizzle's period
constexpr unsigned kFull = 0xffffffffu;

// B's columns, padded to whole 64-row state tiles (and so to 32-wide chunks)
__host__ __device__ constexpr int n_pad(int N) { return (N + 63) / 64 * 64; }

// x^T hi and lo, the next head's x [kQ][kP] as copied, C B^T, B raw
// [kQ][n_pad + 4] (the pad keeps the state's fragment reads free of bank
// conflicts), then cum, dt and the state weights of two heads, [2][kQ]
// each; plus the alignment slack of the swizzled tiles.
__host__ __device__ constexpr int smem_bytes(int N) {
  return kAlign + 4 * (2 * kXtFloats + kQ * kP + kGmFloats +
                       kQ * (n_pad(N) + 4) + 6 * kQ);
}

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;\n" ::: "memory");
}

// 4- and 16-byte asynchronous copies to shared memory; zero-filled when
// !ok (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wg::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wg::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split(v[u], hi[u], lo[u]);
}

struct Args {
  const float* x;   // [BH, nc, Q, P]
  const float* dt;  // [BH, nc, Q]
  const float* B;   // [Bsz, nc, Q, N]
  const float* C;   // [Bsz, nc, Q, N]
  const float* A;   // [BH]
  float* y;         // [BH, nc, Q, P]
  float* st;        // [BH, nc, P, N]
  float* cum;       // [BH, nc, Q]
  int nc, Q, P, N, H, group, n_groups;
};

struct Smem {
  float* xt;    // x^T hi, then lo, [kQ / 32 boxes][kP][32] each
  float* xs;    // the next head's x [kQ][kP]
  float* gm;    // C B^T fragments
  float* braw;  // B [kQ][ldb]
  float* cum;   // [kQ] each, of one head
  float* dts;
  float* wts;
  int ldb;
};

// This thread's place in its warpgroup's m64 tiles: rows 16*warp + g and
// + 8, column pairs 2c (wgmma.cuh).
struct Lane {
  int wtid, g, c;
  __device__ Lane() {
    wtid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    g = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    c = lane & 3;
  }
};

// descriptor of k8 block kb of x^T (hi or lo): box kb / 4, 32 bytes a step
__device__ __forceinline__ uint64_t xt_desc(uint32_t base, int kb) {
  return wg::desc128(base + (kb >> 2) * kBoxFloats * 4 + 32 * (kb & 3));
}

// One 32-wide column chunk of C B^T into gm: C's fragments straight from
// device memory, split in registers; B's chunk as hi and lo at sm.xt.
template <int NH>
__device__ __forceinline__ void form_cbt_chunk(const Args& a, const Smem& sm,
                                               long long bc0, int n0, int i0,
                                               int i1, float (&gm)[NH]) {
  const Lane ln;
  const int Q = a.Q, N = a.N;
  const float* bch = sm.xt;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int n = n0 + 8 * kk + ln.c;
    const float v[4] = {
        i0 < Q && n < N ? a.C[bc0 + i0 * N + n] : 0.f,
        i1 < Q && n < N ? a.C[bc0 + i1 * N + n] : 0.f,
        i0 < Q && n + 4 < N ? a.C[bc0 + i0 * N + n + 4] : 0.f,
        i1 < Q && n + 4 < N ? a.C[bc0 + i1 * N + n + 4] : 0.f};
    split4(v, ah[kk], al[kk]);
  }
  const uint32_t b_hi = wg::smem_addr(bch);
  const uint32_t b_lo = wg::smem_addr(bch + kQ * 32);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wg::wgmma_tf32_rs(gm, al[kk], wg::desc128(b_hi + 32 * kk));
    wg::wgmma_tf32_rs(gm, ah[kk], wg::desc128(b_lo + 32 * kk));
    wg::wgmma_tf32_rs(gm, ah[kk], wg::desc128(b_hi + 32 * kk));
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(gm);
}

// acc += sum over k8 steps 0..NS-1 of A_step x^T_step, split: the A values
// of a step come from vals(step, v) (v[u] at this thread's fragment
// positions a[u], wgmma.cuh), x^T's from shared memory. Steps go in groups
// of kGroup. The values of group g + 1 (the loads and exps) are computed
// while group g's products run; only then does the warpgroup wait for them,
// split the values into the A registers and issue group g + 1. No A
// register is written while a product that may read it is in flight, so
// ptxas keeps the products asynchronous.
constexpr int kGroup = 2;

template <int NS, typename Vals>
__device__ __forceinline__ void xt_products(float (&acc)[32], const Smem& sm,
                                            Vals vals) {
  static_assert(NS % kGroup == 0, "whole groups");
  const uint32_t xt_hi = wg::smem_addr(sm.xt);
  const uint32_t xt_lo = wg::smem_addr(sm.xt + kXtFloats);
  float v[kGroup][4];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) vals(u, v[u]);
#pragma unroll 1
  for (int kb = 0; kb < NS; kb += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) split4(v[u], hi[u], lo[u]);
    wg::wgmma_fence();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      wg::wgmma_tf32_rs(acc, lo[u], xt_desc(xt_hi, kb + u));
      wg::wgmma_tf32_rs(acc, hi[u], xt_desc(xt_lo, kb + u));
      wg::wgmma_tf32_rs(acc, hi[u], xt_desc(xt_hi, kb + u));
    }
    wg::wgmma_commit();
    if (kb + kGroup < NS) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) vals(kb + kGroup + u, v[u]);
    }
    wg::wgmma_wait<0>();
  }
  wg::fence_regs(acc);
}

// C B^T rows 64T..64T+63, columns 0..NG-1 (NG = 64(T + 1), the causal
// part), into this thread's slots of sm.gm. B's 32-wide column chunks go
// through the x^T space as hi and lo [kQ rows][32]; C's fragments come
// straight from device memory, split in registers. Block-wide: every
// warpgroup splits B and meets the barriers; warpgroups 0 and 1 (T < 2)
// multiply.
template <int T>
__device__ __forceinline__ void form_cbt(const Args& a, const Smem& sm,
                                         long long bc0) {
  constexpr int NG = T < 2 ? 64 * (T + 1) : 8;
  const Lane ln;
  const int Q = a.Q, N = a.N;
  const int i0 = 64 * T + ln.g, i1 = i0 + 8;
  float gm[NG / 2];
#pragma unroll
  for (int t = 0; t < NG / 2; ++t) gm[t] = 0.f;
  float* bch = sm.xt;                    // [2][kQ][32]: hi, then lo
  for (int n0 = 0; n0 < n_pad(N); n0 += 32) {
    for (int e = threadIdx.x; e < kQ * 8; e += kThreads) {
      const int j = e >> 3, q4 = 4 * (e & 7);
      const float4 v =
          *reinterpret_cast<const float4*>(sm.braw + j * sm.ldb + n0 + q4);
      const float vv[4] = {v.x, v.y, v.z, v.w};
      uint32_t hi[4], lo[4];
      split4(vv, hi, lo);
      *reinterpret_cast<uint4*>(bch + swz(j, q4)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(bch + kQ * 32 + swz(j, q4)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    wg::fence_async_smem();
    block_sync();
    if constexpr (T < 2) {
      if (64 * T < Q) form_cbt_chunk(a, sm, bc0, n0, i0, i1, gm);
    }
    block_sync();   // the chunk buffer is rewritten next
  }
  // each thread reads back only its own fragment: float4 per k8 block,
  // neighbouring threads at neighbouring addresses
  if constexpr (T < 2) {
    float4* mine = reinterpret_cast<float4*>(sm.gm) + 128 * 8 * T + ln.wtid;
#pragma unroll
    for (int jb = 0; jb < NG / 8; ++jb)
      mine[128 * jb] = make_float4(gm[4 * jb], gm[4 * jb + 1],
                                   gm[4 * jb + 2], gm[4 * jb + 3]);
  }
}

// y rows 64T..64T+63 of one head: M x over the causal k8 blocks, M built
// from C B^T, the decay and dt, and passed as A fragments (columns
// permuted as x^T's rows are: slots c, c + 4 <- columns 2c, 2c + 1).
template <int T>
__device__ __forceinline__ void y_tile(const Args& a, const Smem& sm,
                                       long long row0) {
  constexpr int NG = 64 * (T + 1);
  const Lane ln;
  const int Q = a.Q, P = a.P;
  const int i0 = 64 * T + ln.g, i1 = i0 + 8;
  const float4* mine =
      reinterpret_cast<const float4*>(sm.gm) + 128 * 8 * T + ln.wtid;
  float acc[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) acc[t] = 0.f;
  const float ci0 = sm.cum[i0], ci1 = sm.cum[i1];
  // M on this thread's C B^T elements; slots c, c + 4 <- columns 2c, 2c + 1
  xt_products<NG / 8>(acc, sm, [&](int jb, float (&m)[4]) {
    const int j0 = 8 * jb + 2 * ln.c, j1 = j0 + 1;
    const float4 gv = mine[128 * jb];
    const float2 cj = *reinterpret_cast<const float2*>(sm.cum + j0);
    const float2 dj = *reinterpret_cast<const float2*>(sm.dts + j0);
    // masked (j > i) exponents are -inf, so exp gives exactly 0 without a
    // branch and never overflows
    m[0] = gv.x * __expf(j0 <= i0 ? ci0 - cj.x : -INFINITY) * dj.x;
    m[1] = gv.z * __expf(j0 <= i1 ? ci1 - cj.x : -INFINITY) * dj.x;
    m[2] = gv.y * __expf(j1 <= i0 ? ci0 - cj.y : -INFINITY) * dj.y;
    m[3] = gv.w * __expf(j1 <= i1 ? ci1 - cj.y : -INFINITY) * dj.y;
  });
  float* yb = a.y + row0 * P;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = 8 * j + 2 * ln.c + e;
      if (p < P) {
        if (i0 < Q) yb[i0 * P + p] = acc[4 * j + e];
        if (i1 < Q) yb[i1 * P + p] = acc[4 * j + 2 + e];
      }
    }
}

// state^T rows n = 64t..64t+63 of one head: (B * w)^T x over every row,
// (B * w)^T read from the raw copy of B in the permuted order of x^T.
__device__ __forceinline__ void state_tile(const Args& a, const Smem& sm,
                                           int t, long long st0) {
  const Lane ln;
  const int P = a.P, N = a.N;
  const int n0 = 64 * t + ln.g, n1 = n0 + 8;
  float acc[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) acc[u] = 0.f;
  xt_products<kQ / 8>(acc, sm, [&](int kb, float (&v)[4]) {
    const int q0 = 8 * kb + 2 * ln.c, q1 = q0 + 1;
    const float2 w = *reinterpret_cast<const float2*>(sm.wts + q0);
    v[0] = sm.braw[q0 * sm.ldb + n0] * w.x;
    v[1] = sm.braw[q0 * sm.ldb + n1] * w.x;
    v[2] = sm.braw[q1 * sm.ldb + n0] * w.y;
    v[3] = sm.braw[q1 * sm.ldb + n1] * w.y;
  });
  float* sb = a.st + st0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = 8 * j + 2 * ln.c + e;
      if (p < P) {
        if (n0 < N) sb[p * N + n0] = acc[4 * j + e];
        if (n1 < N) sb[p * N + n1] = acc[4 * j + 2 + e];
      }
    }
}

// cum = inclusive scan of dt * A over the chunk (one warp; rows past Q add
// 0, so they hold cum_end), written to sm.cum and to device memory, and the
// state weights dt * exp(cum_end - cum).
__device__ __forceinline__ void scan_head(const Args& a, const Smem& sm,
                                          int bh, long long row0) {
  const int lane = threadIdx.x & 31;
  const float av = a.A[bh];
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    run += sm.dts[4 * lane + u] * av;
    v[u] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(kFull, tot, off);
    if (lane >= off) tot += n;
  }
  const float base = tot - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = 4 * lane + u;
    v[u] += base;
    sm.cum[i] = v[u];
    if (i < a.Q) a.cum[row0 + i] = v[u];
  }
  const float cend = __shfl_sync(kFull, v[3], 31);   // = cum[Q - 1]
#pragma unroll
  for (int u = 0; u < 4; ++u)
    sm.wts[4 * lane + u] = sm.dts[4 * lane + u] * expf(cend - v[u]);
}

// One block: (batch b, chunk ch, heads h_lo..h_hi-1). Warpgroup W's role:
// 0 forms C B^T rows 0-63 and per head y rows 0-63 and, at N > 64, state
// rows 64-127; 1 forms C B^T rows 64-127 and per head y rows 64-127; 2 per
// head state rows 0-63, and its first warp (the scan warp) copies each
// next head's dt and scans it while the products of this head run. cum,
// dt and the weights are double-buffered by head. All three warpgroups
// meet at every block_sync, two per head.
template <int W>
__device__ __forceinline__ void chunk_body(const Args& a, const Smem& sm) {
  const int tid = threadIdx.x;
  const bool scan_warp = tid >> 5 == 8;
  const int Q = a.Q, P = a.P;
  const int grp = blockIdx.x % a.n_groups;
  const int rest = blockIdx.x / a.n_groups;
  const int ch = rest % a.nc, b = rest / a.nc;
  const int h_lo = grp * a.group;
  const int h_hi = min(a.H, h_lo + a.group);
  const long long bc0 = (static_cast<long long>(b) * a.nc + ch) * Q * a.N;
  auto rows = [&](int hh) {
    return ((static_cast<long long>(b) * a.H + hh) * a.nc + ch) * Q;
  };
  auto head_smem = [&](int hh) {   // this head's cum, dt and weights
    Smem hs = sm;
    const int off = kQ * ((hh - h_lo) & 1);
    hs.cum += off;
    hs.dts += off;
    hs.wts += off;
    return hs;
  };

  // A head's x [kQ][kP] is copied asynchronously, zero past Q and P, while
  // the previous head's products run: 16 bytes a copy where rows allow it.
  const bool x16 = P % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  auto prefetch = [&](int hh) {
    const long long row0 = rows(hh);
    if (x16) {
      for (int e = tid; e < kQ * kP / 4; e += kThreads) {
        const int q = e / (kP / 4), p = 4 * (e % (kP / 4));
        const bool ok = q < Q && p < P;
        cp_async16(sm.xs + 4 * e, ok ? a.x + (row0 + q) * P + p : a.x, ok);
      }
    } else {
      for (int e = tid; e < kQ * kP; e += kThreads) {
        const int q = e / kP, p = e % kP;
        const bool ok = q < Q && p < P;
        cp_async4(sm.xs + e, ok ? a.x + (row0 + q) * P + p : a.x, ok);
      }
    }
    if (scan_warp) {
      const Smem hs = head_smem(hh);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * (tid & 31) + u;
        cp_async4(hs.dts + i, i < Q ? a.dt + row0 + i : a.dt, i < Q);
      }
    }
    cp_async_commit();
  };
  // B of this (batch, chunk), raw and zero past Q and N, and the first
  // head's x and dt, all in flight at once
  const int np = n_pad(a.N);
  if (a.N % 4 == 0 && (reinterpret_cast<uintptr_t>(a.B) & 15) == 0) {
    for (int e = tid; e < kQ * np / 4; e += kThreads) {
      const int q = e / (np / 4), n = 4 * (e % (np / 4));
      const bool ok = q < Q && n < a.N;
      cp_async16(sm.braw + q * sm.ldb + n, ok ? a.B + bc0 + q * a.N + n : a.B,
                 ok);
    }
  } else {
    for (int e = tid; e < kQ * np; e += kThreads) {
      const int q = e / np, n = e % np;
      const bool ok = q < Q && n < a.N;
      cp_async4(sm.braw + q * sm.ldb + n, ok ? a.B + bc0 + q * a.N + n : a.B,
                ok);
    }
  }
  prefetch(h_lo);
  cp_async_wait_all();
  block_sync();
  form_cbt<W>(a, sm, bc0);
  if (scan_warp) scan_head(a, head_smem(h_lo), b * a.H + h_lo, rows(h_lo));

  // the split pass: thread (p = tid % 64, m = tid / 64 + 6k) takes rows
  // q = 8(m/2) + (m%2) + 2u, u = 0..3, which land at x^T positions
  // 8(m/2) + 4(m%2) + u: one 16-byte piece of row p
  const int xp = tid & 63;
  for (int hh = h_lo; hh < h_hi; ++hh) {
    const long long row0 = rows(hh);
    const Smem hs = head_smem(hh);

    // x^T hi/lo of this head, its Q index permuted as wgmma.cuh describes
    for (int m = tid >> 6; m < kQ / 4; m += kThreads / 64) {
      const int pos = 8 * (m >> 1) + 4 * (m & 1);
      const int off = (pos >> 5) * kBoxFloats + swz(xp, pos & 31);
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = sm.xs[(8 * (m >> 1) + (m & 1) + 2 * u) * kP + xp];
      uint32_t hi[4], lo[4];
      split4(v, hi, lo);
      *reinterpret_cast<uint4*>(sm.xt + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm.xt + kXtFloats + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    wg::fence_async_smem();
    block_sync();   // x^T, and this head's scan, are in
    if (hh + 1 < h_hi) prefetch(hh + 1);

    const long long st0 =
        (static_cast<long long>(b * a.H + hh) * a.nc + ch) * P * a.N;
    if constexpr (W < 2) {
      if (64 * W < Q) y_tile<W>(a, hs, row0);
    } else {
      state_tile(a, hs, 0, st0);
    }
    if (W == 0 && a.N > 64) state_tile(a, hs, 1, st0);
    cp_async_wait_all();   // the next head's x (and, here, dt) have landed
    if (scan_warp && hh + 1 < h_hi) {
      __syncwarp();
      scan_head(a, head_smem(hh + 1), b * a.H + hh + 1, rows(hh + 1));
    }
    block_sync();   // x^T is rewritten next
  }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_kernel(Args a) {
  extern __shared__ uint8_t smem_raw[];
  Smem sm;
  sm.xt = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  sm.xs = sm.xt + 2 * kXtFloats;
  sm.gm = sm.xs + kQ * kP;
  sm.braw = sm.gm + kGmFloats;
  sm.ldb = n_pad(a.N) + 4;
  sm.cum = sm.braw + kQ * sm.ldb;   // cum, dt, weights: [2][kQ] each
  sm.dts = sm.cum + 2 * kQ;
  sm.wts = sm.dts + 2 * kQ;

  if (threadIdx.x < 128)
    chunk_body<0>(a, sm);
  else if (threadIdx.x < 256)
    chunk_body<1>(a, sm);
  else
    chunk_body<2>(a, sm);
}

}  // namespace

// Shared memory the kernel asks for at state width N (ops.py::ssd_plan
// states the same sum).
extern "C" int ssd_chunk_smem_bytes(int N) { return smem_bytes(N); }

// Launches one block per (batch, chunk, group of `group` heads) on `stream`
// and returns cudaGetLastError() (0 on success); a refused shared-memory
// request is returned the same way. Pointers are device pointers to
// contiguous float32 tensors: x [BH,nc,Q,P], dt [BH,nc,Q], B/C [Bsz,nc,Q,N],
// A [BH], y [BH,nc,Q,P], st [BH,nc,P,N], cum [BH,nc,Q], BH = Bsz * H. The
// caller allocates the outputs and checks 1 <= Q <= 128, P <= 64, N <= 128.
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* B, const float* C,
                                const float* A, float* y, float* st,
                                float* cum, int Bsz, int H, int nc, int Q,
                                int P, int N, int group, void* stream) {
  if (Q < 1 || Q > kQ || P < 1 || P > kP || N < 1 || N > 128 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_groups = (H + group - 1) / group;
  const Args args{x, dt, B, C, A, y, st, cum, nc, Q, P, N, H, group, n_groups};
  const long long blocks = static_cast<long long>(n_groups) * nc * Bsz;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
