// Batched per-link allocator solve (paper Alg. 1, eqs. 3/4) for Hopper.
//
// Replaces: repro/kernels/waterfill/kernel.py::waterfill_pallas (body
// _waterfill_block), the Pallas TPU kernel behind allocate(solver="pallas").
// Reached here from repro_torch.core.allocator.allocate(solver="waterfill").
//
// Per link l (one thread block each, 256 threads):
//   kind 0 (uplink, eq. 3):   x_f = C * w_f / sum(w), equal split when
//                             sum(w) <= 1e-9;
//   kind 1 (downlink, eq. 4): theta by N_BISECT = 48 bisection rounds on
//                             sum_f max(theta*rho_f - L_f, 0) * m_f / dt = C,
//                             from hi0 = max(L/rho) + C*dt/sum(rho) + 1, then
//                             x_f = max(theta*rho_f - L_f, 0) * m_f / dt,
//                             renormalised to C.
// Same constants, branches and float32 arithmetic per term as the Pallas
// kernel and as repro_torch/kernels/waterfill/ref.py::waterfill_plain; only
// the order of the float32 sums differs. w, backlog and rho are read with a
// row stride: 0 for one [F] row shared by every link (the allocator's
// layout), F for dense [L, F] inputs; and with a group stride: a fleet
// bucket of B scenarios launches B*L blocks over [B*L, F] masks, block l
// reading its scenario's [F] row at (l / links_per_group) * group_stride
// (links_per_group = 0: no groups, the two layouts above). Uplink rows skip
// the bisection, whose result they never read.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the function must read the [L, F] mask and write the [L, F]
// output once, 8*L*F bytes: 19 us at L = 640, F = 12,417 and 24 us at
// L = 10^4, F = 10^3. Its arithmetic is ~5 flops per masked (link, flow)
// pair per bisection round; the routing mask is sparse (a flow crosses 2-4
// links), so the bytes bind. The first form of this kernel walked the
// whole row (mask, backlog, rho) from L2 on each of its ~50 passes, though
// a datacenter downlink carries ~48 of its 12,417 flows: 0.33 ms.
//
// Design: the masked flows stay on chip.
//   pass 1    reads the mask row once (a scalar head up to the 16-byte
//             boundary, then float4: row l starts at l*F floats and F may be
//             odd) and lists the masked flows, in flow order, in dynamic
//             shared memory: index and mask value. Positions come from warp
//             ballots and popcount prefixes, not atomics, so the order and
//             every sum are the same on every run.
//   gather    reads each listed flow's state once: (L_f, max(rho_f, 1e-9))
//             for a downlink, max(w_f, 0) for an uplink.
//   solve     the reductions, the 48 rounds and the mass pass read only the
//             list. A list of at most kWarpList flows is solved by warp 0
//             alone, from its registers, with butterfly shuffles (no
//             __syncthreads in the rounds; each lane gets the same bits,
//             since float addition and fmaxf commute); a longer one by the
//             whole block from shared memory.
//   emit      writes the [F] output row once: coalesced zeros (in pass 1,
//             beside the mask loads, where the two rows share the 16-byte
//             grid), then the listed flows' rates after a barrier.
// The list holds at most `budget` flows (ops.py::LIST_BUDGET, passed in; 16
// bytes a flow). The wrapper cannot learn a row's count before the launch
// without a host sync, so a row with more masked flows walks its row from
// device memory on every pass instead, as the first form did: a branch the
// data chooses inside the kernel, both branches held to the plain version.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBisect = 48;
constexpr float kEps = 1e-9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVec = 2;                        // float4 loads per thread
constexpr int kSub = kThreads * 4;             // flows per sub-chunk
constexpr int kChunk = kVec * kSub;            // flows per pass-1 step
constexpr int kRegEntries = 4;                 // list entries per lane
constexpr int kWarpList = 32 * kRegEntries;    // lists one warp solves
constexpr int kListEntryBytes = 16;            // index, m, a, b

// Floats from p up to the next 16-byte boundary, at most F.
__device__ __forceinline__ int head_len(const float* p, int F) {
  const int h = static_cast<int>(
      ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / 4u);
  return h < F ? h : F;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// Block-wide reductions: every thread returns the same value, combined in
// the same order, so all threads take the same bisection branch.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();  // the previous reduction's readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += scratch[i];
  return s;
}

__device__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = scratch[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) s = fmaxf(s, scratch[i]);
  return s;
}

// One warp, each lane over the entries it holds in registers (RegRow);
// every lane returns the same bits (butterfly: a + b == b + a).
struct WarpReduce {
  static constexpr int start = 0;
  static constexpr int stride = 1;
  __device__ float sum(float v) const {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  __device__ float max(float v) const {
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
};

struct BlockReduce {
  int start;
  float* scratch;
  static constexpr int stride = kThreads;
  __device__ float sum(float v) const { return block_sum(v, scratch); }
  __device__ float max(float v) const { return block_max(v, scratch); }
};

// Element i of a link's row as the solve reads it: a = L_f (downlink) or
// max(w_f, 0) (uplink), b = max(rho_f, 1e-9) (downlink only), m = mask.
struct ListRow {  // the on-chip list of the masked flows
  const float* a;
  const float* b;
  const float* m;
  __device__ void get(int i, float& ai, float& bi, float& mi) const {
    ai = a[i];
    bi = b[i];
    mi = m[i];
  }
};

struct RegRow {  // a short list, lane l holding entries l + 32k
  float a[kRegEntries], b[kRegEntries], m[kRegEntries];
  __device__ void get(int k, float& ai, float& bi, float& mi) const {
    ai = a[k];
    bi = b[k];
    mi = m[k];
  }
};

struct GlobalRow {  // the whole row in device memory
  const float* w;
  const float* bl;
  const float* r;
  const float* m;
  bool down;
  __device__ void get(int f, float& ai, float& bi, float& mi) const {
    mi = m[f];
    ai = down ? bl[f] : fmaxf(w[f], 0.f);
    bi = down ? fmaxf(r[f], kEps) : 0.f;
  }
};

// What a link's solve leaves for its emit pass.
struct Fill {
  bool down, fb;
  float c, dt, theta, scale, den;
  __device__ float rate(float a, float b, float m) const {
    if (down) return fmaxf(theta * b - a, 0.f) * m / dt * scale;
    return c * (fb ? m : a * m) / den;
  }
};

template <class Row, class Red>
__device__ __forceinline__ Fill solve(const Row& row, int n, const Red& red,
                                      bool down, float c, float dt) {
  Fill fl{down, false, c, dt, 0.f, 1.f, 1.f};
  float a, b, m;
  if (!down) {
    // ---- eq. (3): zero demand falls back to equal split -------------
    float s_w = 0.f, s_m = 0.f;
    for (int i = red.start; i < n; i += red.stride) {
      row.get(i, a, b, m);
      s_w += a * m;
      s_m += m;
    }
    s_w = red.sum(s_w);
    s_m = red.sum(s_m);
    fl.fb = s_w <= kEps;
    fl.den = fl.fb ? fmaxf(s_m, 1.f) : s_w;
    return fl;
  }
  float s_rho = 0.f, mx = 0.f;
  for (int i = red.start; i < n; i += red.stride) {
    row.get(i, a, b, m);
    s_rho += b * m;
    if (m > 0.f) mx = fmaxf(mx, a / b);  // activation points
  }
  s_rho = red.sum(s_rho);
  mx = red.max(mx);

  // ---- eq. (4): drain-time equalization via bisection ----------------
  float lo = 0.f;
  float hi = mx + c * dt / fmaxf(s_rho, kEps) + 1.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.f;
    for (int i = red.start; i < n; i += red.stride) {
      row.get(i, a, b, m);
      s += fmaxf(mid * b - a, 0.f) * m;
    }
    const float alloc = red.sum(s) / dt;
    if (alloc > c) hi = mid; else lo = mid;
  }
  fl.theta = 0.5f * (lo + hi);

  // downlink mass at theta: renormalise the bisection's residual to C
  float s = 0.f;
  for (int i = red.start; i < n; i += red.stride) {
    row.get(i, a, b, m);
    s += fmaxf(fl.theta * b - a, 0.f) * m;
  }
  const float s_dn = red.sum(s) / dt;
  fl.scale = s_dn > kEps ? c / s_dn : 1.f;
  return fl;
}

__device__ void zero_row(float* o, int F) {
  const int head = head_len(o, F);
  if (static_cast<int>(threadIdx.x) < head) o[threadIdx.x] = 0.f;
  const int body = (F - head) / 4;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int i = threadIdx.x; i < body; i += kThreads)
    o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int f = head + 4 * body + threadIdx.x; f < F; f += kThreads)
    o[f] = 0.f;
}

__global__ void __launch_bounds__(kThreads) waterfill_kernel(
    const float* __restrict__ weights, const float* __restrict__ backlog,
    const float* __restrict__ rho, long long flow_stride, int links_per_group,
    long long group_stride, const float* __restrict__ mask,
    const float* __restrict__ cap, const int* __restrict__ kind,
    float* __restrict__ out, int F, float dt, int budget) {
  extern __shared__ float list[];  // budget x {index, m, a, b}
  int* l_idx = reinterpret_cast<int*>(list);
  float* l_m = list + budget;
  float* l_a = l_m + budget;
  float* l_b = l_a + budget;
  __shared__ float scratch[kWarps];
  __shared__ int counts[2][kVec][kWarps];

  const long long l = blockIdx.x;
  const long long row =
      (links_per_group > 0 ? (l / links_per_group) * group_stride : 0) +
      l * flow_stride;
  const float* w = weights + row;
  const float* bl = backlog + row;
  const float* r = rho + row;
  const float* m = mask + l * static_cast<long long>(F);
  float* o = out + l * static_cast<long long>(F);
  const float c = cap[l];
  const bool down = kind[l] == 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;  // lanes before this one

  // ---- pass 1: read the mask row once, list its masked flows ----------
  // n (the flows listed so far) is the same in every thread.
  // Where the output row sits on the same 16-byte grid as the mask row
  // (always, for the allocator's tensors), pass 1 also writes the row's
  // zeros, so the stores overlap the loads and the solve.
  const int head = head_len(m, F);
  const bool zero_now = head_len(o, F) == head;
  int n;
  {
    // every warp reads the (at most 3) head floats; warp 0 lists them
    const float mf = lane < head ? m[lane] : 0.f;
    if (zero_now && warp == 0 && lane < head) o[lane] = 0.f;
    const unsigned bal = __ballot_sync(kFull, mf != 0.f);
    if (warp == 0 && mf != 0.f) {
      const int pos = __popc(bal & below);
      if (pos < budget) {
        l_idx[pos] = lane;
        l_m[pos] = mf;
      }
    }
    n = __popc(bal);
  }
  int buf = 0;
  for (int c0 = head; c0 < F; c0 += kChunk) {
    float v[kVec][4];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int f = c0 + j * kSub + 4 * tid;
      if (f + 3 < F) {
        const float4 t = *reinterpret_cast<const float4*>(m + f);
        v[j][0] = t.x; v[j][1] = t.y; v[j][2] = t.z; v[j][3] = t.w;
        if (zero_now)
          *reinterpret_cast<float4*>(o + f) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = f + e < F ? m[f + e] : 0.f;
          if (zero_now && f + e < F) o[f + e] = 0.f;
        }
      }
    }
    // sub-chunk j, warp w holds flows c0 + j*kSub + 128*w + [0, 128), lane
    // by lane, so flow order is (j, warp, lane, element)
    int before[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      int cnt = 0, lt = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned bal = __ballot_sync(kFull, v[j][e] != 0.f);
        cnt += __popc(bal);
        lt += __popc(bal & below);
      }
      before[j] = lt;
      if (lane == 0) counts[buf][j][warp] = cnt;
    }
    __syncthreads();
    // counts[buf] is rewritten two steps on, after the next barrier, which
    // every reader of this step passes only once it is done here
    int total = 0, start[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        if (ww == warp) start[j] = n + total;
        total += counts[buf][j][ww];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      int pos = start[j] + before[j];
      const int f = c0 + j * kSub + 4 * tid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v[j][e] != 0.f) {
          if (pos < budget) {
            l_idx[pos] = f + e;
            l_m[pos] = v[j][e];
          }
          ++pos;
        }
      }
    }
    n += total;
    buf ^= 1;
  }
  __syncthreads();  // the list is complete

  if (n > budget) {
    // ---- too many flows for the list: walk the row in device memory ---
    const GlobalRow row{w, bl, r, m, down};
    const Fill fl = solve(row, F, BlockReduce{tid, scratch}, down, c, dt);
    float a, b, mf;
    for (int f = tid; f < F; f += kThreads) {
      row.get(f, a, b, mf);
      o[f] = fl.rate(a, b, mf);
    }
    return;
  }

  // ---- gather: each listed flow's state, read once ---------------------
  for (int i = tid; i < n; i += kThreads) {
    const int f = l_idx[i];
    if (down) {
      l_a[i] = bl[f];
      l_b[i] = fmaxf(r[f], kEps);
    } else {
      l_a[i] = fmaxf(w[f], 0.f);
    }
  }
  __syncthreads();

  // ---- solve on the list -----------------------------------------------
  Fill fl;
  if (n <= kWarpList) {
    // warp 0 alone, the list in its registers; the others wait
    __shared__ Fill shared_fill;
    if (warp == 0) {
      RegRow row;
#pragma unroll
      for (int k = 0; k < kRegEntries; ++k) {
        const int i = lane + 32 * k;
        const bool in = i < n;     // a missing entry has m = 0: adds 0
        row.a[k] = in ? l_a[i] : 0.f;
        row.b[k] = in ? l_b[i] : 1.f;
        row.m[k] = in ? l_m[i] : 0.f;
      }
      const Fill f = solve(row, kRegEntries, WarpReduce{}, down, c, dt);
      if (lane == 0) shared_fill = f;
    }
    __syncthreads();
    fl = shared_fill;
  } else {
    fl = solve(ListRow{l_a, l_b, l_m}, n, BlockReduce{tid, scratch}, down, c,
               dt);
  }

  // ---- emit: the whole row once, zeros off the mask --------------------
  if (!zero_now) {
    zero_row(o, F);
    __syncthreads();  // the zeros land before the listed rates
  }
  for (int i = tid; i < n; i += kThreads)
    o[l_idx[i]] = fl.rate(l_a[i], l_b[i], l_m[i]);
}

}  // namespace

// Launches one block per link row (L rows: B*L for a fleet bucket, within
// the grid's x limit of 2^31 - 1) on `stream` with a list of at most
// `budget` flows in dynamic shared memory, and returns cudaGetLastError()
// (0 on success). Pointers are device pointers; the caller allocates `out`.
extern "C" int waterfill_launch(const float* weights, const float* backlog,
                                const float* rho, long long flow_stride,
                                int links_per_group, long long group_stride,
                                const float* mask, const float* cap,
                                const int* kind, float* out, int L, int F,
                                float dt, int budget, void* stream) {
  const size_t smem = static_cast<size_t>(budget) * kListEntryBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  waterfill_kernel<<<L, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      weights, backlog, rho, flow_stride, links_per_group, group_stride, mask,
      cap, kind, out, F, dt, budget);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int waterfill_list_entry_bytes() { return kListEntryBytes; }

extern "C" const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
