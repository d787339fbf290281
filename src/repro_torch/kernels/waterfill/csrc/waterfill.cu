// Batched per-link allocator solve (paper Alg. 1, eqs. 3/4) for Hopper.
//
// Replaces: repro/kernels/waterfill/kernel.py::waterfill_pallas (body
// _waterfill_block), the Pallas TPU kernel behind allocate(solver="pallas").
// Reached here from repro_torch.core.allocator.allocate(solver="waterfill").
//
// Per link l (one thread block each, 256 threads walking the flow axis):
//   kind 0 (uplink, eq. 3):   x_f = C * w_f / sum(w), equal split when
//                             sum(w) <= 1e-9;
//   kind 1 (downlink, eq. 4): theta by N_BISECT = 48 bisection rounds on
//                             sum_f max(theta*rho_f - L_f, 0) * m_f / dt = C,
//                             from hi0 = max(L/rho) + C*dt/sum(rho) + 1, then
//                             x_f = max(theta*rho_f - L_f, 0) * m_f / dt,
//                             renormalised to C.
// Same constants, branches and float32 arithmetic as the Pallas kernel and
// as repro_torch/kernels/waterfill/ref.py::waterfill_plain. w, backlog and
// rho are read with a row stride: 0 for one [F] row shared by every link
// (the allocator's layout), F for dense [L, F] inputs. Uplink rows skip the
// bisection, whose result they never read.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the function must read the [L, F] mask and write the [L, F]
// output once, 8*L*F bytes: 19 us at L = 640, F = 12,417 and 24 us at
// L = 10^4, F = 10^3. Its arithmetic is ~5 flops per masked (link, flow)
// pair per bisection round; the routing mask is sparse (a flow crosses 2-4
// links), so the bytes bind. This first kernel instead re-reads each link's
// mask row and the flow rows from L2 on every one of the ~50 passes.
//
// Next design step: keep a link's (L/rho, rho, m) row on chip across the
// ~50 passes. At F = 12,417 a row is about 150 KB in float32, inside the
// 227 KB of shared memory one block can have; compacting the row to its
// masked flows shrinks it to a few hundred bytes on the main path.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBisect = 48;
constexpr float kEps = 1e-9f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
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

__global__ void __launch_bounds__(kThreads) waterfill_kernel(
    const float* __restrict__ weights, const float* __restrict__ backlog,
    const float* __restrict__ rho, long long flow_stride,
    const float* __restrict__ mask, const float* __restrict__ cap,
    const int* __restrict__ kind, float* __restrict__ out, int F, float dt) {
  __shared__ float scratch[kWarps];
  const long long l = blockIdx.x;
  const float* w = weights + l * flow_stride;
  const float* bl = backlog + l * flow_stride;
  const float* r = rho + l * flow_stride;
  const float* m = mask + l * static_cast<long long>(F);
  float* o = out + l * static_cast<long long>(F);
  const float c = cap[l];
  const bool down = kind[l] == 1;

  // ---- pass 1: per-link reductions ----------------------------------
  float s_w = 0.f, s_m = 0.f, s_rho = 0.f, mx = 0.f;
  for (int f = threadIdx.x; f < F; f += kThreads) {
    const float mf = m[f];
    const float rf = fmaxf(r[f], kEps);
    s_w += fmaxf(w[f], 0.f) * mf;
    s_m += mf;
    s_rho += rf * mf;
    if (mf > 0.f) mx = fmaxf(mx, bl[f] / rf);  // activation points
  }
  s_w = block_sum(s_w, scratch);
  s_m = block_sum(s_m, scratch);

  if (!down) {
    // ---- eq. (3): zero demand falls back to equal split -------------
    const bool fb = s_w <= kEps;
    const float den = fb ? fmaxf(s_m, 1.f) : s_w;
    for (int f = threadIdx.x; f < F; f += kThreads) {
      const float mf = m[f];
      const float wm = fb ? mf : fmaxf(w[f], 0.f) * mf;
      o[f] = c * wm / den;
    }
    return;
  }

  s_rho = block_sum(s_rho, scratch);
  mx = block_max(mx, scratch);

  // ---- eq. (4): drain-time equalization via bisection ----------------
  float lo = 0.f;
  float hi = mx + c * dt / fmaxf(s_rho, kEps) + 1.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.f;
    for (int f = threadIdx.x; f < F; f += kThreads)
      s += fmaxf(mid * fmaxf(r[f], kEps) - bl[f], 0.f) * m[f];
    const float alloc = block_sum(s, scratch) / dt;
    if (alloc > c) hi = mid; else lo = mid;
  }
  const float theta = 0.5f * (lo + hi);

  // downlink mass at theta: renormalise the bisection's residual to C
  float s = 0.f;
  for (int f = threadIdx.x; f < F; f += kThreads)
    s += fmaxf(theta * fmaxf(r[f], kEps) - bl[f], 0.f) * m[f];
  const float s_dn = block_sum(s, scratch) / dt;
  const float scale = s_dn > kEps ? c / s_dn : 1.f;

  for (int f = threadIdx.x; f < F; f += kThreads)
    o[f] = fmaxf(theta * fmaxf(r[f], kEps) - bl[f], 0.f) * m[f] / dt * scale;
}

}  // namespace

// Launches one block per link on `stream` and returns cudaGetLastError()
// (0 on success). Pointers are device pointers; the caller allocates `out`.
extern "C" int waterfill_launch(const float* weights, const float* backlog,
                                const float* rho, long long flow_stride,
                                const float* mask, const float* cap,
                                const int* kind, float* out, int L, int F,
                                float dt, void* stream) {
  waterfill_kernel<<<L, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      weights, backlog, rho, flow_stride, mask, cap, kind, out, F, dt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
