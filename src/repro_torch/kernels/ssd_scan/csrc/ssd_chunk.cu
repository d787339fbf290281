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
// One thread block (256 threads) per (bh, chunk). x [Q][P], B [Q][N+1]
// (padded: the score loop reads 32 rows of one column), C [Q][N], cum, dt
// and the state weights live in dynamic shared memory -- 178 KB at Q 128,
// P 64, N 128 and 117 KB at N 64, above the 48 KB static limit, so the
// launcher raises the block's limit with cudaFuncSetAttribute. The [Q, Q]
// score matrix is built 32 rows at a time ([32][Q] in shared memory), and
// only the column blocks at or left of the diagonal are computed. cum is a
// warp-wide inclusive scan (4 elements a lane, then shuffles).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 outside the tensor
// cores): at the serving shape (BH 256, 4 chunks of 128, P 64, N 64) the
// function moves ~86 MB (x and y 33.5 MB each, states 16.8 MB) -> 0.026 ms
// and does ~3.3 GFLOP on the causal triangle -> 0.049 ms, so operations
// bind. This first kernel runs the three products on the CUDA cores from
// shared memory with 4x4 / 4x2 / 8x4 register tiles. Next design step: the
// [Q,Q] and [P,N] products on the tensor cores (TF32 or split bf16), which
// is where this function's operations belong.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRB = 32;         // score rows per pass: 8 warps x 4 rows
constexpr unsigned kFull = 0xffffffffu;

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P + static_cast<size_t>(Q) * (N + 1) +
         static_cast<size_t>(Q) * N + static_cast<size_t>(kRB) * Q + 3 * Q;
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, float* __restrict__ y,
    float* __restrict__ st, float* __restrict__ cum_out, int nc, int Q,
    int P, int N, int H) {
  extern __shared__ float smem[];
  const int LB = N + 1;
  float* xs = smem;             // [Q][P]
  float* Bs = xs + Q * P;       // [Q][N+1]
  float* Cs = Bs + Q * LB;      // [Q][N]
  float* Ms = Cs + Q * N;       // [kRB][Q]
  float* cum = Ms + kRB * Q;    // [Q]
  float* dts = cum + Q;         // [Q]
  float* wts = dts + Q;         // [Q]: dt * exp(cum_end - cum)

  const int bh = blockIdx.x, ch = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (static_cast<long long>(bh) * nc + ch) * Q;
  const long long bc0 =
      (static_cast<long long>(bh / H) * nc + ch) * Q * static_cast<long long>(N);
  const float a = A[bh];

  for (int e = tid; e < Q * P; e += kThreads) xs[e] = x[row0 * P + e];
  for (int e = tid; e < Q * N; e += kThreads) {
    Bs[(e / N) * LB + e % N] = Bm[bc0 + e];
    Cs[e] = Cm[bc0 + e];
  }
  for (int i = tid; i < Q; i += kThreads) dts[i] = dt[row0 + i];
  __syncthreads();

  // ---- cum = inclusive scan of dt * A over Q <= 128 (warp 0) -----------
  if (warp == 0) {
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = lane * 4 + u;
      run += i < Q ? dts[i] * a : 0.f;
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
      const int i = lane * 4 + u;
      if (i < Q) cum[i] = base + v[u];
    }
  }
  __syncthreads();
  const float cend = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    wts[i] = dts[i] * expf(cend - cum[i]);
    cum_out[row0 + i] = cum[i];
  }
  __syncthreads();

  // ---- y_intra, 32 rows at a time ---------------------------------------
  const int n_col_blocks = (Q + 31) / 32;
  for (int i0 = 0; i0 < Q; i0 += kRB) {
    const int rb = i0 / kRB;
    const int nb = rb + 1 < n_col_blocks ? rb + 1 : n_col_blocks;
    // scores: thread (warp, lane) owns rows i0 + warp + 8a, cols lane + 32b
    float g[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) g[u][w] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + warp + 8 * u;
        cv[u] = i < Q ? Cs[i * N + n] : 0.f;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = lane + 32 * w;
        bv[w] = (w < nb && j < Q) ? Bs[j * LB + n] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) g[u][w] += cv[u] * bv[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int il = warp + 8 * u, i = i0 + il;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = lane + 32 * w;
        if (w < nb && j < Q)
          Ms[il * Q + j] = (i < Q && j <= i)
                               ? g[u][w] * expf(cum[i] - cum[j]) * dts[j]
                               : 0.f;
      }
    }
    __syncthreads();

    // y rows: thread owns rows i0 + warp + 8a and dims lane, lane + 32
    const int jmax = i0 + kRB < Q ? i0 + kRB : Q;
    float acc[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = 0.f;
    for (int j = 0; j < jmax; ++j) {
      const float x0 = lane < P ? xs[j * P + lane] : 0.f;
      const float x1 = lane + 32 < P ? xs[j * P + lane + 32] : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float mv = Ms[(warp + 8 * u) * Q + j];
        acc[u][0] += mv * x0;
        acc[u][1] += mv * x1;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + warp + 8 * u;
      if (i < Q) {
        float* yrow = y + (row0 + i) * P;
        if (lane < P) yrow[lane] = acc[u][0];
        if (lane + 32 < P) yrow[lane + 32] = acc[u][1];
      }
    }
    __syncthreads();  // Ms is rewritten by the next pass
  }

  // ---- chunk state: thread owns p = warp + 8a (a < 8), n = lane + 32b --
  float s[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) s[u][w] = 0.f;
  for (int q = 0; q < Q; ++q) {
    const float wq = wts[q];
    float bw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = lane + 32 * w;
      bw[w] = n < N ? Bs[q * LB + n] * wq : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = warp + 8 * u;
      const float xv = p < P ? xs[q * P + p] : 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] += xv * bw[w];
    }
  }
  float* sto = st + (static_cast<long long>(bh) * nc + ch) * P *
                        static_cast<long long>(N);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int p = warp + 8 * u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int n = lane + 32 * w;
      if (p < P && n < N) sto[p * N + n] = s[u][w];
    }
  }
}

}  // namespace

// Launches one block per (bh, chunk) on `stream` and returns
// cudaGetLastError() (0 on success); a refused shared-memory request is
// returned the same way. Pointers are device pointers to contiguous float32
// tensors: x [BH,nc,Q,P], dt [BH,nc,Q], B/C [BH/H,nc,Q,N], A [BH],
// y [BH,nc,Q,P], st [BH,nc,P,N], cum [BH,nc,Q]. The caller allocates the
// outputs and checks Q <= 128, P <= 64, N <= 128.
extern "C" int ssd_chunk_launch(const float* x, const float* dt,
                                const float* B, const float* C,
                                const float* A, float* y, float* st,
                                float* cum, int BH, int nc, int Q, int P,
                                int N, int H, void* stream) {
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, nc);
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, B, C, A, y, st, cum, nc, Q, P, N, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
