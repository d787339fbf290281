// Flash attention forward (online softmax, GQA, optional causal mask) for
// Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:78
// (flash_attention_pallas, body _flash_kernel at :31), the Pallas TPU kernel
// behind repro.kernels.flash_attention.ops.flash_attention. Reached here from
// repro_torch.models.lm._attn_block (every prefill application of an
// attention block) through repro_torch.kernels.flash_attention.ops.
//
// Semantics, as in the Pallas kernel and ref.py::attention_plain:
//   s_ij = (q_i . k_j) * 1/sqrt(hd), masked to -1e30 where j > i (causal);
//   running row max m (from -1e30, so exp(m_prev - m_new) stays finite),
//   running sum l and accumulator acc in float32; out = acc / max(l, 1e-30)
//   in q's dtype. Query head h reads KV head h / (H / K): KV is never
//   repeated.
//
// Layout: q [B,S,H,hd], k/v [B,T,K,hd], o [B,S,H,hd], read and written in
// place (the model's layout; no transposes around the call). One thread
// block per (b*h, tile of 64 query rows); a loop over 64-row K/V tiles
// staged in shared memory as float32. Four threads share a query row: each
// scores 16 of the tile's keys, the row max and sum are combined with two
// shuffles, and each thread accumulates hd/4 of the output dims. Causal
// tiles wholly above the diagonal are skipped; rows >= S and keys >= T are
// masked in the block, so S and T need not be multiples of 64.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores):
// at the serving shape (B 4, H = K = 32, S = T = 512, hd 64, bf16) the
// function moves q, k, v and o once, 33.5 MB -> 0.010 ms, and does 4.3
// GFLOP causal -> 0.004 ms, so bytes bind. This first kernel runs its
// products on the CUDA cores in float32 (67 TFLOP/s), which caps it near
// 0.06 ms even with perfect reuse; K/V tiles are re-read from L2 by every
// query tile of a head. Next design step: wgmma on bf16 tiles brought in
// by TMA, one producer warp and two consumer warpgroups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per K/V tile
constexpr int kThreads = 4 * kBQ;       // four threads per query row
constexpr int kKeysPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BQ][HD+1], K [BK][HD+1], V [BK][HD], P [BQ][BK+1], all float32;
  // the +1 pads keep the column reads of Q, K and P free of bank conflicts
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int T_len, int H,
    int K, float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int kDimsPerThread = HD / 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * HD;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;   // the 4 threads of row r: one warp
  const int i_glob = q0 + r;

  const long long q_stride = static_cast<long long>(H) * HD;   // per s
  const long long kv_stride = static_cast<long long>(K) * HD;  // per t
  const T* qb = q + (static_cast<long long>(b) * S * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * T_len * K + kvh) * HD;
  const T* vb = v + (static_cast<long long>(b) * T_len * K + kvh) * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    Qs[i * LD + d] = q0 + i < S ? to_float(qb[(q0 + i) * q_stride + d]) : 0.f;
  }

  float acc[kDimsPerThread];
#pragma unroll
  for (int t = 0; t < kDimsPerThread; ++t) acc[t] = 0.f;
  float m = kNegInf, l = 0.f;

  int n_tiles = (T_len + kBK - 1) / kBK;
  if (causal) {
    // the Pallas kernel's skip: tile kt runs iff kt*BK <= q0 + BQ - 1
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q is loaded; the previous tile's readers are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool ok = k0 + j < T_len;
      Ks[j * LD + d] = ok ? to_float(kb[(k0 + j) * kv_stride + d]) : 0.f;
      Vs[j * HD + d] = ok ? to_float(vb[(k0 + j) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) s[t] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int t = 0; t < kKeysPerThread; ++t)
        s[t] += qd * Ks[(c + 4 * t) * LD + d];
    }

    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const int j = k0 + c + 4 * t;
      const bool ok = j < T_len && (!causal || j <= i_glob);
      s[t] = ok ? s[t] * scale : kNegInf;
      mx = fmaxf(mx, s[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      // a masked key adds exactly 0, as exp(-1e30 - m_new) does in the
      // Pallas kernel once the row has seen a key
      const int j = k0 + c + 4 * t;
      const bool ok = j < T_len && (!causal || j <= i_glob);
      const float p = ok ? expf(s[t] - m_new) : 0.f;
      Ps[r * (kBK + 1) + c + 4 * t] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int t = 0; t < kDimsPerThread; ++t) acc[t] *= corr;
    __syncwarp();  // row r's probabilities come from its own warp

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float p = Ps[r * (kBK + 1) + j];
#pragma unroll
      for (int t = 0; t < kDimsPerThread; ++t)
        acc[t] += p * Vs[j * HD + c + 4 * t];
    }
  }

  if (i_glob < S) {
    T* orow = o + (static_cast<long long>(b) * S + i_glob) * q_stride +
              static_cast<long long>(h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int t = 0; t < kDimsPerThread; ++t)
      store(orow + c + 4 * t, acc[t] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int K, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, K,
      1.0f / sqrtf(static_cast<float>(HD)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int S, int T_len, int H, int K, int causal,
             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, T_len, H, K, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, H, K, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, K, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, K, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous tensors in the
// layouts above; `bf16` selects bfloat16 inputs and output, else float32.
// The caller allocates `o` and checks shapes (hd in {16, 32, 64, 128}).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int T_len, int H, int K, int hd,
                                      int bf16, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, T_len, H, K, causal,
                                   s);
  return dispatch<float>(hd, q, k, v, o, B, S, T_len, H, K, causal, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
