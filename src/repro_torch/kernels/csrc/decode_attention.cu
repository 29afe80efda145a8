// Decode attention for Hopper (sm_90a): one query row per (b, h) against a
// KV cache masked at kv_len[b], f32 online softmax, scale 1/sqrt(D).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _dec_kernel).
// Shapes: q (B, H, D); k, v (B, Hkv, L, D) given by strides (the model hands
// in its (B, L, Hkv, D) cache as a permuted view, nothing is copied);
// kv_len (B,) int32; out (B, H, D) contiguous, in q's dtype.  Query head h
// reads KV head h / G with G = H / Hkv; G = 1 is the TPU kernel's function.
// Scores, softmax and the P.V sum are f32; the output is cast at the end.
//
// What bounds it on this card: bytes.  Each valid cache row is read once
// (K and V: 2*D*2 bytes a row in bf16) and does 4*G*D flops, far below the
// ~295 flops a byte the card needs before its tensor cores would be the
// limit.  At the engine's shape (B=16, Hkv=8, D=128) B*Hkv = 128 blocks would
// leave SMs idle and each block would walk the whole cache alone.
//
// Design.  The TPU kernel walks KV blocks in order on one core, carrying
// (m, l, acc) in VMEM.  Here the grid is (splits, Hkv, B): each block takes a
// chunk of cache rows of one KV head (32 to 256 rows, chosen by the wrapper
// so that the grid gives each SM up to about 16 blocks) and serves all G query
// heads of that head, so K and V are read once per group, not G times.  A
// warp per row computes the G scores (lanes across D, shuffle reduction);
// the block then turns its scores into p = exp(s - m) with its own m and l,
// and each thread sums p*V for one output dimension.  The partial (m, l, acc)
// go to f32 scratch, and a second kernel combines the splits:
//   out = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-30).
// Rows at or past kv_len are never read, so a kv_len that is not a multiple
// of the chunk (such as L - 7) only shortens the last split.  Simple and
// right first: no TMA, no wgmma, no cp.async pipelining.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int NT = 128;    // threads per block
constexpr int MAX_G = 8;   // query heads per KV head
constexpr int MAX_DW = 8;  // D <= 32 * MAX_DW = 256

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
dec_partial(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ kv_len,
            float* __restrict__ m_part, float* __restrict__ l_part,
            float* __restrict__ acc_part, int H, int G, int L, int D,
            int chunk, int n_split, long long qsb, long long qsh,
            long long ksb, long long ksh, long long ksl, long long vsb,
            long long vsh, long long vsl, float scale) {
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* qs = smem;          // [G][D]
  float* sc = smem + G * D;  // [G][chunk]: scores, then p

  const int len = min(kv_len[b], L);
  const int start = split * chunk;
  const int n = min(start + chunk, len) - start;
  // scratch row of (b, h = hk*G + g, split) is part + g*n_split
  const long long part = ((long long)b * H + (long long)hk * G) * n_split + split;

  if (n <= 0) {  // this split lies wholly past kv_len
    for (int g = 0; g < G; ++g) {
      const long long r = part + (long long)g * n_split;
      if (tid == 0) { m_part[r] = -CUDART_INF_F; l_part[r] = 0.f; }
      for (int d = tid; d < D; d += NT) acc_part[r * D + d] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i - g * D;
    qs[i] = to_f(q[b * qsb + (long long)(hk * G + g) * qsh + d]);
  }
  __syncthreads();

  // scores: one warp per cache row, lanes across D
  const T* kb = k + b * ksb + hk * ksh;
  for (int j = warp; j < n; j += NT / 32) {
    const T* kr = kb + (long long)(start + j) * ksl;
    float kv[MAX_DW];
#pragma unroll
    for (int i = 0; i < MAX_DW; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_f(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DW; ++i) {
        const int d = lane + 32 * i;
        if (d < D) s += qs[g * D + d] * kv[i];
      }
      s = warp_sum(s);
      if (lane == 0) sc[g * chunk + j] = s * scale;
    }
  }
  __syncthreads();

  // this split's softmax statistics, one warp per query head
  for (int g = warp; g < G; g += NT / 32) {
    float* row = sc + g * chunk;
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_part[part + (long long)g * n_split] = m;
      l_part[part + (long long)g * n_split] = l;
    }
  }
  __syncthreads();

  // acc[g][d] = sum_j p[g][j] * v[j][d], one thread per output dimension
  const T* vb = v + b * vsb + hk * vsh;
  for (int d = tid; d < D; d += NT) {
    float a[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) a[g] = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float vv = to_f(vb[(long long)(start + j) * vsl + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) a[g] += sc[g * chunk + j] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc_part[(part + (long long)g * n_split) * D + d] = a[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
dec_combine(const float* __restrict__ m_part, const float* __restrict__ l_part,
            const float* __restrict__ acc_part, T* __restrict__ out,
            int n_split, int D) {
  extern __shared__ float w[];  // [n_split] weights exp(m_s - M)
  __shared__ float s_den;
  const long long bh = blockIdx.x;
  const float* mp = m_part + bh * n_split;
  const float* lp = l_part + bh * n_split;
  if (threadIdx.x == 0) {
    float M = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, mp[s]);
    float den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      w[s] = mp[s] > -CUDART_INF_F ? expf(mp[s] - M) : 0.f;
      den += w[s] * lp[s];
    }
    s_den = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const float* ap = acc_part + bh * n_split * D;
  for (int d = threadIdx.x; d < D; d += NT) {
    float o = 0.f;
    for (int s = 0; s < n_split; ++s) o += w[s] * ap[(long long)s * D + d];
    out[bh * D + d] = from_f<T>(o / s_den);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int H, int G, int L, int D, int chunk, int n_split, long long qsb,
           long long qsh, long long ksb, long long ksh, long long ksl,
           long long vsb, long long vsh, long long vsl, float scale,
           cudaStream_t s) {
  const dim3 grid(n_split, H / G, B);
  const size_t smem = (size_t)G * (D + chunk) * sizeof(float);
  dec_partial<T><<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, m_part, l_part, acc_part, H, G, L, D,
      chunk, n_split, qsb, qsh, ksb, ksh, ksl, vsb, vsh, vsl, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dec_combine<T><<<B * H, NT, (size_t)n_split * sizeof(float), s>>>(
      m_part, l_part, acc_part, static_cast<T*>(out), n_split, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_max_group() { return MAX_G; }
extern "C" int decode_attention_max_dim() { return 32 * MAX_DW; }

// dtype: 0 = float32, 1 = bfloat16
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const int* kv_len,
    void* out, float* m_part, float* l_part, float* acc_part, int B, int H,
    int G, int L, int D, int chunk, int n_split, long long qsb, long long qsh,
    long long ksb, long long ksh, long long ksl, long long vsb, long long vsh,
    long long vsl, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kv_len, out, m_part, l_part, acc_part, B, H,
                         G, L, D, chunk, n_split, qsb, qsh, ksb, ksh, ksl, vsb,
                         vsh, vsl, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kv_len, out, m_part, l_part,
                                 acc_part, B, H, G, L, D, chunk, n_split, qsb,
                                 qsh, ksb, ksh, ksl, vsb, vsh, vsl, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
