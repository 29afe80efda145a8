// LAGS scheduler tick for Hopper (sm_90a): PELT + Load Credit EMA over T
// tenants, then the k runnable tenants of lowest key.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lags_select.py::lags_select
// (body _lags_kernel).  It computes, per lane,
//   new_load   = y*load + (1-y)*frac                  y = 0.5^(1/halflife)
//   new_credit = (1-alpha)*credit + alpha*new_load    alpha = 2/(window+1)
//   key        = runnable ? new_credit + (float)lane*1e-12f : INF
// and returns the k lanes of lowest (key, lane), -1 where the key is INF.
//
// What bounds it on this card: not bytes and not operations.  The tick moves
// 21 bytes a tenant (1.4 MB at T=65536, 0.4 us at 3.35 TB/s); the selection
// is k rounds of a dependent block-wide min-reduction, so its time is the
// latency of those rounds (barriers, shuffles) and of the two launches.
//
// Design.  The TPU kernel keeps all T keys in VMEM in one block.  65536 f32
// keys are 256 KB, more than the 227 KB of shared memory a block can have, so
// pass 1 cuts T into slices of SLICE lanes, one CTA each: the CTA updates its
// slice, keeps its keys in shared memory and emits its own k best (key, lane)
// candidates.  Pass 2, one CTA, takes the k best of all candidates.  The
// global k best lie among the slices' k best, and (key, lane) is a total
// order, so the picks equal the one-block kernel's.  Slices run in parallel
// on the SMs, which also hides pass 1's k rounds at large T.
//
// Exactness.  Every product and sum is __fmul_rn/__fadd_rn, in the
// reference's order, and the file is built with -fmad=false, so nothing is
// contracted into an FMA.  The coefficients arrive as the f32 casts of the
// Python doubles, as in the plain PyTorch version beside the wrapper.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLICE = 1024;  // lanes per CTA in pass 1 (4 KB of keys)

__device__ __forceinline__ bool lt(float ka, int la, float kb, int lb) {
  return ka < kb || (ka == kb && la < lb);
}

// Block-wide arg-min of (key, lane); every thread returns the winner.
// s_key/s_lane hold 33 entries: one per warp plus the broadcast slot.
__device__ __forceinline__ void block_argmin(float& key, int& lane,
                                             float* s_key, int* s_lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ok = __shfl_down_sync(0xffffffffu, key, off);
    int ol = __shfl_down_sync(0xffffffffu, lane, off);
    if (lt(ok, ol, key, lane)) { key = ok; lane = ol; }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { s_key[warp] = key; s_lane[warp] = lane; }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int nw = blockDim.x >> 5;
    key = threadIdx.x < nw ? s_key[threadIdx.x] : CUDART_INF_F;
    lane = threadIdx.x < nw ? s_lane[threadIdx.x] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ok = __shfl_down_sync(0xffffffffu, key, off);
      int ol = __shfl_down_sync(0xffffffffu, lane, off);
      if (lt(ok, ol, key, lane)) { key = ok; lane = ol; }
    }
    if (threadIdx.x == 0) { s_key[32] = key; s_lane[32] = lane; }
  }
  __syncthreads();
  key = s_key[32];
  lane = s_lane[32];
  __syncthreads();  // s_key/s_lane are reused by the next round
}

// k rounds of arg-min over n keys in shared memory.  Round r writes the
// winner to out_key/out_lane[r] and removes it; lanes are base + index.
__device__ void k_rounds(float* keys, int n, int base, int k,
                         float* out_key, int* out_lane, const int* lanes) {
  __shared__ float s_key[33];
  __shared__ int s_lane[33];
  for (int r = 0; r < k; ++r) {
    float key = CUDART_INF_F;
    int lane = INT_MAX;
    int slot = -1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int l = lanes ? lanes[i] : base + i;
      if (lt(keys[i], l, key, lane)) { key = keys[i]; lane = l; slot = i; }
    }
    float wkey = key;
    int wlane = lane;
    block_argmin(wkey, wlane, s_key, s_lane);
    if (threadIdx.x == 0) {
      out_key[r] = wkey;
      out_lane[r] = wlane;
    }
    // finite keys have distinct lanes, so exactly one thread holds the
    // winner; it removes it.  An INF winner means nothing is left.
    if (slot >= 0 && wkey < CUDART_INF_F && wkey == key && wlane == lane)
      keys[slot] = CUDART_INF_F;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
lags_tick_slices(const float* __restrict__ load,
                 const float* __restrict__ credit,
                 const float* __restrict__ frac,
                 const uint8_t* __restrict__ runnable,
                 float* __restrict__ new_load, float* __restrict__ new_credit,
                 float* __restrict__ cand_key, int* __restrict__ cand_lane,
                 int T, int k, float y, float one_minus_y, float alpha,
                 float one_minus_alpha) {
  __shared__ float keys[SLICE];
  const int base = blockIdx.x * SLICE;
  for (int i = threadIdx.x; i < SLICE; i += THREADS) {
    const int lane = base + i;
    float key = CUDART_INF_F;
    if (lane < T) {
      const float nl = __fadd_rn(__fmul_rn(y, load[lane]),
                                 __fmul_rn(one_minus_y, frac[lane]));
      const float nc = __fadd_rn(__fmul_rn(one_minus_alpha, credit[lane]),
                                 __fmul_rn(alpha, nl));
      new_load[lane] = nl;
      new_credit[lane] = nc;
      if (runnable[lane]) key = __fadd_rn(nc, __fmul_rn((float)lane, 1e-12f));
    }
    keys[i] = key;
  }
  __syncthreads();
  k_rounds(keys, SLICE, base, k, cand_key + (size_t)blockIdx.x * k,
           cand_lane + (size_t)blockIdx.x * k, nullptr);
}

__global__ void __launch_bounds__(THREADS)
lags_merge(const float* __restrict__ cand_key,
           const int* __restrict__ cand_lane, int n, int k,
           int* __restrict__ picked, float* __restrict__ out_key,
           int* __restrict__ out_lane) {
  extern __shared__ float smem[];
  float* keys = smem;
  int* lanes = reinterpret_cast<int*>(smem + n);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    keys[i] = cand_key[i];
    lanes[i] = cand_lane[i];
  }
  __syncthreads();
  k_rounds(keys, n, 0, k, out_key, out_lane, lanes);
  __syncthreads();
  for (int r = threadIdx.x; r < k; r += THREADS)
    picked[r] = out_key[r] < CUDART_INF_F ? out_lane[r] : -1;
}

}  // namespace

extern "C" int lags_select_scratch(int T, int k) {
  // candidates written by pass 1: one block of k per slice
  return ((T + SLICE - 1) / SLICE) * k;
}

extern "C" int lags_select_launch(const float* load, const float* credit,
                                  const float* frac, const uint8_t* runnable,
                                  float* new_load, float* new_credit,
                                  int* picked, float* cand_key,
                                  int* cand_lane, float* out_key,
                                  int* out_lane, int T, int k, float y,
                                  float one_minus_y, float alpha,
                                  float one_minus_alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (T + SLICE - 1) / SLICE;
  lags_tick_slices<<<nblocks, THREADS, 0, s>>>(
      load, credit, frac, runnable, new_load, new_credit, cand_key, cand_lane,
      T, k, y, one_minus_y, alpha, one_minus_alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = nblocks * k;
  lags_merge<<<1, THREADS, (size_t)n * (sizeof(float) + sizeof(int)), s>>>(
      cand_key, cand_lane, n, k, picked, out_key, out_lane);
  return static_cast<int>(cudaGetLastError());
}
