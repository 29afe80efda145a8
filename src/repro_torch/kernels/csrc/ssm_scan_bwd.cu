// Mamba-1 selective scan backward for Hopper (sm_90a): the gradient of
//   h_t = dA_t * h_{t-1} + dBx_t,   y_t[i] = sum_n h_t[i, n] * C_t[n]
// (ssm_scan.cu) from dy (B, S, I) and dh_last (B, I, N):
//   dh_t = dA_{t+1} * dh_{t+1} + dy_t[i] * C_t[n]   (dh_S starts at dh_last)
//   d(dA)_t = dh_t * h_{t-1},   d(dBx)_t = dh_t,
//   dC_t[n] = sum_i dy_t[i] * h_t[i, n],   dh0 = dA_1 * dh_1.
//
// The TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan has no backward;
// the reference trains through the jnp scan of src/repro/models/mamba.py,
// differentiated by XLA.  This kernel computes that gradient.  Shapes and
// types as the forward's: contiguous f32.
//
// What bounds it on this card: bytes.  dA, dBx in, d(dA), d(dBx) out: four
// (B, S, I, N) f32 tensors at 2 flops an element; this kernel reads dA and
// dBx twice (once for the checkpoints, once for the segments), so it moves
// six.
//
// Design.  The lane layout is the forward's: one warp holds 32 / N channels,
// one lane per (channel, state).  The states h_{t-1} the backward needs are
// recomputed, not stored (a stored chunk is 268 MB at falcon-mamba's
// (B = 2, 256, 8192, 16)):
//  1. ssm_bwd_ckpt runs the recurrence forward and keeps the state at the
//     start of every segment of SEG = 16 steps (S / 16 states, 17 MB there).
//  2. ssm_bwd walks the segments from the last: it recomputes the segment's
//     16 states into registers from its checkpoint, then runs the recurrence
//     of dh backward through them.  dC_t[n] is summed over the warp's
//     channels with shuffles and over the block's 8 warps in shared memory,
//     and each block writes its partial (B, S, blocks, N).
//  3. ssm_bwd_dc sums the partials over the blocks in a fixed order.
// No atomics: the result is the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads a block: 8 warps
constexpr int NW = NT / 32;
constexpr int SEG = 16;   // steps a segment

struct Lane {
  bool active;
  int b, i, n;
  long long base, cbase, ybase, hbase;  // (b, 0, i, n), (b, 0, n), (b, 0, i), (b, i, n)
};

// the forward's layout, with the warps of a block on one batch row: block
// (x, b) holds channel groups x * 8 .. x * 8 + 7 of row b
__device__ __forceinline__ Lane lane_of(int S, int I, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpw = 32 / N;
  const int grp = blockIdx.x * NW + warp;
  Lane L;
  L.active = grp < I / cpw;
  L.b = blockIdx.y;
  L.i = L.active ? grp * cpw + lane / N : 0;
  L.n = lane % N;
  const long long IN = (long long)I * N;
  L.base = (long long)L.b * S * IN + (long long)L.i * N + L.n;
  L.cbase = (long long)L.b * S * N + L.n;
  L.ybase = (long long)L.b * S * I + L.i;
  L.hbase = (long long)L.b * IN + (long long)L.i * N + L.n;
  return L;
}

__global__ void __launch_bounds__(NT)
ssm_bwd_ckpt(const float* __restrict__ dA, const float* __restrict__ dBx,
             const float* __restrict__ h0, float* __restrict__ hck, int S,
             int I, int N) {
  const Lane L = lane_of(S, I, N);
  if (!L.active) return;
  const long long IN = (long long)I * N;
  const int nseg = (S + SEG - 1) / SEG;
  float h = h0[L.hbase];
  for (int s = 0; s < nseg; ++s) {
    hck[((long long)L.b * nseg + s) * IN + (long long)L.i * N + L.n] = h;
    const int t0 = s * SEG;
    float a[SEG], bx[SEG];
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const int t = t0 + u;
      a[u] = t < S ? dA[L.base + t * IN] : 1.f;
      bx[u] = t < S ? dBx[L.base + t * IN] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SEG; ++u) h = a[u] * h + bx[u];
  }
}

__global__ void __launch_bounds__(NT)
ssm_bwd(const float* __restrict__ dA, const float* __restrict__ dBx,
        const float* __restrict__ C, const float* __restrict__ hck,
        const float* __restrict__ dy, const float* __restrict__ dh_last,
        float* __restrict__ d_dA, float* __restrict__ d_dBx,
        float* __restrict__ dc_part, float* __restrict__ dh0, int S, int I,
        int N) {
  __shared__ float red[SEG][NW][32];
  const Lane L = lane_of(S, I, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long IN = (long long)I * N;
  const int nseg = (S + SEG - 1) / SEG;
  const int nblk = gridDim.x;
  float g = L.active && dh_last != nullptr ? dh_last[L.hbase] : 0.f;
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * SEG;
    const float hstart =
        L.active ? hck[((long long)L.b * nseg + s) * IN + (long long)L.i * N + L.n] : 0.f;
    float a[SEG], c[SEG], dyv[SEG], hs[SEG];
    float h = hstart;
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const int t = t0 + u;
      const bool ok = L.active && t < S;
      a[u] = ok ? dA[L.base + t * IN] : 0.f;
      const float bx = ok ? dBx[L.base + t * IN] : 0.f;
      c[u] = ok ? C[L.cbase + (long long)t * N] : 0.f;
      dyv[u] = ok && dy != nullptr ? dy[L.ybase + (long long)t * I] : 0.f;
      h = a[u] * h + bx;
      hs[u] = h;
    }
#pragma unroll
    for (int u = SEG - 1; u >= 0; --u) {
      const int t = t0 + u;
      if (t >= S) continue;  // uniform across the block
      const float dh = g + dyv[u] * c[u];
      if (L.active) {
        d_dBx[L.base + t * IN] = dh;
        d_dA[L.base + t * IN] = dh * (u > 0 ? hs[u - 1] : hstart);
      }
      float x = dyv[u] * hs[u];  // zero on inactive lanes
      for (int off = N; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane < N) red[u][warp][lane] = x;
      g = a[u] * dh;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < SEG * N; e += NT) {
      const int u = e / N, n = e - u * N, t = t0 + u;
      if (t >= S) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += red[u][w][n];
      dc_part[(((long long)L.b * S + t) * nblk + blockIdx.x) * N + n] = sum;
    }
    __syncthreads();
  }
  if (L.active) dh0[L.hbase] = g;
}

__global__ void ssm_bwd_dc(const float* __restrict__ dc_part,
                           float* __restrict__ dC, long long n_out, int nblk,
                           int N) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out) return;
  const long long bt = e / N;
  const int n = (int)(e - bt * N);
  const float* p = dc_part + bt * nblk * N + n;
  float sum = 0.f;
  for (int k = 0; k < nblk; ++k) sum += p[(long long)k * N];
  dC[e] = sum;
}

}  // namespace

// blocks a batch row takes: 8 warps of 32 / N channels each
extern "C" int ssm_scan_bwd_blocks(int I, int N) {
  const int groups = I / (32 / N);
  return (groups + NW - 1) / NW;
}

// N must divide 32 and 32 / N divide I.  dy and dh_last may be null (zero
// gradient).  Scratch: hck (B, ceil(S / 16), I, N) and dc_part (B, S,
// ssm_scan_bwd_blocks(I, N), N), f32.  Outputs: d_dA, d_dBx (B, S, I, N),
// dC (B, S, N), dh0 (B, I, N).
extern "C" int ssm_scan_bwd_launch(const float* dA, const float* dBx,
                                   const float* C, const float* h0,
                                   const float* dy, const float* dh_last,
                                   float* d_dA, float* d_dBx, float* dC,
                                   float* dh0, float* hck, float* dc_part,
                                   int B, int S, int I, int N, void* stream) {
  if (N < 1 || 32 % N != 0 || I % (32 / N) != 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = ssm_scan_bwd_blocks(I, N);
  const dim3 grid(nblk, B);
  ssm_bwd_ckpt<<<grid, NT, 0, st>>>(dA, dBx, h0, hck, S, I, N);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssm_bwd<<<grid, NT, 0, st>>>(dA, dBx, C, hck, dy, dh_last, d_dA, d_dBx,
                               dc_part, dh0, S, I, N);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const long long n_out = (long long)B * S * N;
  ssm_bwd_dc<<<(unsigned)((n_out + 255) / 256), 256, 0, st>>>(dc_part, dC, n_out,
                                                              nblk, N);
  return static_cast<int>(cudaGetLastError());
}
