// Mamba-1 selective scan for Hopper (sm_90a):
//   h_t = dA_t * h_{t-1} + dBx_t,   y_t[i] = sum_n h_t[i, n] * C_t[n].
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (body _ssm_kernel).  Shapes: dA, dBx (B, S, I, N) and C (B, S, N),
// contiguous f32 (the Mamba mixer builds dA and dBx in f32); h0 (B, I, N);
// y (B, S, I); h_last (B, I, N).  The state is f32.
//
// What bounds it on this card: bytes.  Every step reads dA and dBx once
// (2 * B * S * I * N elements) and does 4 flops an element, so it moves
// ~2 bytes per flop at f32; the recurrence itself is trivial.
//
// Design.  The TPU kernel chunks time only to fit VMEM, with the state in
// VMEM scratch across a sequential chunk axis.  Here one warp holds the state
// of 32 / N channels in registers, one lane per (channel, state), and walks
// all of S: at each step its 32 lanes read one contiguous row of dA and of
// dBx at (b, t, i .. i + 32/N, :) (128 bytes in f32), multiply-add, and
// reduce y over the N lanes of a channel with shuffles; lane n = 0 writes y.
// At falcon-mamba's I = 8192, N = 16 that is B * 4096 warps, enough to fill
// the card.  The latency of the loads is hidden by reading U = 8 steps ahead
// into registers before the recurrence consumes them.  N must divide 32.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int U = 8;     // steps loaded ahead

__global__ void __launch_bounds__(NT)
ssm_fwd(const float* __restrict__ dA, const float* __restrict__ dBx,
        const float* __restrict__ C, const float* __restrict__ h0,
        float* __restrict__ y, float* __restrict__ h_last, int B, int S,
        int I, int N) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int cpw = 32 / N;                  // channels per warp
  const long long n_warps = (long long)B * I / cpw;
  if (warp >= n_warps) return;             // whole warps only: shuffles stay full
  const int b = (int)(warp * cpw / I);
  const int i = (int)(warp * cpw - (long long)b * I) + lane / N;
  const int n = lane % N;

  const long long IN = (long long)I * N;
  // this lane's element of (b, t, i, n) is base + t * IN
  const long long base = (long long)b * S * IN + (long long)i * N + n;
  const long long cbase = (long long)b * S * N + n;
  const long long ybase = (long long)b * S * I + i;

  float h = h0[(long long)b * IN + (long long)i * N + n];
  for (int t0 = 0; t0 < S; t0 += U) {
    float a[U], bx[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        a[u] = dA[base + t * IN];
        bx[u] = dBx[base + t * IN];
        c[u] = C[cbase + (long long)t * N];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t >= S) break;  // uniform across the warp
      h = a[u] * h + bx[u];
      float yv = h * c[u];
      for (int off = N / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (n == 0) y[ybase + (long long)t * I] = yv;
    }
  }
  h_last[(long long)b * IN + (long long)i * N + n] = h;
}

}  // namespace

// N must divide 32 and 32 / N divide I.
extern "C" int ssm_scan_launch(const float* dA, const float* dBx,
                               const float* C, const float* h0, float* y,
                               float* h_last, int B, int S, int I, int N,
                               void* stream) {
  if (N < 1 || 32 % N != 0 || I % (32 / N) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_warps = (long long)B * I / (32 / N);
  const long long blocks = (n_warps + NT / 32 - 1) / (NT / 32);
  ssm_fwd<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      dA, dBx, C, h0, y, h_last, B, S, I, N);
  return static_cast<int>(cudaGetLastError());
}
