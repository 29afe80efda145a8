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
//
// Two builds.  ssm_fwd<false> serves prefill and the no-gradient calls.
// ssm_fwd<true>, the forward of training, also stores the state at the
// start of every segment of SEG = 16 steps into hck (B, ceil(S / 16), I, N),
// hck[:, 0] = h0: the checkpoints from which ssm_scan_bwd.cu recomputes
// each segment's states (17 MB at falcon-mamba's training chunk, B = 2,
// S = 256, against 0.55 GB read).  The recurrence is the same fmaf in both
// builds and in the backward's recomputation, so y and h_last are equal
// bit for bit across the builds and the backward's states are the ones
// this kernel had.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int U = 8;     // steps loaded ahead
constexpr int SEG = 16;  // steps a checkpointed segment: ssm_scan_bwd.cu's

template <bool CKPT>
__global__ void __launch_bounds__(NT)
ssm_fwd(const float* __restrict__ dA, const float* __restrict__ dBx,
        const float* __restrict__ C, const float* __restrict__ h0,
        float* __restrict__ y, float* __restrict__ h_last,
        float* __restrict__ hck, int B, int S, int I, int N) {
  static_assert(SEG % U == 0, "a segment starts at a step of the U loop");
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
  const int nseg = (S + SEG - 1) / SEG;
  for (int t0 = 0; t0 < S; t0 += U) {
    if (CKPT && t0 % SEG == 0)
      hck[((long long)b * nseg + t0 / SEG) * IN + (long long)i * N + n] = h;
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
      h = fmaf(a[u], h, bx[u]);
      float yv = h * c[u];
      for (int off = N / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (n == 0) y[ybase + (long long)t * I] = yv;
    }
  }
  h_last[(long long)b * IN + (long long)i * N + n] = h;
}

}  // namespace

// N must divide 32 and 32 / N divide I.  hck: null for the plain build, or
// f32 (B, ceil(S / 16), I, N) for the build that writes the checkpoints.
extern "C" int ssm_scan_launch(const float* dA, const float* dBx,
                               const float* C, const float* h0, float* y,
                               float* h_last, float* hck, int B, int S, int I,
                               int N, void* stream) {
  if (N < 1 || 32 % N != 0 || I % (32 / N) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_warps = (long long)B * I / (32 / N);
  const long long blocks = (n_warps + NT / 32 - 1) / (NT / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hck == nullptr)
    ssm_fwd<false><<<(unsigned)blocks, NT, 0, st>>>(dA, dBx, C, h0, y, h_last,
                                                   nullptr, B, S, I, N);
  else
    ssm_fwd<true><<<(unsigned)blocks, NT, 0, st>>>(dA, dBx, C, h0, y, h_last,
                                                  hck, B, S, I, N);
  return static_cast<int>(cudaGetLastError());
}
