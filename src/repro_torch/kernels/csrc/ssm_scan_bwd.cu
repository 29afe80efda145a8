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
// (B, S, I, N) f32 tensors at 6 flops an element (268 MB each at
// falcon-mamba's training chunk, B = 2, S = 256, I = 8192, N = 16).  Beside
// them it reads the checkpoints, dy and C, and writes and reads the dC
// partials: 6% more.
//
// Design.  The lane layout is the forward's: one thread a (channel, state),
// a warp 32 / N channels, a block of 8 warps one contiguous run of 256
// elements of a batch row's (I, N).  The states h_{t-1} are recomputed from
// checkpoints, not stored (a stored chunk would be 268 MB): the forward's
// training build (ssm_scan.cu, ssm_fwd<true>) keeps the state at the start
// of every segment of SEG = 16 steps in hck (B, ceil(S / 16), I, N).  So
// each element of dA and dBx is read once, by ssm_bwd_tma:
//  - it walks the segments from the last.  A segment's (16 steps x 256
//    elements) tiles of dA and dBx, 16 KB each, are copied into shared
//    memory by TMA through a 3-D tensor map over (B, S, I * N), whose zero
//    fill stops each box at its batch row's end (ragged S) and at the end
//    of (I, N).  Two stages: the copy of the next segment is in flight
//    while this one recomputes its 16 states from its checkpoint (the
//    forward's fmaf, so the states are the forward's bit for bit), each
//    thread writing them over its own column of the dBx tile, and runs dh
//    backward through them.  At 72 KB a block, three blocks share an SM,
//    each with one 32 KB copy in flight;
//  - d(dA) and d(dBx) go out as the forward reads: 128 bytes a warp a step;
//  - dC_t[n] is summed over the warp's channels with shuffles and over the
//    block's 8 warps in shared memory, and each block writes its partial
//    (B, S, blocks, N); ssm_bwd_dc, one block a (b, t), sums the partials
//    over the blocks in a fixed order.
// No atomics: the result is the same from run to run.

#include "hopper.cuh"

namespace {

constexpr int NT = 256;   // threads a block: 8 warps
constexpr int NW = NT / 32;
constexpr int SEG = 16;   // steps a segment: ssm_scan.cu's checkpoints
constexpr int NST = 2;    // stages of (dA, dBx) tiles
constexpr int TILE = SEG * NT;           // floats of one array's tile
constexpr int STAGE_BYTES = 2 * TILE * 4;

// dynamic shared memory a block takes: the stages, the dC partials of a
// segment, the stages' mbarriers, and room to align the stages to 128 bytes
int smem_bytes(int N) { return NST * STAGE_BYTES + SEG * NW * N * 4 + 8 * NST + 128; }

__global__ void __launch_bounds__(NT, 3)
ssm_bwd_tma(const __grid_constant__ CUtensorMap tm_a,
            const __grid_constant__ CUtensorMap tm_bx, const float* __restrict__ C,
            const float* __restrict__ hck, const float* __restrict__ dy,
            const float* __restrict__ dh_last, float* __restrict__ d_dA,
            float* __restrict__ d_dBx, float* __restrict__ dc_part,
            float* __restrict__ dh0, int S, int I, int N) {
  extern __shared__ uint8_t smem_raw[];
  // (pointer arithmetic, not an integer round trip, so that the compiler
  // still reads the tiles as shared memory)
  float* tiles =
      reinterpret_cast<float*>(smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  float* red = tiles + NST * 2 * TILE;  // (SEG, NW, N)
  const uint32_t s_tiles = smem_u32(tiles);
  const uint32_t bar0 = smem_u32(red + SEG * NW * N);  // NST mbarriers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, e0 = blockIdx.x * NT;
  const long long IN = (long long)I * N;
  const long long e = e0 + tid;  // this thread's element of (I, N)
  const bool active = e < IN;
  const int n = tid % N;         // e0 is a multiple of 256 and N divides 32
  const int nseg = (S + SEG - 1) / SEG;
  const long long base = (long long)b * S * IN + e;            // (b, 0, e)
  const long long cbase = (long long)b * S * N + n;            // (b, 0, n)
  const long long ybase = (long long)b * S * I + (active ? e / N : 0);
  const long long kbase = (long long)b * nseg * IN + e;        // hck (b, 0, e)

  // the tiles of the k-th segment from the last into stage k % NST
  auto load_segment = [&](int k) {
    const int st = k % NST;
    const uint32_t bar = bar0 + 8 * st, dst = s_tiles + st * STAGE_BYTES;
    const int t0 = (nseg - 1 - k) * SEG;
    mbar_expect_tx(bar, STAGE_BYTES);  // rows past S are filled and counted
    tma_load_3d(dst, &tm_a, bar, e0, t0, b);
    tma_load_3d(dst + TILE * 4, &tm_bx, bar, e0, t0, b);
  };
  if (tid == 0) {
    for (int st = 0; st < NST; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < NST && k < nseg; ++k) load_segment(k);
  }
  __syncthreads();

  float g = active && dh_last != nullptr ? dh_last[(long long)b * IN + e] : 0.f;
  for (int k = 0; k < nseg; ++k) {
    const int s = nseg - 1 - k, t0 = s * SEG;
    // the segment's small operands, loaded while its tiles land
    const float hstart = active ? hck[kbase + s * IN] : 0.f;
    float c[SEG], dyv[SEG];
#pragma unroll
    for (int u = 0; u < SEG; ++u) {
      const int t = t0 + u;
      c[u] = t < S ? C[cbase + (long long)t * N] : 0.f;
      dyv[u] = active && t < S && dy != nullptr ? dy[ybase + (long long)t * I] : 0.f;
    }
    const int st = k % NST;
    mbar_wait(bar0 + 8 * st, (k / NST) & 1);
    const float* ta = tiles + st * 2 * TILE + tid;  // dA (u, tid) at ta[u * NT]
    float* hs = tiles + st * 2 * TILE + TILE + tid;  // dBx, then the states
    float h = hstart;
#pragma unroll
    for (int u = 0; u < SEG; ++u) {  // each thread its own column: no sync
      h = fmaf(ta[u * NT], h, hs[u * NT]);
      hs[u * NT] = h;
    }
#pragma unroll
    for (int u = SEG - 1; u >= 0; --u) {
      const int t = t0 + u;
      if (t >= S) continue;  // uniform across the block
      const float dh = fmaf(dyv[u], c[u], g);
      if (active) {
        d_dBx[base + (long long)t * IN] = dh;
        d_dA[base + (long long)t * IN] = dh * (u > 0 ? hs[(u - 1) * NT] : hstart);
      }
      float x = dyv[u] * hs[u * NT];  // zero on inactive lanes
      for (int off = N; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane < N) red[(u * NW + warp) * N + lane] = x;
      g = ta[u * NT] * dh;
    }
    // the states written over dBx are ordered before the next TMA write
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every warp is done with the stage and has written red
    if (tid == 0 && k + NST < nseg) load_segment(k + NST);
    for (int j = tid; j < SEG * N; j += NT) {
      const int u = j / N, m = j - u * N, t = t0 + u;
      if (t >= S) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += red[(u * NW + w) * N + m];
      dc_part[(((long long)b * S + t) * gridDim.x + blockIdx.x) * N + m] = sum;
    }
    __syncthreads();  // red is read before the next segment writes it
  }
  if (active) dh0[(long long)b * IN + e] = g;
}

// one block a (b, t): dC[b, t, n] summed over the nblk partials in a fixed
// order, thread j * N + n taking partials j, j + NT / N, ... (contiguous
// across the block), then a tree over j in shared memory
__global__ void __launch_bounds__(NT)
ssm_bwd_dc(const float* __restrict__ dc_part, float* __restrict__ dC, int nblk,
           int N) {
  __shared__ float red[NT];
  const int tid = threadIdx.x, per = NT / N, j = tid / N;
  const float* p = dc_part + (long long)blockIdx.x * nblk * N;
  float sum = 0.f;
  for (int k = j; k < nblk; k += per) sum += p[(long long)k * N + tid % N];
  red[tid] = sum;
  __syncthreads();
  for (int w = per / 2; w > 0; w >>= 1) {  // per is a power of two
    if (j < w) red[tid] += red[tid + w * N];
    __syncthreads();
  }
  if (j == 0) dC[(long long)blockIdx.x * N + tid] = red[tid];
}

// a 3-D map over a contiguous f32 (B, S, I * N) tensor, in boxes of (1, SEG,
// NT); rows past S and elements past I * N read as zeros.  Returns 0 or the
// CUresult.
int make_map_3d(CUtensorMap* map, const float* base, long long IN, int S, int B) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {(cuuint64_t)IN, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)IN * 4, (cuuint64_t)S * IN * 4};
  const cuuint32_t box[3] = {NT, SEG, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                   dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

}  // namespace

// blocks a batch row takes: 256 elements of (I, N) each
extern "C" int ssm_scan_bwd_blocks(int I, int N) {
  return (int)(((long long)I * N + NT - 1) / NT);
}

// dynamic shared memory a block of ssm_bwd_tma takes at state size N
extern "C" int ssm_scan_bwd_smem(int N) { return smem_bytes(N); }

// N must divide 32 and 32 / N divide I; dA and dBx 16-byte aligned, which
// the caller checks.  hck: the forward's checkpoints (B, ceil(S / 16), I,
// N).  dy and dh_last may be null (zero gradient).  Scratch: dc_part (B, S,
// ssm_scan_bwd_blocks(I, N), N), f32.  Outputs: d_dA, d_dBx (B, S, I, N),
// dC (B, S, N), dh0 (B, I, N).  Returns a cudaError_t, or 1000 + the
// CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int ssm_scan_bwd_launch(const float* dA, const float* dBx,
                                   const float* C, const float* hck,
                                   const float* dy, const float* dh_last,
                                   float* d_dA, float* d_dBx, float* dC,
                                   float* dh0, float* dc_part, int B, int S,
                                   int I, int N, void* stream) {
  if (N < 1 || 32 % N != 0 || I % (32 / N) != 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long IN = (long long)I * N;
  CUtensorMap tm_a, tm_bx;
  int r;
  if ((r = make_map_3d(&tm_a, dA, IN, S, B)) != 0) return 1000 + r;
  if ((r = make_map_3d(&tm_bx, dBx, IN, S, B)) != 0) return 1000 + r;
  const int smem = smem_bytes(N);
  // above 48 KB a block's dynamic shared memory must be asked for, or the
  // launch is refused; the carveout leaves room for three blocks an SM
  cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssm_bwd_tma,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = ssm_scan_bwd_blocks(I, N);
  ssm_bwd_tma<<<dim3(nblk, B), NT, smem, st>>>(tm_a, tm_bx, C, hck, dy, dh_last,
                                               d_dA, d_dBx, dc_part, dh0, S, I, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_dc<<<(unsigned)((long long)B * S), NT, 0, st>>>(dc_part, dC, nblk, N);
  return static_cast<int>(cudaGetLastError());
}
