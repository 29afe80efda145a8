// Flash attention (forward) for Hopper (sm_90a), bf16 at head dims 64 and
// 128: a warp-specialised kernel on wgmma and TMA, fa_wgmma.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _fa_kernel),
// with the function, masks, GQA rule and numerics of fa_mma in
// flash_attention.cu: q (B, H, S, D), k, v (B, Hkv, S, D) given by strides
// (the model's (B, S, H, D) projections seen through permuted views, nothing
// copied), query head h reads KV head h / G, causal k <= q, window
// k > q - window, f32 scores and softmax, p rounded to bf16 before P.V, f32
// sums, output bf16 written in the (B, S, H, D) layout.  Any S >= 1.
//
// What bounds it on this card: operations.  At the Qwen3-8B prefill shape
// (B=4, H=32, S=2048, D=128, causal) the call does 137 GFLOP on 84 MB of
// inputs and output, ~1600 flops a byte, far above the ~295 a byte where the
// tensor cores, not memory, set the limit; 989 TFLOP/s makes 0.139 ms.
// mma.sync (fa_mma) cannot reach that rate on Hopper: only wgmma can, and
// only if the tensor cores never wait for loads or for the softmax.
//
// Design (the usual shape of a fast kernel on Hopper):
// - A block takes 128 query rows of one (b, h): two consumer warpgroups of 64
//   rows each, plus one producer warpgroup.  The grid is (B*H, query tiles),
//   the last (heaviest causal) query tiles first.
// - The producer's first thread loads the Q tile once and then keeps a ring
//   of three K/V stages of 128 rows in flight with TMA (cp.async.bulk.tensor,
//   4-D tensor maps over the strided views, completion on mbarriers).  The
//   128-byte swizzle takes 64 bf16 a box row, so D = 128 is two boxes.  TMA
//   zero-fills rows past S.  The producer's registers are cut to 24 with
//   setmaxnreg, the consumers' raised to 240.
// - Each consumer warpgroup computes S = Q K^T with wgmma (both operands in
//   shared memory, K-major) into 64 f32 registers a thread, masks and runs
//   the online softmax in registers (a row lives in the 4 lanes of a quad),
//   rounds P to bf16 in registers in the layout wgmma takes as its A operand,
//   and computes O += P V with wgmma (A from registers, V from shared memory
//   read transposed, MN-major).  It then releases the stage to the producer.
//   While one warpgroup runs its softmax the other's products run, so the
//   tensor cores are fed from two sources.
// - Tiles above the causal diagonal, below the window or past S are never
//   loaded.  Masked entries get p = 0, so a row that sees no valid key in a
//   tile keeps its l and acc.
// - O is scaled by 1/l, rounded to bf16, staged through the warpgroup's own
//   Q rows in shared memory and written with 16-byte stores.
// - A second build (LSE = true), which the training forward runs, also
//   writes each row's log-sum-exp in log2 units, L = m + log2 l (0 for a row
//   with no kept key), for the backward kernels of
//   flash_attention_bwd_wgmma.cu: f32 (B, H, SP) with SP = 128 ceil(S /
//   128), rows past S not written.  The build without it (every prefill)
//   is the same code as before it existed.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;   // query rows a block: two consumer warpgroups
constexpr int BK = 128;   // key rows a stage, at D = 64 and at D = 128
constexpr int NST = 3;    // K/V stages in the ring
constexpr int NTH = 384;  // producer warpgroup + two consumer warpgroups
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D> struct Cfg {
  static constexpr int HALVES = D / 64;         // 128-byte swizzle boxes a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * KV_BYTES;
  // barriers: q_full, k_full[NST], v_full[NST], empty[NST]; 1 KB of slack
  // to align the base to the 1024 bytes the swizzle needs: 230,480 bytes at
  // D = 128, within the 232,448 a block may have
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * NST);
};

// S (64 x 128) = Q K^T for a warpgroup's 64 rows: D / 16 steps over the
// head dim, 4 a 64-column box
template <int D>
__device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t sQw, uint32_t sKs) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns of the 64 in a box row
    const uint64_t da = desc(sQw + (ks / 4) * BQ * 128 + off, 16, 1024);
    const uint64_t db = desc(sKs + (ks / 4) * BK * 128 + off, 16, 1024);
    wgmma_ss_n128(sc, da, db, ks > 0);
  }
}

// O (64 x D) += P V: 16 key rows a step; LBO = the 64-column halves of V,
// SBO = 8 key rows
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                   uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc(sVs + kk * 16 * 128, BK * 128, 1024);
    if constexpr (D == 128) wgmma_rs_n128(o, pa[kk], db);
    else wgmma_rs_n64(o, pa[kk], db);
  }
}

// mask, online softmax and P in bf16 for one tile of keys from k0.  Element
// i of sc holds row ``row`` + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) +
// ``col`` + i % 2; the S fragments of keys 16 kk .. 16 kk + 15 are the A
// fragment of P V's key step kk.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[BK / 16][4], int k0,
                                             int row, int col, int rw0, int S,
                                             int causal, int window,
                                             float scale_log2) {
  const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > rw0) ||
                         (window > 0 && k0 <= rw0 + 63 - window);
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qp = row + 8 * ((i >> 1) & 1);
      const int kp = k0 + 8 * (i >> 2) + col + (i & 1);
      bool ok = kp < S;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      sc[i] = ok ? sc[i] * scale_log2 : -CUDART_INF_F;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hf], sc[4 * j + 2 * hf + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hf], mx);  // >= NEG_INF: never -inf
    const float corr = exp2f(m[hf] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * hf + e];
        x = exp2f(x - m_new);  // exp2(-inf) = 0 where masked
        ps += x;
      }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l[hf] = corr * l[hf] + ps;
    m[hf] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * hf] *= corr;
      o[4 * j + 2 * hf + 1] *= corr;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NTH, 1)
fa_wgmma(const __grid_constant__ CUtensorMap tmq,
         const __grid_constant__ CUtensorMap tmk,
         const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ out,
         float* __restrict__ lse, int H, int G, int S, int n_q, long long osb,
         long long osh, long long oss, float scale_log2, int causal, int window,
         int perm_q, int perm_k, int perm_v) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + C::K_OFF, sV = sQ + C::V_OFF;
  const uint32_t bar = sQ + C::BAR_OFF;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + NST + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * NST + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, hk = h / G;
  const int qt = n_q - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * BQ;

  // the KV tiles this query tile can see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = (causal ? q_last : S - 1) / BK + 1;
  int kt_begin = 0;
  if (window > 0) {
    const int k_min = q0 - window + 1;  // lowest key any row here keeps
    kt_begin = k_min > 0 ? k_min / BK : 0;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        tma_load_sbh(sQ + hf * BQ * 128, &tmq, q_full, hf * 64, q0, h, b, perm_q);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int s = it % NST;
        mbar_wait(empty(s), ((it / NST) & 1) ^ 1);
        mbar_expect_tx(k_full(s), C::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
          tma_load_sbh(sK + s * C::KV_BYTES + hf * BK * 128, &tmk, k_full(s),
                       hf * 64, kt * BK, hk, b, perm_k);
        mbar_expect_tx(v_full(s), C::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
          tma_load_sbh(sV + s * C::KV_BYTES + hf * BK * 128, &tmv, v_full(s),
                       hf * 64, kt * BK, hk, b, perm_v);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rw0 = q0 + wg * 64;                 // the warpgroup's first row
  const int row = rw0 + warp * 16 + (lane >> 2);  // rows row and row + 8
  const int col = 2 * (lane & 3);               // first key column a thread holds
  const uint32_t sQw = sQ + wg * 64 * 128;      // its Q rows in each half

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
    const int s = it % NST;
    const uint32_t ph = (it / NST) & 1;
    mbar_wait(k_full(s), ph);
    wg_fence();
    qk<D>(sc, sQw, sK + s * C::KV_BYTES);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    softmax_tile<D>(sc, o, m, l, pa, kt * BK, row, col, rw0, S, causal, window,
                    scale_log2);
    mbar_wait(v_full(s), ph);
    wg_fence();
    pv<D>(o, pa, sV + s * C::KV_BYTES);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

  // epilogue: O / l in bf16, staged through this warpgroup's Q rows (the
  // 128-byte rows of each half, 16-byte chunks swizzled by row), then
  // written with 16-byte stores, rows past S dropped
  if constexpr (LSE) {
    if ((lane & 3) == 0)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (row + 8 * hf < S)
          lse[(long long)bh * n_q * BQ + row + 8 * hf] =
              l[hf] > 0.f ? m[hf] + log2f(l[hf]) : 0.f;
  }
  named_bar(1 + wg, 128);  // every warp of the warpgroup is done with Q
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  auto stage_addr = [&](int r, int c) {  // row r of 64, 16-byte chunk c
    return sQw + (c >> 3) * BQ * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  };
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = warp * 16 + (lane >> 2) + 8 * hf;
      const uint32_t v = pack_bf16(o[4 * j + 2 * hf] * inv[hf],
                                   o[4 * j + 2 * hf + 1] * inv[hf]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage_addr(r, j) + (lane & 3) * 4),
                   "r"(v)
                   : "memory");
    }
  named_bar(1 + wg, 128);
  __nv_bfloat16* ob = out + b * osb + h * osh;
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i - r * (D / 8);
    const int qp = rw0 + r;
    if (qp >= S) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stage_addr(r, c))
                 : "memory");
    *reinterpret_cast<uint4*>(ob + (long long)qp * oss + c * 8) = v;
  }
}

template <int D, bool LSE>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int H, int G, int S, long long qsb, long long qsh,
           long long qss, long long ksb, long long ksh, long long kss,
           long long vsb, long long vsh, long long vss, long long osb,
           long long osh, long long oss, float scale, int causal, int window,
           cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int pq, pk, pv, r;
  if ((r = make_map(&tq, &pq, q, D, S, H, B, qss, qsh, qsb, BQ)) != 0) return 1000 + r;
  if ((r = make_map(&tk, &pk, k, D, S, H / G, B, kss, ksh, ksb, BK)) != 0) return 1000 + r;
  if ((r = make_map(&tv, &pv, v, D, S, H / G, B, vss, vsh, vsb, BK)) != 0) return 1000 + r;
  const int smem = Cfg<D>::SMEM;
  // above 48 KB a block's dynamic shared memory must be asked for, or the
  // launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      fa_wgmma<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_q = (S + BQ - 1) / BQ;
  fa_wgmma<D, LSE><<<dim3(B * H, n_q), NTH, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, H, G, S, n_q, osb, osh,
      oss, scale * LOG2E, causal, window, pq, pk, pv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v at head dim 64 or 128: 16-byte aligned data and every stride of
// a dimension longer than 1 a multiple of 8 elements, which the caller
// checks.  lse: null for the plain build, or f32 (B, H, SP), SP = 128 ceil(S
// / 128), for the build that also writes each row's log-sum-exp (log2
// units).  Returns a cudaError_t, or 1000 + the CUresult of a tensor map
// that the CUDA driver refused.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, float* lse, int B,
    int H, int G, int S, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(DIM, LSE)                                                     \
  launch<DIM, LSE>(q, k, v, out, lse, B, H, G, S, qsb, qsh, qss, ksb, ksh, kss, \
                   vsb, vsh, vss, osb, osh, oss, scale, causal, window, st)
  if (D == 64) return lse == nullptr ? FA_LAUNCH(64, false) : FA_LAUNCH(64, true);
  if (D == 128) return lse == nullptr ? FA_LAUNCH(128, false) : FA_LAUNCH(128, true);
#undef FA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory a block of fa_wgmma takes at head dim D
extern "C" int flash_attention_wgmma_smem(int D) {
  return D == 64 ? Cfg<64>::SMEM : D == 128 ? Cfg<128>::SMEM : 0;
}
