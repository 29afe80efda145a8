// Flash attention backward for Hopper (sm_90a), bf16 at head dims 64, 80 and
// 128, masks (causal, window, full) by row index or by given positions, and
// GQA at any G: two warp-specialised kernels on wgmma and TMA,
// fa_bwd_dq_wgmma and fa_bwd_dkdv_wgmma.  The training forward's route:
// where fa_wgmma (flash_attention_wgmma.cu) runs the forward, which is every
// bf16 call of the port's configs, these run its gradient; head dims 16, 32
// and 96 in bf16 (fa_bwd_mma, also run by name as a yardstick) and f32 stay
// on flash_attention_bwd.cu.
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention has
// no backward; the reference trains through plain jnp
// (src/repro/models/attention.py::_attend_chunk) differentiated by XLA.
// These kernels compute that gradient with the numerics of
// flash_attention_bwd.cu and flash_attention_bwd_plain:
//   P = exp2(S * scale * log2 e - L), L = m + log2 l per query row, taken
//   from the forward (fa_wgmma's LSE build writes it), not recomputed;
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// with P and dS rounded to bf16 before their products, f32 sums, and dK and
// dV summed over each KV group's G query heads.
//
// What bounds it on this card: operations.  Five S x S x D products a (b,
// head) (S, dP, dV, dK, dQ); at stablelm-1.6b's training shape (B=8, H=32,
// S=2048, D=64, causal) 3.4e11 flops on 50 MB, 0.348 ms at 989 TFLOP/s.
// The design below does seven (S and dP in both kernels), all on wgmma.
//
// Design: FA3's deterministic split, no atomics, so two runs give the same
// bits.  Both kernels are shaped as fa_wgmma: a block owns 128 rows, split
// between two consumer warpgroups of 64; a producer warpgroup (registers cut
// to 24 with setmaxnreg, the consumers' raised to 240) loads the block's own
// operands once and keeps a ring of three stages of the other operands in
// flight with TMA (128-byte swizzle, completion on mbarriers).  A stage has
// BT rows: 128 at D = 64, 64 at D = 128, where the dK and dV accumulators
// (64 + 64 f32 a thread) leave room only for 64-column score tiles.
//  1. dq: one block per (128 queries, b, head), the heaviest causal tiles
//     first.  The consumers first form Delta of their rows from O and dO
//     (written for kernel 2) and read L.  For each key tile that the rows
//     can see: S = Q K^T and dP = dO V^T (wgmma, both operands in shared
//     memory, K-major; P is formed while dP's product runs), dS = P o (dP -
//     Delta) in registers, rounded to bf16 in the layout wgmma takes as its
//     A operand, and dQ += dS K (K read MN-major, as fa_wgmma reads V).
//  2. dkdv: one block per (128 keys, b, KV head), the heaviest causal blocks
//     first.  The ring walks the G query heads of the group and, in each,
//     the query tiles that can see the block's keys, each stage with its
//     slices of L and Delta (bulk copies: L and Delta are per column here).
//     S^T = K Q^T and dP^T = V dO^T; P^T and dS^T in registers; dV += P^T dO
//     and dK += dS^T Q, dO and Q read MN-major from the tiles that served as
//     the K-major operands of S^T and dP^T.  dK and dV stay in registers over
//     the whole group.
//     Where those blocks (B * Hkv * ceil(S / 128)) do not fill the card's
//     SMs and G > 1, as at qwen2-vl-7b's training shape (48 blocks, G = 7),
//     the wrapper splits each group's heads over n_split blocks (SPLIT
//     builds): each writes its f32 dK and dV terms, and fa_bwd_dkdv_sum adds
//     them in split order (no atomics: still the same bits run to run),
//     scales dK and rounds both to bf16.  Unsplit calls (every training
//     shape of stablelm-1.6b and qwen3-8b) keep the bits of the unsplit
//     kernel: scripts/compare_attention_builds.py holds them to another
//     commit's build.
// Tiles above the causal diagonal, below the window or past S are never
// loaded; a warpgroup whose 64 rows see none of a loaded tile skips it.
// Results are scaled, rounded to bf16 and staged through the warpgroup's own
// rows of shared memory for 16-byte stores, rows past S dropped.  exp2 is
// one MUFU.EX2 (ex2.approx.ftz).  Each tile ends with every product waited
// for: carrying a tile's dQ (or dK, dV) product into the next tile made
// ptxas serialize the wgmma (C7515), and ran slower.
//
// L and Delta: f32 (B, H, SP), SP = 128 ceil(S / 128), so that each stage's
// slice is a 16-byte aligned bulk copy.  Past S, Delta is written 0 and L is
// never used (the mask selects P = 0 there).
//
// Given positions (POS builds; the builds without them give the bits they
// gave before positions existed), the tiles walked and the element masks
// follow fa_wgmma's: each 64-row
// tile's least and greatest position (the wrapper's tables) decide, for the
// block's rows, which tiles of the other operand are loaded (dq: key tiles
// whose positions some of its queries keep; dkdv, the mirror: query tiles
// that keep some of its keys), for each warpgroup which loaded tiles it
// skips, and where every pair is kept, so that no element mask is needed.
// A row with no kept key has L = 0 from the forward and P = 0 everywhere:
// its gradients are 0.
//
// Head dim 80 runs in the layout of 128, as fa_wgmma runs it: TMA
// zero-fills columns 80-127 of each row's second box, S and dP take 5
// steps of 16 columns, dQ, dK and dV are summed at N = 128 (their columns
// past 80 are 0) and only 80 columns are stored.

#include "hopper.cuh"

namespace {

using bf = __nv_bfloat16;

constexpr int BR = 128;   // rows a block owns: queries (dq), keys (dkdv)
constexpr int NST = 3;    // ring stages
constexpr int NTH = 384;  // producer warpgroup + two consumer warpgroups

template <int D> struct Tiles {
  static constexpr int DK = D == 80 ? 128 : D;  // a row's width in shared memory
  static constexpr int HALVES = DK / 64;        // 128-byte swizzle boxes a row
  static constexpr int BT = D == 64 ? 128 : 64;  // rows a ring stage
  static constexpr int OWN = BR * DK * 2;       // one owned operand
  static constexpr int TILE = BT * DK * 2;      // one staged operand
};

// dq: Q, dO (owned), NST x (K, V), Delta of the block's rows, barriers
// (q_full, full[NST], empty[NST]); 1 KB of slack aligns the base to 1024
template <int D> struct DqSmem {
  using T = Tiles<D>;
  static constexpr int Q_OFF = 0, DO_OFF = T::OWN, K_OFF = 2 * T::OWN;
  static constexpr int V_OFF = K_OFF + NST * T::TILE;
  static constexpr int DL_OFF = V_OFF + NST * T::TILE;
  static constexpr int BAR_OFF = DL_OFF + BR * 4;
  // under positions the bits of the key tiles kept follow the barriers
  static constexpr int BITS_OFF = BAR_OFF + 8 * (1 + 2 * NST);
  static constexpr int SMEM = 1024 + BITS_OFF;
};

// dkdv: K, V (owned), NST x (Q, dO), NST x (L, Delta slices), barriers
// (kv_full, full[NST], empty[NST])
template <int D> struct DkdvSmem {
  using T = Tiles<D>;
  static constexpr int K_OFF = 0, V_OFF = T::OWN, Q_OFF = 2 * T::OWN;
  static constexpr int DO_OFF = Q_OFF + NST * T::TILE;
  static constexpr int LD_OFF = DO_OFF + NST * T::TILE;
  static constexpr int LD_BYTES = 2 * T::BT * 4;  // one stage's L and Delta
  static constexpr int BAR_OFF = LD_OFF + NST * LD_BYTES;
  // under positions the bits of the query tiles kept follow the barriers
  static constexpr int BITS_OFF = BAR_OFF + 8 * (1 + 2 * NST);
  static constexpr int SMEM = 1024 + BITS_OFF;
};

struct Args {
  const bf *o, *dout;  // read directly by dq, for Delta
  const float* lse;    // (B, H, SP), log2 units
  float* delta;        // (B, H, SP), written by dq, read by dkdv
  bf *dq, *dk, *dv;
  long long so_b, so_h, so_s, sdo_b, sdo_h, sdo_s;
  long long sdq_b, sdq_h, sdq_s, sdk_b, sdk_h, sdk_s, sdv_b, sdv_h, sdv_s;
  int H, G, S, SP, causal, window;
  float scale, scale_log2;
  int perm_q, perm_do, perm_k, perm_v;
  PosArgs ps;          // given positions, or all null
  int n_split;         // blocks a KV group's heads are split over (SPLIT)
  float* part;         // f32 (2, n_split, B, Hkv, S, D): dK's terms, dV's
};

// C (64 x N) = A (64 x D) B^T (N x D), both in shared memory, K-major: A is
// a warpgroup's 64 rows of a 128-row owned operand, B an N-row tile
template <int D, int N>
__device__ __forceinline__ void ss(float (&c)[N / 2], uint32_t sA, uint32_t sB) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns of the 64 in a box row
    const uint64_t da = desc(sA + (ks / 4) * BR * 128 + off, 16, 1024);
    const uint64_t db = desc(sB + (ks / 4) * N * 128 + off, 16, 1024);
    if constexpr (N == 128) wgmma_ss_n128(c, da, db, ks > 0);
    else wgmma_ss_n64(c, da, db, ks > 0);
  }
}

// C (64 x D) += A (64 x K, registers) B (K x D, a K-row tile in shared
// memory, MN-major): 16 rows of B a step; LBO = its 64-column halves, SBO =
// 8 rows
template <int D, int K>
__device__ __forceinline__ void rs(float (&c)[D / 2], const uint32_t (&a)[K / 16][4],
                                   uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc(sB + kk * 16 * 128, K * 128, 1024);
    if constexpr (D == 128) wgmma_rs_n128(c, a[kk], db);
    else wgmma_rs_n64(c, a[kk], db);
  }
}

// accumulator element i of a 64 x N product: row r0 + 8 ((i / 2) % 2),
// column c0 + 8 (i / 4) + i % 2 (r0 = 16 warp + lane / 4, c0 = 2 (lane %
// 4)); the elements of columns 16 kk .. 16 kk + 15 are the A fragment of a
// product's step kk
template <int N>
__device__ __forceinline__ void to_a(const float (&c)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// 2^x with denormal results flushed to 0: one MUFU.EX2, where exp2f adds
// instructions that handle denormals (a P below 2^-126 adds nothing that a
// sum of bf16 products can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool kept(int qp, int kp, int S, int causal, int window) {
  return kp < S && qp < S && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// 64 rows x D of a scaled f32 accumulator of DK columns, in bf16, staged
// through the warpgroup's own rows ``sW`` of a 128-row owned tile (the
// 16-byte chunks of a 128-byte row swizzled by row), then written with
// 16-byte stores to rows r0 .. r0 + 63 of ``out`` (row stride rs), rows
// past S dropped.  The caller has made sure the warpgroup no longer reads
// sW.
template <int D, int DK>
__device__ __forceinline__ void store_rows(const float (&c)[DK / 2], float mul,
                                           uint32_t sW, bf* out, long long rs,
                                           int r0, int S, int t) {
  const int warp = t >> 5, lane = t & 31;
  auto stage_addr = [&](int r, int ch) {  // row r of 64, 16-byte chunk ch
    return sW + (ch >> 3) * BR * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  };
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = warp * 16 + (lane >> 2) + 8 * hf;
      const uint32_t v = pack_bf16(c[4 * j + 2 * hf] * mul, c[4 * j + 2 * hf + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage_addr(r, j) + (lane & 3) * 4),
                   "r"(v)
                   : "memory");
    }
  named_bar(1 + (threadIdx.x / 128 - 1), 128);
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i - r * (D / 8);
    if (r0 + r >= S) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stage_addr(r, ch))
                 : "memory");
    *reinterpret_cast<uint4*>(out + (long long)(r0 + r) * rs + ch * 8) = v;
  }
}

// 64 rows x D of an f32 accumulator of DK columns, as they are, to rows r0
// .. r0 + 63 of ``out`` (D floats a row), rows past S dropped
template <int D, int DK>
__device__ __forceinline__ void store_part(const float (&c)[DK / 2], float* out,
                                           int r0, int S, int t) {
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * hf;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + (long long)r * D + 8 * j + 2 * (lane & 3)) =
          make_float2(c[4 * j + 2 * hf], c[4 * j + 2 * hf + 1]);
  }
}

__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    s += a.x * b.x + a.y * b.y;
  }
  return s;
}

template <int D, bool POS>
__global__ void __launch_bounds__(NTH, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmdo,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const Args a) {
  using T = Tiles<D>;
  using C = DqSmem<D>;
  constexpr int BT = T::BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t sQ = base + C::Q_OFF, sdO = base + C::DO_OFF;
  const uint32_t sK = base + C::K_OFF, sV = base + C::V_OFF;
  float* sDl = reinterpret_cast<float*>(smem + C::DL_OFF);
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t q_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + NST + s); };

  const int S = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H, hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // heaviest causal tiles first

  // the key tiles these rows can see; under positions each is weighed by
  // its positions' range against the block's, and warp 0 sets the bits of
  // the tiles kept, which both sides walk (``next``), as fa_wgmma does
  const int q_last = min(q0 + BR, S) - 1;
  int kt_end = (a.causal ? q_last : S - 1) / BT + 1;
  int kt_begin = 0;
  if (a.window > 0) {
    const int k_min = q0 - a.window + 1;  // lowest key any row here keeps
    kt_begin = k_min > 0 ? k_min / BT : 0;
  }
  const int T64 = a.ps.T64;
  const int2* qtab = a.ps.qtab + (long long)b * T64;
  const int2* ktab = a.ps.ktab + (long long)b * T64;
  uint32_t* kept_bits = reinterpret_cast<uint32_t*>(smem + C::BITS_OFF);
  if constexpr (POS) {
    kt_begin = 0;
    kt_end = (S - 1) / BT + 1;
    if (threadIdx.x < 32) {
      const int2 q_blk = pos_range(qtab, T64, q0, BR);
      mark_tiles(kept_bits, kt_end, [&](int kt) {
        return !pos_none(q_blk, pos_range(ktab, T64, kt * BT, BT), a.causal, a.window);
      });
    }
  }
  auto next = [&](int kt) {
    if constexpr (POS) return next_tile(kept_bits, kt, kt_end);
    else return kt;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * T::OWN);
#pragma unroll
      for (int hf = 0; hf < T::HALVES; ++hf) {
        tma_load_sbh(sQ + hf * BR * 128, &tmq, q_full, hf * 64, q0, h, b, a.perm_q);
        tma_load_sbh(sdO + hf * BR * 128, &tmdo, q_full, hf * 64, q0, h, b, a.perm_do);
      }
      for (int kt = next(kt_begin), it = 0; kt < kt_end; kt = next(kt + 1)) {
        const int s = it % NST;
        mbar_wait(empty(s), ((it / NST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::TILE);
#pragma unroll
        for (int hf = 0; hf < T::HALVES; ++hf) {
          tma_load_sbh(sK + s * T::TILE + hf * BT * 128, &tmk, full(s), hf * 64,
                       kt * BT, hk, b, a.perm_k);
          tma_load_sbh(sV + s * T::TILE + hf * BT * 128, &tmv, full(s), hf * 64,
                       kt * BT, hk, b, a.perm_v);
        }
        ++it;
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rw0 = q0 + wg * 64;                   // the warpgroup's first row
  const int row = rw0 + warp * 16 + (lane >> 2);  // rows row and row + 8
  const int col = 2 * (lane & 3);                 // first key column a thread holds

  // Delta = rowsum(dO o O) of the warpgroup's 64 rows, two threads a row
  {
    const int r = t >> 1, qp = rw0 + r, c0 = (t & 1) * (D / 2);
    float acc = 0.f;
    if (qp < S) {
      const bf* orow = a.o + b * a.so_b + h * a.so_h + (long long)qp * a.so_s + c0;
      const bf* drow = a.dout + b * a.sdo_b + h * a.sdo_h + (long long)qp * a.sdo_s + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8)
        acc += dot8(*reinterpret_cast<const uint4*>(orow + c),
                    *reinterpret_cast<const uint4*>(drow + c));
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((t & 1) == 0) {  // 0 past S: the dkdv kernel reads whole slices
      sDl[wg * 64 + r] = acc;
      a.delta[(long long)bh * a.SP + qp] = acc;
    }
  }
  named_bar(1 + wg, 128);
  float Lr[2], Dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    Lr[hf] = r < S ? a.lse[(long long)bh * a.SP + r] : 0.f;
    Dr[hf] = sDl[r - q0];
  }

  // under positions: the warpgroup's range and its two rows' positions
  int2 q_wg = make_int2(0, 0);
  int qv[2] = {0, 0};
  const int* kp = a.ps.k + (long long)b * S;
  if constexpr (POS) {
    if (rw0 < S) q_wg = pos_range(qtab, T64, rw0, 64);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (row + 8 * hf < S) qv[hf] = a.ps.q[(long long)b * S + row + 8 * hf];
  }

  constexpr int DK = T::DK;
  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;
  float sc[BT / 2], dp[BT / 2];
  uint32_t da[BT / 16][4];
  mbar_wait(q_full, 0);
  for (int kt = next(kt_begin), it = 0; kt < kt_end; kt = next(kt + 1)) {
    int2 kr = make_int2(0, 0);
    if constexpr (POS) kr = pos_range(ktab, T64, kt * BT, BT);
    const int s = it % NST;
    mbar_wait(full(s), (it / NST) & 1);
    ++it;
    const int k0 = kt * BT;
    bool seen, need_mask = false;
    if constexpr (POS) {
      seen = rw0 < S && !pos_none(q_wg, kr, a.causal, a.window);
      need_mask = k0 + BT > S || !pos_all(q_wg, kr, a.causal, a.window);
    } else {
      seen = rw0 < S && !(a.causal && k0 > rw0 + 63) &&
             !(a.window > 0 && k0 + BT - 1 <= rw0 - a.window);
    }
    if (seen) {
      const uint32_t sKs = sK + s * T::TILE, sVs = sV + s * T::TILE;
      wg_fence();
      ss<D, BT>(sc, sQ + wg * 64 * 128, sKs);
      wg_commit();
      ss<D, BT>(dp, sdO + wg * 64 * 128, sVs);
      wg_commit();
      // P = exp2(S * scale log2 e - L), 0 where masked, while dP runs
      wg_wait<1>();
      fence_regs(sc);
      if constexpr (POS) {
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + col + e;
            const bool in = kj < S;
            const int kpj = need_mask && in ? kp[kj] : 0;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float& x = sc[4 * j + 2 * hf + e];
              const float p = ex2(x * a.scale_log2 - Lr[hf]);
              x = need_mask && !(in && row + 8 * hf < S &&
                                 pos_kept(qv[hf], kpj, a.causal, a.window))
                      ? 0.f
                      : p;
            }
          }
      } else {
        need_mask = k0 + BT > S || (a.causal && k0 + BT - 1 > rw0) ||
                    (a.window > 0 && k0 <= rw0 + 63 - a.window);
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const int hf = (i >> 1) & 1;
          const float p = ex2(sc[i] * a.scale_log2 - Lr[hf]);
          sc[i] = need_mask && !kept(row + 8 * hf, k0 + 8 * (i >> 2) + col + (i & 1),
                                     S, a.causal, a.window)
                      ? 0.f
                      : p;
        }
      }
      // dS = P (dP - Delta)
      wg_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) sc[i] *= dp[i] - Dr[(i >> 1) & 1];
      to_a<BT>(sc, da);
      wg_fence();
      rs<DK, BT>(dq, da, sKs);
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
    }
    mbar_arrive(empty(s));
  }

  named_bar(1 + wg, 128);  // every warp of the warpgroup is done with Q
  store_rows<D, DK>(dq, a.scale, sQ + wg * 64 * 128, a.dq + b * a.sdq_b + h * a.sdq_h,
                    a.sdq_s, rw0, S, t);
}

template <int D, bool POS, bool SPLIT>
__global__ void __launch_bounds__(NTH, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmdo, const Args a) {
  using T = Tiles<D>;
  using C = DkdvSmem<D>;
  constexpr int BT = T::BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t sQ = base + C::Q_OFF, sdO = base + C::DO_OFF;
  const uint32_t sLD = base + C::LD_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t kv_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + NST + s); };

  const int S = a.S, G = a.G, Hkv = a.H / G;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv, hk = bhk - b * Hkv;
  const int k0 = blockIdx.y * BR;  // low keys, the heaviest causal blocks, first

  // the query tiles that can see these keys, in each of the G heads
  const int k_last = min(k0 + BR, S) - 1;
  const int n_qt = (S + BT - 1) / BT;
  const int qt_begin = a.causal ? k0 / BT : 0;
  const int qt_end = a.window > 0 ? min(n_qt, (k_last + a.window - 1) / BT + 1) : n_qt;
  // the group's heads this block takes: all, or its split's G / n_split
  const int g0 = SPLIT ? blockIdx.z * (G / a.n_split) : 0;
  const int g1 = SPLIT ? g0 + G / a.n_split : G;
  const int n_t = max(qt_end - qt_begin, 0), n_it = (g1 - g0) * n_t;
  // under positions, the mirror of dq's walk: every query tile of each head
  // is weighed by its positions' range against the block's keys (k_blk)
  const int T64 = a.ps.T64;
  const int2* qtab = a.ps.qtab + (long long)b * T64;
  const int2* ktab = a.ps.ktab + (long long)b * T64;
  uint32_t* kept_bits = reinterpret_cast<uint32_t*>(smem + C::BITS_OFF);
  if constexpr (POS)
    if (threadIdx.x < 32) {
      const int2 k_blk = pos_range(ktab, T64, k0, BR);
      mark_tiles(kept_bits, n_qt, [&](int qt) {
        return !pos_none(pos_range(qtab, T64, qt * BT, BT), k_blk, a.causal, a.window);
      });
    }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::OWN);
#pragma unroll
      for (int hf = 0; hf < T::HALVES; ++hf) {
        tma_load_sbh(sK + hf * BR * 128, &tmk, kv_full, hf * 64, k0, hk, b, a.perm_k);
        tma_load_sbh(sV + hf * BR * 128, &tmv, kv_full, hf * 64, k0, hk, b, a.perm_v);
      }
      auto load = [&](int it, int g, int qt) {
        const int h = hk * G + g;
        const int s = it % NST;
        mbar_wait(empty(s), ((it / NST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * T::TILE + C::LD_BYTES);
#pragma unroll
        for (int hf = 0; hf < T::HALVES; ++hf) {
          tma_load_sbh(sQ + s * T::TILE + hf * BT * 128, &tmq, full(s), hf * 64,
                       qt * BT, h, b, a.perm_q);
          tma_load_sbh(sdO + s * T::TILE + hf * BT * 128, &tmdo, full(s), hf * 64,
                       qt * BT, h, b, a.perm_do);
        }
        const long long r0 = ((long long)b * a.H + h) * a.SP + qt * BT;
        bulk_load(sLD + s * C::LD_BYTES, a.lse + r0, BT * 4, full(s));
        bulk_load(sLD + s * C::LD_BYTES + BT * 4, a.delta + r0, BT * 4, full(s));
      };
      if constexpr (POS) {
        int it = 0;
        for (int g = g0; g < g1; ++g)
          for (int qt = next_tile(kept_bits, 0, n_qt); qt < n_qt; qt = next_tile(kept_bits, qt + 1, n_qt))
            load(it++, g, qt);
      } else {
        for (int it = 0; it < n_it; ++it) {
          const int g = it / n_t;
          load(it, g0 + g, qt_begin + it - g * n_t);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int kw0 = k0 + wg * 64;                   // the warpgroup's first key
  const int key = kw0 + warp * 16 + (lane >> 2);  // keys key and key + 8
  const int col = 2 * (lane & 3);                 // first query column a thread holds
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;

  // under positions: the warpgroup's range and its two keys' positions
  int2 k_wg = make_int2(0, 0);
  int kv[2] = {0, 0};
  const int* qp = a.ps.q + (long long)b * S;
  if constexpr (POS) {
    if (kw0 < S) k_wg = pos_range(ktab, T64, kw0, 64);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (key + 8 * hf < S) kv[hf] = a.ps.k[(long long)b * S + key + 8 * hf];
  }

  constexpr int DK = T::DK;
  float dk[DK / 2], dv[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[BT / 2], dpt[BT / 2];
  uint32_t pa[BT / 16][4], da[BT / 16][4];
  mbar_wait(kv_full, 0);
  // one staged query tile from q0, whose positions lie in qr (POS)
  auto tile = [&](int it, int q0, int2 qr) {
    const int s = it % NST;
    mbar_wait(full(s), (it / NST) & 1);
    bool seen, need_mask = false;
    if constexpr (POS) {
      seen = kw0 < S && !pos_none(qr, k_wg, a.causal, a.window);
      need_mask = q0 + BT > S || kw0 + 64 > S || !pos_all(qr, k_wg, a.causal, a.window);
    } else {
      seen = kw0 < S && !(a.causal && q0 + BT - 1 < kw0) &&
             !(a.window > 0 && q0 > kw0 + 62 + a.window);
    }
    if (seen) {
      const uint32_t sQs = sQ + s * T::TILE, sdOs = sdO + s * T::TILE;
      wg_fence();
      ss<D, BT>(st, sKw, sQs);
      ss<D, BT>(dpt, sVw, sdOs);
      wg_commit();
      // P^T = exp2(S^T * scale log2 e - L) and dS^T = P^T (dP^T - Delta),
      // with L and Delta of each query column from the stage's slices (Delta
      // is 0 past S); P^T = 0 where masked.  (Overlapping P^T with dP^T, as
      // dq does, needs both in registers at once: at D = 64 that spilled and
      // made ptxas serialize the products.)
      const float* Ls = reinterpret_cast<const float*>(smem + C::LD_OFF + s * C::LD_BYTES);
      const float* Ds = Ls + BT;
      if constexpr (!POS)
        need_mask = q0 + BT > S || kw0 + 64 > S || (a.causal && kw0 + 63 > q0) ||
                    (a.window > 0 && kw0 <= q0 + BT - 1 - a.window);
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 lc = *reinterpret_cast<const float2*>(Ls + 8 * j + col);
        const float2 dc = *reinterpret_cast<const float2*>(Ds + 8 * j + col);
        if constexpr (POS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = q0 + 8 * j + col + e;
            const bool in = qi < S;
            const int qpi = need_mask && in ? qp[qi] : 0;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int i = 4 * j + 2 * hf + e;
              float p = ex2(st[i] * a.scale_log2 - (e ? lc.y : lc.x));
              if (need_mask && !(in && key + 8 * hf < S &&
                                 pos_kept(qpi, kv[hf], a.causal, a.window)))
                p = 0.f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - (e ? dc.y : dc.x));
            }
          }
        } else {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hf + e;
              float p = ex2(st[i] * a.scale_log2 - (e ? lc.y : lc.x));
              if (need_mask && !kept(q0 + 8 * j + col + e, key + 8 * hf, S, a.causal, a.window))
                p = 0.f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - (e ? dc.y : dc.x));
            }
        }
      }
      // dV += P^T dO and dK += dS^T Q
      to_a<BT>(st, pa);
      to_a<BT>(dpt, da);
      wg_fence();
      rs<DK, BT>(dv, pa, sdOs);
      rs<DK, BT>(dk, da, sQs);
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(empty(s));
  };
  if constexpr (POS) {
    int it = 0;
    for (int g = g0; g < g1; ++g)
      for (int qt = next_tile(kept_bits, 0, n_qt); qt < n_qt;
           qt = next_tile(kept_bits, qt + 1, n_qt))
        tile(it++, qt * BT, pos_range(qtab, T64, qt * BT, BT));
  } else {
    for (int it = 0; it < n_it; ++it) {
      const int g = it / n_t;
      tile(it, (qt_begin + it - g * n_t) * BT, make_int2(0, 0));
    }
  }

  if constexpr (SPLIT) {
    // this split's terms, summed by fa_bwd_dkdv_sum
    const long long plane = (long long)gridDim.x * S * D;  // one split's
    float* pk = a.part + (blockIdx.z * (long long)gridDim.x + bhk) * S * D;
    store_part<D, DK>(dk, pk, kw0, S, t);
    store_part<D, DK>(dv, pk + a.n_split * plane, kw0, S, t);
    return;
  }
  named_bar(1 + wg, 128);  // every warp of the warpgroup is done with K and V
  store_rows<D, DK>(dk, a.scale, sKw, a.dk + b * a.sdk_b + hk * a.sdk_h, a.sdk_s, kw0, S, t);
  store_rows<D, DK>(dv, 1.f, sVw, a.dv + b * a.sdv_b + hk * a.sdv_h, a.sdv_s, kw0, S, t);
}

// dK and dV from the SPLIT dkdv blocks' terms: each (b, KV head, key, 4
// columns) adds its n_split terms in split order, scales dK and stores both
// in bf16
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_dkdv_sum(const Args a, int B) {
  const int Hkv = a.H / a.G, S = a.S;
  const long long plane = (long long)B * Hkv * S * D;
  const long long n = plane / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = 4 * (int)(i % (D / 4));
    const long long row = i / (D / 4);  // (b * Hkv + hk) * S + s
    const int s = (int)(row % S), bhk = (int)(row / S);
    const int b = bhk / Hkv, hk = bhk - b * Hkv;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p = 0; p < a.n_split; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(a.part + p * plane + 4 * i);
      const float4 y =
          *reinterpret_cast<const float4*>(a.part + (a.n_split + p) * plane + 4 * i);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    const uint2 k2 = make_uint2(pack_bf16(sk.x * a.scale, sk.y * a.scale),
                                pack_bf16(sk.z * a.scale, sk.w * a.scale));
    const uint2 v2 = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
    *reinterpret_cast<uint2*>(a.dk + b * a.sdk_b + hk * a.sdk_h + s * a.sdk_s + c) = k2;
    *reinterpret_cast<uint2*>(a.dv + b * a.sdv_b + hk * a.sdv_h + s * a.sdv_s + c) = v2;
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// strides: (batch, head, row) of q, k, v, o, dout, dq, dk, dv in that order
template <int D, bool POS>
int launch(const void* q, const void* k, const void* v, Args a, int B,
           const long long* st, cudaStream_t stream) {
  using T = Tiles<D>;
  const int H = a.H, Hkv = a.H / a.G, S = a.S;
  // the owned operands in boxes of BR rows, the staged ones in boxes of BT
  CUtensorMap q_own, do_own, k_own, v_own, q_t, do_t, k_t, v_t;
  int r, unused;
  const void* dout = a.dout;
#define MAP(m, perm, ptr, heads, i, rows)                                            \
  if ((r = make_map(&m, &perm, ptr, D, S, heads, B, st[3 * i + 2], st[3 * i + 1], \
                    st[3 * i], rows)) != 0)                                        \
    return 1000 + r;
  MAP(q_own, a.perm_q, q, H, 0, BR)
  MAP(do_own, a.perm_do, dout, H, 4, BR)
  MAP(k_own, a.perm_k, k, Hkv, 1, BR)
  MAP(v_own, a.perm_v, v, Hkv, 2, BR)
  MAP(q_t, unused, q, H, 0, T::BT)
  MAP(do_t, unused, dout, H, 4, T::BT)
  MAP(k_t, unused, k, Hkv, 1, T::BT)
  MAP(v_t, unused, v, Hkv, 2, T::BT)
#undef MAP
  const int n_b = (S + BR - 1) / BR;
  // under positions, one word of kept-tile bits a 32 tiles of BT rows
  const int bits = POS ? 4 * ((S + 32 * T::BT - 1) / (32 * T::BT)) : 0;
  const int dq_smem = DqSmem<D>::SMEM + bits, dkdv_smem = DkdvSmem<D>::SMEM + bits;
  if ((r = set_smem(fa_bwd_dq_wgmma<D, POS>, dq_smem)) != 0) return r;
  fa_bwd_dq_wgmma<D, POS><<<dim3(B * H, n_b), NTH, dq_smem, stream>>>(
      q_own, do_own, k_t, v_t, a);
  if ((r = static_cast<int>(cudaGetLastError())) != 0) return r;
  if (a.n_split > 1) {
    if ((r = set_smem(fa_bwd_dkdv_wgmma<D, POS, true>, dkdv_smem)) != 0) return r;
    fa_bwd_dkdv_wgmma<D, POS, true>
        <<<dim3(B * Hkv, n_b, a.n_split), NTH, dkdv_smem, stream>>>(
            k_own, v_own, q_t, do_t, a);
    if ((r = static_cast<int>(cudaGetLastError())) != 0) return r;
    const long long n = (long long)B * Hkv * S * (D / 4);
    const long long want = (n + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
    fa_bwd_dkdv_sum<D><<<blocks, 256, 0, stream>>>(a, B);
    return static_cast<int>(cudaGetLastError());
  }
  if ((r = set_smem(fa_bwd_dkdv_wgmma<D, POS, false>, dkdv_smem)) != 0) return r;
  fa_bwd_dkdv_wgmma<D, POS, false><<<dim3(B * Hkv, n_b), NTH, dkdv_smem, stream>>>(
      k_own, v_own, q_t, do_t, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 at head dim 64, 80 or 128.  Every stride of a dimension longer than
// 1 a multiple of 8 elements and every tensor 16-byte aligned, which the
// caller checks.  strides: 24 values, (batch, head, row) of q, k, v, o,
// dout, dq, dk, dv in that order.  lse: the forward's L, f32 (B, H, SP) in
// log2 units; delta: f32 (B, H, SP) scratch; SP a multiple of 128 and at
// least S.  q_pos, k_pos, q_tab, k_tab, T64: the positions and their tables
// as flash_attention_wgmma_launch takes them, or null for index masks.
// n_split: 1, or a divisor of G over which each KV group's heads are split
// in the dkdv kernel, with part f32 (2, n_split, B, H / G, S, D) scratch.
// The dq kernel, then the dkdv kernel (and, split, the sum of its terms),
// on the stream.  Returns a cudaError_t, or 1000 + the CUresult of a
// tensor map that the CUDA driver refused.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, const float* lse, float* delta, int B, int H,
    int G, int S, int SP, int D, const long long* strides, float scale,
    int causal, int window, const int* q_pos, const int* k_pos,
    const int* q_tab, const int* k_tab, int T64, int n_split, float* part,
    void* stream) {
  if (G < 1 || H % G != 0 || S < 1 || SP % BR != 0 || SP < S ||
      reinterpret_cast<uintptr_t>(lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(delta) % 16 != 0 ||
      (q_pos == nullptr) != (k_pos == nullptr) ||
      (q_pos != nullptr && (q_tab == nullptr || k_tab == nullptr ||
                            T64 != (S + 63) / 64)) ||
      n_split < 1 || G % n_split != 0 || (n_split > 1 && part == nullptr) ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.o = static_cast<const bf*>(o);
  a.dout = static_cast<const bf*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf*>(dq);
  a.dk = static_cast<bf*>(dk);
  a.dv = static_cast<bf*>(dv);
  long long* dst[15] = {&a.so_b, &a.so_h, &a.so_s, &a.sdo_b, &a.sdo_h, &a.sdo_s,
                        &a.sdq_b, &a.sdq_h, &a.sdq_s, &a.sdk_b, &a.sdk_h, &a.sdk_s,
                        &a.sdv_b, &a.sdv_h, &a.sdv_s};
  for (int i = 0; i < 15; ++i) *dst[i] = strides[9 + i];
  a.H = H; a.G = G; a.S = S; a.SP = SP; a.causal = causal; a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.ps = PosArgs{q_pos, k_pos, reinterpret_cast<const int2*>(q_tab),
                 reinterpret_cast<const int2*>(k_tab), T64};
  a.n_split = n_split;
  a.part = part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pos = q_pos != nullptr;
  if (D == 64) return pos ? launch<64, true>(q, k, v, a, B, strides, st)
                          : launch<64, false>(q, k, v, a, B, strides, st);
  if (D == 80) return pos ? launch<80, true>(q, k, v, a, B, strides, st)
                          : launch<80, false>(q, k, v, a, B, strides, st);
  if (D == 128) return pos ? launch<128, true>(q, k, v, a, B, strides, st)
                           : launch<128, false>(q, k, v, a, B, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory a block takes at head dim D: which = 0 for dq, 1 for
// dkdv
extern "C" int flash_attention_bwd_wgmma_smem(int D, int which) {
  if (D == 64) return which ? DkdvSmem<64>::SMEM : DqSmem<64>::SMEM;
  if (D == 80 || D == 128) return which ? DkdvSmem<128>::SMEM : DqSmem<128>::SMEM;
  return 0;
}
