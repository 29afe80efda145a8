// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of the forward in
// flash_attention.cu / flash_attention_wgmma.cu, for causal, windowed, full
// and position-masked attention with GQA.
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention has
// no backward (no custom_vjp); the reference trains through plain jnp
// (src/repro/models/attention.py::_attend_chunk) differentiated by XLA.
// This kernel computes that gradient:
//   P = exp(S * scale - L),  L = m + log l per query row (the forward's max
//   and sum, recomputed here),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// where the sums over a KV group's G query heads give dK and dV.  A masked
// (query, key) pair has P = 0; a query row with no kept key has zero
// gradient.  In bf16, P is rounded to bf16 before P^T dO and dS before the
// two products with Q and K, as the forward rounds p before P V; Delta is
// taken from the forward's output O, so at bf16 it is rowsum(dO o O) of the
// rounded O and not sum(p * dP) (the plain version writes the same).
//
// Shapes: q, o, dO, dQ (B, H, S, D); k, v, dK, dV (B, Hkv, S, D); each given
// by (batch, head, row) strides with the last dimension contiguous.  L and
// Delta: f32 (B, H, S) scratch (the bf16 kernels keep L in log2 units and
// use exp2; a tile whose pairs are all kept skips the mask).  q_pos, k_pos: (B, S) int32 or null (the
// row index); with either, every tile is visited and the masks compare
// positions, as the forward's.
//
// What bounds it on this card: operations.  Five S x S x D products per
// (b, head) (S, dP, dV, dK, dQ), seven with the recomputation below, at
// ~S/2 flops per byte at S = 2048.
//
// Design: two kernels, no atomics, so the result is the same from run to run.
//  1. dq: one block per (64 query rows, b, head).  Pass 1 walks the key
//     tiles the rows can see and recomputes (m, l) online, giving L; Delta
//     comes from O and dO; both are written for kernel 2.  Pass 2 walks them
//     again: S, P, dP = dO V^T, dS, and dQ += dS K.
//  2. dkdv: one block per (64 key rows, b, KV head).  It loops over the G
//     query heads of the group and the query tiles that can see its keys,
//     recomputing S^T = K Q^T and dP^T = V dO^T, and accumulates
//     dV += P^T dO and dK += dS^T Q in registers, summed over the group.
// bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulators, the FA2
// fragment layout of fa_mma): each warp owns 16 rows of the block, the
// other operand's tiles of 32 rows are staged in shared memory (rows padded
// by 16 bytes) in two stages, the next copied with cp.async while the
// block computes on this one, and read as B fragments directly or through
// ldmatrix.trans.
// f32 runs on the CUDA cores as fa_fwd: 256 threads, thread (ty, tx) owns
// rows 4 ty .. 4 ty + 3 and columns tx + 16 j of each 64 x 64 tile.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BR = 64;  // rows a block owns (queries in dq, keys in dkdv)

struct Strides {
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *L, *delta;  // (B, H, S)
  const int *q_pos, *k_pos;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, G, S, causal, window;
  float scale;
};

__device__ __forceinline__ int qpos(const Args& a, int b, int i) {
  return a.q_pos != nullptr ? a.q_pos[(long long)b * a.S + i] : i;
}
__device__ __forceinline__ int kpos(const Args& a, int b, int j) {
  return a.k_pos != nullptr ? a.k_pos[(long long)b * a.S + j] : j;
}
// the reference's mask on positions (valid rows only)
__device__ __forceinline__ bool keep(const Args& a, int qp, int kp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
}

// key tiles [kt0, kt1) of width W that query rows [q0, q1] can see
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int q1, int W,
                                          int& kt0, int& kt1) {
  kt0 = 0;
  kt1 = (a.S + W - 1) / W;
  if (a.q_pos != nullptr || a.k_pos != nullptr) return;
  if (a.causal) kt1 = q1 / W + 1;
  if (a.window > 0) {
    const int k_min = q0 - a.window + 1;
    kt0 = k_min > 0 ? k_min / W : 0;
  }
}

// every (query, key) pair of rows [q0, q0 + nq) x keys [k0, k0 + nk) is
// kept, so a tile needs no mask (index masks only)
__device__ __forceinline__ bool all_kept(const Args& a, int q0, int nq,
                                         int k0, int nk) {
  if (a.q_pos != nullptr || a.k_pos != nullptr) return false;
  if (q0 + nq > a.S || k0 + nk > a.S) return false;
  if (a.causal && k0 + nk - 1 > q0) return false;
  return a.window <= 0 || k0 > q0 + nq - 1 - a.window;
}

// query tiles [qt0, qt1) of width W that can see keys [k0, k1]
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int k1,
                                            int W, int& qt0, int& qt1) {
  qt0 = 0;
  qt1 = (a.S + W - 1) / W;
  if (a.q_pos != nullptr || a.k_pos != nullptr) return;
  if (a.causal) qt0 = k0 / W;
  if (a.window > 0) {
    const int q_max = k1 + a.window - 1;
    qt1 = min(qt1, q_max / W + 1);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MW = 4;   // warps a block
constexpr int BT = 32;  // rows of the staged tiles (keys in dq, queries in dkdv)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of a product whose B operand is M (rows k, columns n), M row
// major in shared memory: lanes 0-15 address rows k0 + (lane & 15)
__device__ __forceinline__ void ldsm_trans(uint32_t& b0, uint32_t& b1,
                                           const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int n,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (n == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// R rows of a (S, D) bf16 matrix from row0, row stride rs, into dst[r][D + 8]
// by cp.async, 16 bytes a copy, zero past S
template <int D, int R>
__device__ __forceinline__ void issue_rows16(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long rs, int row0, int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += MW * 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int s = row0 + r;
    cp_async(dst + r * (D + 8) + c, s < S ? src + (long long)s * rs + c : src,
             16, s < S);
  }
}

// R rows of a (S, D) bf16 matrix from row0, row stride rs, into dst[r][D + 8],
// 16 bytes a load, zero past S
template <int D, int R>
__device__ __forceinline__ void load_rows16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long rs, int row0, int S) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < R * CH; i += MW * 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) v = *reinterpret_cast<const uint4*>(src + (long long)s * rs + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

// rows r, r + 8 (r = row0 + g) of a (S, D) matrix as A fragments, zero past S
template <int D>
__device__ __forceinline__ void a_frags(uint32_t (*f)[4],
                                        const __nv_bfloat16* src, long long rs,
                                        int ra, int S, int tig) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
    auto ld = [&](int r, int cc) -> uint32_t {
      return r < S ? ld32(src + (long long)r * rs + cc) : 0u;
    };
    f[ks][0] = ld(ra, c);
    f[ks][1] = ld(ra + 8, c);
    f[ks][2] = ld(ra, c + 8);
    f[ks][3] = ld(ra + 8, c + 8);
  }
}

template <int D>
__global__ void __launch_bounds__(MW * 32) fa_bwd_dq_mma(Args a) {
  using bf = __nv_bfloat16;
  constexpr int RS = D + 8, KD = D / 16, ND = D / 8, NK = BT / 8;
  // two stages of the staged tiles: tile i + 1 is copied (cp.async) while
  // tile i is computed on
  __shared__ __align__(16) bf Ks[2][BT * RS];
  __shared__ __align__(16) bf Vs[2][BT * RS];

  const int S = a.S, H = a.H;
  const int n_q = (S + BR - 1) / BR;
  const int qt = n_q - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, hk = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * BR;
  const int ra = q0 + warp * 16 + g;  // this thread's rows: ra, ra + 8

  const bf* qb = static_cast<const bf*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const bf* ob = static_cast<const bf*>(a.o) + b * a.so.b + h * a.so.h;
  const bf* db = static_cast<const bf*>(a.dout) + b * a.sdo.b + h * a.sdo.h;

  uint32_t qf[KD][4], df[KD][4];
  a_frags<D>(qf, qb, a.sq.s, ra, S, tig);
  a_frags<D>(df, db, a.sdo.s, ra, S, tig);
  int qp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ra + 8 * hf;
    qp[hf] = r < S ? qpos(a, b, r) : 0;
  }
  int kt0, kt1;
  key_tiles(a, q0, min(q0 + BR, S) - 1, BT, kt0, kt1);

  // S = Q K^T for one staged tile in log2 units (scale * log2 e), masked:
  // element e of tile nt is row ra + 8 (e / 2), key k0 + nt * 8 + 2 tig +
  // e % 2; masked entries -inf.  A tile wholly kept skips the mask.
  const float sl2 = a.scale * LOG2E;
  auto scores = [&](float (*s)[4], int k0, const bf* Kt) {
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const bf* kr = Kt + (nt * 8 + g) * RS + ks * 16 + tig * 2;
        mma_bf16(s[nt], qf[ks], ld32(kr), ld32(kr + 8));
      }
    if (all_kept(a, q0, BR, k0, BT)) {
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= sl2;
      return;
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ra + 8 * (e >> 1), kj = k0 + nt * 8 + tig * 2 + (e & 1);
        const bool ok = r < S && kj < S && keep(a, qp[e >> 1], kpos(a, b, kj));
        s[nt][e] = ok ? s[nt][e] * sl2 : -CUDART_INF_F;
      }
  };

  // pass 1: the row max and sum over the kept keys
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  if (kt0 < kt1) issue_rows16<D, BT>(Ks[0], kb, a.sk.s, kt0 * BT, S);
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BT, buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) issue_rows16<D, BT>(Ks[buf ^ 1], kb, a.sk.s, k0 + BT, S);
    cp_async_commit();
    cp_async_wait1();  // tile kt has landed
    __syncthreads();
    float s[NK][4];
    scores(s, k0, Ks[buf]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);  // >= NEG_INF: never -inf
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
        ps += exp2f(s[nt][2 * hf] - m_new) + exp2f(s[nt][2 * hf + 1] - m_new);
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[hf] = exp2f(m[hf] - m_new) * l[hf] + ps;
      m[hf] = m_new;
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  // L (log2 units) and Delta of rows ra and ra + 8; the quad's 4 lanes
  // hold D / 4 columns of each row in their dO fragments
  float Lr[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) Lr[hf] = l[hf] > 0.f ? m[hf] + log2f(l[hf]) : 0.f;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hf = j & 1, r = ra + 8 * hf;
      const int c = ks * 16 + tig * 2 + 8 * (j >> 1);
      if (r < S) {
        const float2 dv = unpack_bf16(df[ks][j]);
        const float2 ov = unpack_bf16(ld32(ob + (long long)r * a.so.s + c));
        dl[hf] += dv.x * ov.x + dv.y * ov.y;
      }
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 1);
    dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 2);
    const int r = ra + 8 * hf;
    if (tig == 0 && r < S) {
      a.L[(long long)bh * S + r] = Lr[hf];
      a.delta[(long long)bh * S + r] = dl[hf];
    }
  }

  // pass 2: dQ += dS K
  float dq[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
  if (kt0 < kt1) {
    issue_rows16<D, BT>(Ks[0], kb, a.sk.s, kt0 * BT, S);
    issue_rows16<D, BT>(Vs[0], vb, a.sv.s, kt0 * BT, S);
  }
  cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BT, buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      issue_rows16<D, BT>(Ks[buf ^ 1], kb, a.sk.s, k0 + BT, S);
      issue_rows16<D, BT>(Vs[buf ^ 1], vb, a.sv.s, k0 + BT, S);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    float s[NK][4], dp[NK][4];
    scores(s, k0, Ks[buf]);
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const bf* vr = Vs[buf] + (nt * 8 + g) * RS + ks * 16 + tig * 2;
        mma_bf16(dp[nt], df[ks], ld32(vr), ld32(vr + 8));
      }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - Lr[e >> 1]);  // 0 where masked
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      uint32_t af[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                        pack_bf16(s[2 * j][2], s[2 * j][3]),
                        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const bf* kr = Ks[buf] + (j * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        ldsm_trans(b0, b1, kr + nd * 8);
        mma_bf16(dq[nd], af, b0, b1);
      }
    }
    __syncthreads();
  }

  bf* out = static_cast<bf*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ra + 8 * hf;
    if (r >= S) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(out + (long long)r * a.sdq.s + nd * 8 + tig * 2) =
          pack_bf16(dq[nd][2 * hf] * a.scale, dq[nd][2 * hf + 1] * a.scale);
  }
}

template <int D> struct DkdvSmem {
  static constexpr int RS = D + 8;
  // K, V (64 rows), two stages of Q, dO (32 rows) in bf16, then two of L
  // and Delta (32 f32 each)
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * (2 * BR + 4 * BT) * RS +
                                  sizeof(float) * 4 * BT;
};

template <int D>
__global__ void __launch_bounds__(MW * 32) fa_bwd_dkdv_mma(Args a) {
  using bf = __nv_bfloat16;
  constexpr int RS = D + 8, KD = D / 16, ND = D / 8, NQ = BT / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf* Ks = reinterpret_cast<bf*>(smem_raw);
  bf* Vs = Ks + BR * RS;
  bf* Qs0 = Vs + BR * RS;       // [2][BT * RS]
  bf* dO0 = Qs0 + 2 * BT * RS;  // [2][BT * RS]
  float* Ls0 = reinterpret_cast<float*>(dO0 + 2 * BT * RS);  // [2][BT]
  float* Dl0 = Ls0 + 2 * BT;                                  // [2][BT]

  const int S = a.S, H = a.H, G = a.G, Hkv = H / G;
  const int k0 = blockIdx.x * BR;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk - b * Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16 + g;  // this thread's key rows in the block: wr, wr + 8
  const int ka = k0 + wr;

  const bf* kb = static_cast<const bf*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_rows16<D, BR>(Ks, kb, a.sk.s, k0, S);
  load_rows16<D, BR>(Vs, vb, a.sv.s, k0, S);
  int kp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ka + 8 * hf;
    kp[hf] = r < S ? kpos(a, b, r) : 0;
  }
  int qt0, qt1;
  query_tiles(a, k0, min(k0 + BR, S) - 1, BT, qt0, qt1);
  const float sl2 = a.scale * LOG2E;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  // one walk over (query head of the group, query tile), the next tile's
  // Q, dO, L and Delta copied (cp.async) while this one is computed on
  const int n_qt = qt1 - qt0, n_it = G * n_qt;
  auto issue = [&](int it, int buf) {
    const int h = hk * G + it / n_qt, q0 = (qt0 + it % n_qt) * BT;
    const long long bh = (long long)b * H + h;
    issue_rows16<D, BT>(Qs0 + buf * BT * RS, static_cast<const bf*>(a.q) +
                        b * a.sq.b + h * a.sq.h, a.sq.s, q0, S);
    issue_rows16<D, BT>(dO0 + buf * BT * RS, static_cast<const bf*>(a.dout) +
                        b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, S);
    const int t = threadIdx.x & (BT - 1), r = q0 + t;
    if (threadIdx.x < 2 * BT) {
      const float* src = threadIdx.x < BT ? a.L : a.delta;
      float* dst = (threadIdx.x < BT ? Ls0 : Dl0) + buf * BT + t;
      cp_async(dst, r < S ? src + bh * S + r : src, 4, r < S);
    }
  };
  if (n_it > 0) issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) issue(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    {
      const int q0 = (qt0 + it % n_qt) * BT;
      const bf* Qs = Qs0 + buf * BT * RS;
      const bf* Ds_ = dO0 + buf * BT * RS;  // dO
      const float* Ls = Ls0 + buf * BT;
      const float* Dl = Dl0 + buf * BT;

      // S^T = K Q^T and dP^T = V dO^T over 16 keys x 32 queries
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        const int c = ks * 16 + tig * 2;
        const uint32_t kf[4] = {ld32(Ks + wr * RS + c), ld32(Ks + (wr + 8) * RS + c),
                                ld32(Ks + wr * RS + c + 8),
                                ld32(Ks + (wr + 8) * RS + c + 8)};
        const uint32_t vf[4] = {ld32(Vs + wr * RS + c), ld32(Vs + (wr + 8) * RS + c),
                                ld32(Vs + wr * RS + c + 8),
                                ld32(Vs + (wr + 8) * RS + c + 8)};
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          const bf* qr = Qs + (nt * 8 + g) * RS + c;
          mma_bf16(st[nt], kf, ld32(qr), ld32(qr + 8));
          const bf* dr = Ds_ + (nt * 8 + g) * RS + c;
          mma_bf16(dpt[nt], vf, ld32(dr), ld32(dr + 8));
        }
      }
      // P^T and dS^T: element e of tile nt is key ka + 8 (e / 2), query
      // q0 + nt * 8 + 2 tig + e % 2; L in log2 units.  A tile wholly kept
      // skips the mask.
      const bool full = all_kept(a, q0, BT, k0, BR);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = ka + 8 * (e >> 1), qc = nt * 8 + tig * 2 + (e & 1);
          const int qi = q0 + qc;
          const bool ok = full || (kr < S && qi < S &&
                                   keep(a, qpos(a, b, qi), kp[e >> 1]));
          const float p = ok ? exp2f(st[nt][e] * sl2 - Ls[qc]) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - Dl[qc]);
        }
      // dV += P^T dO and dK += dS^T Q, over the tile's 32 queries
#pragma unroll
      for (int j = 0; j < BT / 16; ++j) {
        const uint32_t pf[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]),
                                pack_bf16(st[2 * j][2], st[2 * j][3]),
                                pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                                pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t sf[4] = {pack_bf16(dpt[2 * j][0], dpt[2 * j][1]),
                                pack_bf16(dpt[2 * j][2], dpt[2 * j][3]),
                                pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                                pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
        const bf* dr = Ds_ + (j * 16 + (lane & 15)) * RS;
        const bf* qr = Qs + (j * 16 + (lane & 15)) * RS;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t b0, b1;
          ldsm_trans(b0, b1, dr + nd * 8);
          mma_bf16(dv[nd], pf, b0, b1);
          ldsm_trans(b0, b1, qr + nd * 8);
          mma_bf16(dk[nd], sf, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  bf* dko = static_cast<bf*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  bf* dvo = static_cast<bf*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ka + 8 * hf;
    if (r >= S) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dko + (long long)r * a.sdk.s + c) =
          pack_bf16(dk[nd][2 * hf] * a.scale, dk[nd][2 * hf + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvo + (long long)r * a.sdv.s + c) =
          pack_bf16(dv[nd][2 * hf], dv[nd][2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int NT = 256;  // threads a block
constexpr int RPT = 4;   // rows a thread
constexpr int TX = 16;   // threads across a row

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D> struct F32 {
  static constexpr int QS = D + 4;   // row stride of the (64, D) tiles
  static constexpr int PS = BR + 4;  // row stride of the (64, 64) tiles
  static constexpr int DC = D / TX;  // output columns a thread
  // dq: Q, dO, K, V tiles and dS; dkdv: K, V, Q, dO tiles, P, dS, L, Delta
  static constexpr size_t dq_bytes = sizeof(float) * (4 * BR * QS + BR * PS);
  static constexpr size_t dkdv_bytes = sizeof(float) * (4 * BR * QS + 2 * BR * PS + 2 * BR);
};

// rows [row0, row0 + 64) of a (S, D) matrix, row stride rs, zero past S
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long rs, int row0, int S) {
  for (int i = threadIdx.x; i < BR * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int s = row0 + r;
    dst[r * F32<D>::QS + d] = s < S ? src[(long long)s * rs + d] : 0.f;
  }
}

// out[i][j] = A[4 ty + i] . Bm[tx + 16 j] over D
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm,
                                         float (*out)[RPT], int ty, int tx) {
  constexpr int QS = F32<D>::QS;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RPT], bv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty * RPT + i) * QS + d]);
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bm[(tx + TX * j) * QS + d]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        out[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                     av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_j P[4 ty + i][j] * M[j][tx + 16 c], j over 64 rows
template <int D>
__device__ __forceinline__ void acc_tile(const float* P, const float* M,
                                         float (*acc)[D / TX], int ty, int tx) {
  constexpr int PS = F32<D>::PS, QS = F32<D>::QS, DC = D / TX;
#pragma unroll 2
  for (int j = 0; j < BR; j += 4) {
    float4 pv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&P[(ty * RPT + i) * PS + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float mv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) mv[c] = M[(j + jj) * QS + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                      : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * mv[c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) fa_bwd_dq_f32(Args a) {
  using L = F32<D>;
  constexpr int QS = L::QS, PS = L::PS, DC = L::DC;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* dOs = Qs + BR * QS;
  float* Ks = dOs + BR * QS;
  float* Vs = Ks + BR * QS;
  float* Ps = Vs + BR * QS;  // dS

  const int S = a.S, H = a.H;
  const int n_q = (S + BR - 1) / BR;
  const int qt = n_q - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, hk = h / a.G;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = qt * BR;

  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + hk * a.sv.h;
  const float* ob = static_cast<const float*>(a.o) + b * a.so.b + h * a.so.h;
  const float* db = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  load_f32<D>(Qs, qb, a.sq.s, q0, S);
  load_f32<D>(dOs, db, a.sdo.s, q0, S);
  int qp[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    qp[i] = r < S ? qpos(a, b, r) : 0;
  }
  int kt0, kt1;
  key_tiles(a, q0, min(q0 + BR, S) - 1, BR, kt0, kt1);

  auto masked = [&](float (*s)[RPT], int k0) {
    int kpv[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int kj = k0 + tx + TX * j;
      kpv[j] = kj < S ? kpos(a, b, kj) : 0;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const bool ok = q0 + ty * RPT + i < S && k0 + tx + TX * j < S &&
                        keep(a, qp[i], kpv[j]);
        s[i][j] = ok ? s[i][j] * a.scale : -CUDART_INF_F;
      }
  };

  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    load_f32<D>(Ks, kb, a.sk.s, k0, S);
    __syncthreads();
    float s[RPT][RPT];
    dot_tile<D>(Qs, Ks, s, ty, tx);
    masked(s, k0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RPT; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) ps += expf(s[i][j] - m_new);
      l[i] = expf(m[i] - m_new) * l[i] + row_sum(ps);
      m[i] = m_new;
    }
  }

  float Lr[RPT], dl[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    Lr[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    float x = 0.f;
    if (r < S)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        x += dOs[(ty * RPT + i) * QS + tx + TX * c] *
             ob[(long long)r * a.so.s + tx + TX * c];
    dl[i] = row_sum(x);
    if (tx == 0 && r < S) {
      a.L[(long long)bh * S + r] = Lr[i];
      a.delta[(long long)bh * S + r] = dl[i];
    }
  }

  float dq[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // the previous tile's dS and K are no longer read
    load_f32<D>(Ks, kb, a.sk.s, k0, S);
    load_f32<D>(Vs, vb, a.sv.s, k0, S);
    __syncthreads();
    float s[RPT][RPT], dp[RPT][RPT];
    dot_tile<D>(Qs, Ks, s, ty, tx);
    dot_tile<D>(dOs, Vs, dp, ty, tx);
    masked(s, k0);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float p = expf(s[i][j] - Lr[i]);
        Ps[(ty * RPT + i) * PS + tx + TX * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    acc_tile<D>(Ps, Ks, dq, ty, tx);
  }

  float* out = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      out[(long long)r * a.sdq.s + tx + TX * c] = dq[i][c] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT) fa_bwd_dkdv_f32(Args a) {
  using L = F32<D>;
  constexpr int QS = L::QS, PS = L::PS, DC = L::DC;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + BR * QS;
  float* Qs = Vs + BR * QS;
  float* dOs = Qs + BR * QS;
  float* Ps = dOs + BR * QS;
  float* dSs = Ps + BR * PS;
  float* Ls = dSs + BR * PS;
  float* Dl = Ls + BR;

  const int S = a.S, H = a.H, G = a.G, Hkv = H / G;
  const int k0 = blockIdx.x * BR;
  const int bhk = blockIdx.y;
  const int b = bhk / Hkv, hk = bhk - b * Hkv;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;

  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + hk * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + hk * a.sv.h;
  load_f32<D>(Ks, kb, a.sk.s, k0, S);
  load_f32<D>(Vs, vb, a.sv.s, k0, S);
  int kp[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = k0 + ty * RPT + i;
    kp[i] = r < S ? kpos(a, b, r) : 0;
  }
  int qt0, qt1;
  query_tiles(a, k0, min(k0 + BR, S) - 1, BR, qt0, qt1);

  float dk[RPT][DC], dv[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    const long long bh = (long long)b * H + h;
    const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
    const float* db = static_cast<const float*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BR;
      __syncthreads();
      load_f32<D>(Qs, qb, a.sq.s, q0, S);
      load_f32<D>(dOs, db, a.sdo.s, q0, S);
      if (tid < BR) {
        const int r = q0 + tid;
        Ls[tid] = r < S ? a.L[bh * S + r] : 0.f;
        Dl[tid] = r < S ? a.delta[bh * S + r] : 0.f;
      }
      __syncthreads();
      float st[RPT][RPT], dpt[RPT][RPT];
      dot_tile<D>(Ks, Qs, st, ty, tx);
      dot_tile<D>(Vs, dOs, dpt, ty, tx);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int qc = tx + TX * j, qi = q0 + qc;
        const int qpj = qi < S ? qpos(a, b, qi) : 0;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const bool ok = k0 + ty * RPT + i < S && qi < S && keep(a, qpj, kp[i]);
          const float p = ok ? expf(st[i][j] * a.scale - Ls[qc]) : 0.f;
          Ps[(ty * RPT + i) * PS + qc] = p;
          dSs[(ty * RPT + i) * PS + qc] = p * (dpt[i][j] - Dl[qc]);
        }
      }
      __syncthreads();
      acc_tile<D>(Ps, dOs, dv, ty, tx);
      acc_tile<D>(dSs, Qs, dk, ty, tx);
    }
  }

  float* dko = static_cast<float*>(a.dk) + b * a.sdk.b + hk * a.sdk.h;
  float* dvo = static_cast<float*>(a.dv) + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = k0 + ty * RPT + i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dko[(long long)r * a.sdk.s + tx + TX * c] = dk[i][c] * a.scale;
      dvo[(long long)r * a.sdv.s + tx + TX * c] = dv[i][c];
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <int D>
int launch(int dtype, const Args& a, int B, cudaStream_t st) {
  const int n_t = (a.S + BR - 1) / BR;
  const dim3 grid_q(n_t, B * a.H), grid_k(n_t, B * (a.H / a.G));
  int err;
  if (dtype == 1) {
    fa_bwd_dq_mma<D><<<grid_q, MW * 32, 0, st>>>(a);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    if ((err = set_smem(fa_bwd_dkdv_mma<D>, DkdvSmem<D>::bytes)) != 0) return err;
    fa_bwd_dkdv_mma<D><<<grid_k, MW * 32, DkdvSmem<D>::bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((err = set_smem(fa_bwd_dq_f32<D>, F32<D>::dq_bytes)) != 0) return err;
  fa_bwd_dq_f32<D><<<grid_q, NT, F32<D>::dq_bytes, st>>>(a);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  if ((err = set_smem(fa_bwd_dkdv_f32<D>, F32<D>::dkdv_bytes)) != 0) return err;
  fa_bwd_dkdv_f32<D><<<grid_k, NT, F32<D>::dkdv_bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every stride a multiple of 8 elements
// and every pointer 16-byte aligned, which the caller checks).  strides: 24
// values, (batch, head, row) of q, k, v, o, dout, dq, dk, dv in that order.
// L, delta: (B, H, S) f32 scratch.  q_pos, k_pos: (B, S) int32 or null.
// Two kernels run in order on the stream; a head dim not built here
// returns cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* L, float* delta,
    const int* q_pos, const int* k_pos, int B, int H, int G, int S, int D,
    const long long* strides, float scale, int causal, int window,
    void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.dq = dq; a.dk = dk; a.dv = dv; a.L = L; a.delta = delta;
  a.q_pos = q_pos; a.k_pos = k_pos;
  Strides* ss[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    *ss[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.H = H; a.G = G; a.S = S; a.causal = causal; a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || H % G != 0 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {  // the head dims of flash_attention.HEAD_DIMS
    case 16: return launch<16>(dtype, a, B, st);
    case 32: return launch<32>(dtype, a, B, st);
    case 64: return launch<64>(dtype, a, B, st);
    case 80: return launch<80>(dtype, a, B, st);
    case 96: return launch<96>(dtype, a, B, st);
    case 128: return launch<128>(dtype, a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
