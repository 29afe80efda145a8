// Decode attention for Hopper (sm_90a): one query row per (b, h) against a
// KV cache masked at kv_len[b], f32 online softmax, scale 1/sqrt(D).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention (body _dec_kernel).
// Shapes: q (B, H, D); k, v (B, Hkv, L, D) given by strides (the model hands
// in its (B, L, Hkv, D) cache as a permuted view, nothing is copied);
// kv_len (B,) int32; optional kv_start (B,) int32, so row b attends over
// cache rows [kv_start[b], kv_len[b]) (the reference's decode mask under
// given positions; an empty range gives 0); out (B, H, D) contiguous, in
// q's dtype.  Query head h
// reads KV head h / G with G = H / Hkv; G = 1 is the TPU kernel's function.
// G may be up to 16 (qwen3-moe's 64 heads over 4): each kernel is built for
// a group bound GB of 8 and of 16, and the launch takes the smaller that
// holds G, so a group of 8 or fewer keeps the GB = 8 code and registers.
// Scores, softmax and the P.V sum are f32; the output is cast at the end.
//
// What bounds it on this card: bytes.  Each valid cache row is read once
// (K and V: 2*D*2 bytes a row in bf16) and does 4*G*D flops, far below the
// ~295 flops a byte where the tensor cores would be the limit.  At B=16,
// Hkv=8, D=128, L=4096 that is 268 MB, 0.080 ms at 3.35 TB/s.  To stream at
// that rate the card needs megabytes in flight and almost no work per byte
// on the side: a warp-shuffle reduction per row and per head (the first
// version's) costs more than the bytes.
//
// Design.  The grid is (splits, Hkv, B).  A block of 4 warps takes one split
// of the cache rows of one KV head and serves all G query heads of it, so K
// and V are read once per group.  The wrapper's ``split_plan`` sets the
// split: one block an SM, none moving less than 256 KB.  Each warp walks its own tiles of the split (tile w, w + 4, ...),
// streaming K and V rows 16 bytes a lane (8 bf16 or 4 f32) into its own ring
// of stages in shared memory with cp.async, the next tiles in flight while
// it computes one.  Rows at or past kv_len are never read: their copies are
// zero-fills, and their scores are masked.  Each warp keeps its own online
// (m, l, acc) in registers (m in log2 units, exp2 of scores scaled by
// log2(e)/sqrt(D)); no score goes through shared memory and no barrier
// waits on a row.
// - dec_mma (bf16) computes a tile of 16 rows on the tensor cores; see its
//   note below.  Three stages of 8.5 KB a warp, two tiles in flight while
//   it computes one: 64 KB an SM at the one block an SM the plan gives.
// - dec_split (f32) runs on the CUDA cores: D / 4 lanes share a row, each
//   holding 4 columns of it and of the q of every head; a score is reduced
//   over those lanes by shuffles, and a lane group updates its (m, l, acc)
//   once per 4 rows.  A lane reads back only the chunks it copied, so its
//   ring needs no barrier.
// - Merges (``finish``): the warps merge once through shared memory.  With
//   one split the block writes the output.  Otherwise it writes its (m, l,
//   acc) to f32 scratch, and the last block of each (b, hk) to finish (an
//   atomic counter after __threadfence) merges all splits, parallel over
//   (g, d), out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
//   w_s = 2^(m_s - max m), and sets the counter back to 0: one launch.
// - The log-sum-exp (optional, ``lse`` non-null): f32 (B, H), ln of the sum
//   of exp(scale * q.k) over the attended rows, m ln 2 + ln l from the
//   (m, l) the merge already holds; -inf for an empty range.  A caller that
//   splits the cache rows over ranks merges the ranks' outputs with it.
//   Without it (null, the default) the kernel writes nothing more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;      // warps a block
constexpr int NS = 4;      // stages of each warp's ring in dec_split
constexpr int NRG = 4;     // rows a lane group takes from each tile in dec_split
constexpr int MAX_G = 16;  // query heads per KV head: the larger group bound
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the four f32 values of a 16-byte chunk
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// 16 bytes from global to shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int LPR, int CPL> struct Cfg {
  static constexpr int RPW = 32 / LPR;          // rows a warp holds at a time
  static constexpr int TR = NRG * RPW;          // rows a tile
  static constexpr int EPC = 4;                 // f32 values a 16-byte chunk
  static constexpr int E = CPL * EPC;           // values a lane holds of a row
  static constexpr int D = LPR * E;             // head dim
  static constexpr int SLOTS = NRG * CPL;       // chunks a lane copies of K (of V) a tile
  static constexpr int STAGE = 2 * SLOTS * 32 * 16;  // bytes of a warp's stage
  static constexpr int SMEM = NW * NS * STAGE;
};

// a block's shared memory: the ring, or more where the merges need it (the
// warps' partials, the splits' weights), for GB heads a row
size_t merge_smem(size_t ring, int D, int n_split, int GB) {
  const size_t warps = sizeof(float) * (2 * NW * GB + NW * GB * (size_t)D);
  const size_t splits = sizeof(float) * (GB * (size_t)n_split + GB);
  return ring > warps ? (ring > splits ? ring : splits) : (warps > splits ? warps : splits);
}

// The end of a block, shared by both kernels.  Each warp has left its
// partial in shared memory: m (log2 units) at wm[w][g], l at wm[NW + w][g],
// acc at wm[2 NW][w][g][d], with GB heads a row.  ``rows`` says whether
// the block's split held a valid row.  The warps merge; with one split the
// block writes the output, otherwise its split's (m, l, acc), and the last
// block of (b, hk) to finish merges every split and resets its counter.
template <typename T, int D, int GB>
__device__ __forceinline__ void finish(uint8_t* smem, bool rows, T* out,
                                       float* lse, float* m_part, float* l_part,
                                       float* acc_part, unsigned* counters,
                                       int G, int n_split, int split,
                                       long long head0, int b, int hk) {
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wm = reinterpret_cast<float*>(smem);
  if (rows) {
    __syncthreads();
    const float* wl = wm + NW * GB;
    const float* wacc = wm + 2 * NW * GB;
    for (int i = threadIdx.x; i < G * D; i += NW * 32) {
      const int g = i / D, d = i - g * D;
      float mm = wm[g];
#pragma unroll
      for (int w = 1; w < NW; ++w) mm = fmaxf(mm, wm[w * GB + g]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = exp2f(wm[w * GB + g] - mm);
        den += f * wl[w * GB + g];
        num += f * wacc[(w * GB + g) * D + d];
      }
      const long long bh = head0 + g;
      if (n_split == 1) {
        out[bh * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
        if (lse != nullptr && d == 0) lse[bh] = mm * LN2 + logf(den);
      } else {
        acc_part[(bh * n_split + split) * D + d] = num;
        if (d == 0) {
          m_part[bh * n_split + split] = mm;
          l_part[bh * n_split + split] = den;
        }
      }
    }
  } else if (n_split == 1) {  // kv_len 0: no row to attend to
    for (int i = threadIdx.x; i < G * D; i += NW * 32) out[head0 * D + i] = from_f<T>(0.f);
    if (lse != nullptr && threadIdx.x < G) lse[head0 + threadIdx.x] = -CUDART_INF_F;
  } else if (threadIdx.x < G) {  // this split lies wholly past kv_len
    m_part[(head0 + threadIdx.x) * n_split + split] = -CUDART_INF_F;
    l_part[(head0 + threadIdx.x) * n_split + split] = 0.f;
  }
  if (n_split == 1) return;

  __threadfence();
  __syncthreads();
  unsigned* counter = counters + (long long)b * gridDim.y + hk;
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* wsm = wm;                 // [GB][n_split] weights
  float* den = wsm + GB * n_split;  // [GB]
  for (int g = warp; g < G; g += NW) {
    const long long base = (head0 + g) * n_split;
    float mm = -CUDART_INF_F;
    for (int s = lane; s < n_split; s += 32) mm = fmaxf(mm, __ldcg(m_part + base + s));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float dsum = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float ms = __ldcg(m_part + base + s);
      const float w = ms > -CUDART_INF_F ? exp2f(ms - mm) : 0.f;
      wsm[g * n_split + s] = w;
      dsum += w * __ldcg(l_part + base + s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (lane == 0) {
      den[g] = fmaxf(dsum, 1e-30f);
      // every split empty: mm = -inf, dsum = 0
      if (lse != nullptr) lse[head0 + g] = dsum > 0.f ? mm * LN2 + logf(dsum) : -CUDART_INF_F;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D, d = i - g * D;
    const long long bh = head0 + g;
    float o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = wsm[g * n_split + s];
      if (w != 0.f) o += w * __ldcg(acc_part + (bh * n_split + s) * D + d);
    }
    out[bh * D + d] = from_f<T>(o / den[g]);
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

template <int LPR, int CPL, int GB>
__global__ void __launch_bounds__(NW * 32)
dec_split(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const int* __restrict__ kv_len,
          const int* __restrict__ kv_start, float* __restrict__ out,
          float* __restrict__ lse, float* __restrict__ m_part,
          float* __restrict__ l_part, float* __restrict__ acc_part,
          unsigned* __restrict__ counters, int H, int G, int L, int chunk,
          int n_split, long long qsb, long long qsh, long long ksb,
          long long ksh, long long ksl, long long vsb, long long vsh,
          long long vsl, float scale_log2) {
  using C = Cfg<LPR, CPL>;
  constexpr int D = C::D, E = C::E, EPC = C::EPC;
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int len = min(kv_len[b], L);
  // rows [kv_start[b], len) are attended to; this split holds [start, start + n)
  const int start = max(split * chunk, kv_start != nullptr ? kv_start[b] : 0);
  const int n = min(split * chunk + chunk, len) - start;
  const long long head0 = (long long)b * H + (long long)hk * G;  // (b, h) of g = 0
  auto col = [&](int c) { return (sub + c * LPR) * EPC; };  // chunk c's first column

  if (n > 0) {
    float qv[GB][E];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          qv[g][c * EPC + e] =
              g < G ? q[b * qsb + (hk * G + g) * qsh + col(c) + e] : 0.f;
    float m[GB], l[GB], acc[GB][E];  // (m, l) in log2 units
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }

    const float* kb = k + b * ksb + hk * ksh + (long long)start * ksl;
    const float* vb = v + b * vsb + hk * vsh + (long long)start * vsl;
    const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                          warp * NS * C::STAGE;
    auto slot = [&](int stage, int kv, int s) {  // this lane's 16 bytes
      return ring + stage * C::STAGE + kv * (C::STAGE / 2) + (s * 32 + lane) * 16;
    };
    const int n_tiles = (n + C::TR - 1) / C::TR;
    const int mine = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
    auto issue = [&](int i) {  // the warp's i-th tile: tile warp + i * NW
      const int r0 = (warp + i * NW) * C::TR + grp;
#pragma unroll
      for (int j = 0; j < NRG; ++j) {
        const int r = r0 + j * C::RPW;
        const bool ok = r < n;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          cp_async16(slot(i % NS, 0, j * CPL + c), ok ? kb + r * ksl + col(c) : kb,
                     ok ? 16 : 0);
          cp_async16(slot(i % NS, 1, j * CPL + c), ok ? vb + r * vsl + col(c) : vb,
                     ok ? 16 : 0);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < mine) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      if (i + NS - 1 < mine) issue(i + NS - 1);
      cp_async_commit();
      cp_async_wait<NS - 1>();  // tile i has landed
      const int r0 = (warp + i * NW) * C::TR + grp;
      float s[NRG][GB];
#pragma unroll
      for (int j = 0; j < NRG; ++j) {
        float kf[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          uint4 u;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                       : "r"(slot(i % NS, 0, j * CPL + c)));
          unpack(u, kf + c * EPC);
        }
        const bool ok = r0 + j * C::RPW < n;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= G) break;
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) x += qv[g][e] * kf[e];
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          s[j][g] = ok ? x * scale_log2 : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float mt = s[0][g];
#pragma unroll
        for (int j = 1; j < NRG; ++j) mt = fmaxf(mt, s[j][g]);
        const float m_new = fmaxf(m[g], mt);  // >= NEG_INF: never -inf
        const float corr = exp2f(m[g] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NRG; ++j) {
          s[j][g] = exp2f(s[j][g] - m_new);  // 0 where masked
          ps += s[j][g];
        }
        l[g] = l[g] * corr + ps;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < NRG; ++j) {
        float vf[E];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          uint4 u;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                       : "r"(slot(i % NS, 1, j * CPL + c)));
          unpack(u, vf + c * EPC);
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] += s[j][g] * vf[e];
        }
      }
    }
    cp_async_wait<0>();

    // merge the warp's lane groups: lanes with equal sub hold equal columns
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mm = fmaxf(m[g], mo);
        const float wa = exp2f(m[g] - mm), wb = exp2f(mo - mm);
        l[g] = l[g] * wa + lo * wb;
        m[g] = mm;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * wa + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * wb;
      }
    }

    // the warp's partial to shared memory, free once every ring is drained
    __syncthreads();
    float* wm = reinterpret_cast<float*>(smem);
    if (grp == 0) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        if (sub == 0) {
          wm[warp * GB + g] = m[g];
          wm[(NW + warp) * GB + g] = l[g];
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            wm[2 * NW * GB + (warp * GB + g) * D + col(c) + e] =
                acc[g][c * EPC + e];
      }
    }
  }
  finish<float, D, GB>(smem, n > 0, out, lse, m_part, l_part, acc_part, counters,
                       G, n_split, split, head0, b, hk);
}


// bf16 on the tensor cores: mma.sync m16n8k16 with f32 accumulators.  A
// warp takes tiles of TK = 16 cache rows.  S = Q K^T puts query head g of
// the KV head in row g of the 16-row A operand (rows G..15 are zero) and the
// tile's keys in the columns; K's B fragments come from shared memory by
// ldmatrix.  The online softmax runs on the C fragments (row g lives in the
// 4 lanes of quad g).  For O += P V, p is split into bf16 hi = bf16(p) and
// lo = bf16(p - hi): hi goes in row g of the A operand and lo in the unused
// row g + 8, so one mma sums both and p keeps about 16 bits, as the plain
// version's f32 p.  V's B fragments come by ldmatrix.trans.  K and V tile
// rows are padded by 16 bytes, so ldmatrix's 8-row reads fall in distinct
// banks.  That is the GB = 8 build.  With GB = 16, heads g and g + 8 fill
// all 16 rows (rows G..15 zero): the lanes of quad g keep the softmax of
// both rows, and O += P V takes two mma, one of the hi parts of p and one of
// the lo parts.
constexpr int TK = 16;  // cache rows of a tile in the mma kernel

template <int D> struct MmaCfg {
  static constexpr int RS = D + 8;                // padded row, in elements
  static constexpr int TILE = TK * RS * 2;        // bytes of a K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int CPR = D / 8;               // 16-byte chunks a row
  static constexpr int CPY = TK * CPR / 32;       // chunks a lane copies of K (of V)
  // 3 stages: 104 KB a block at D = 128; 2 at D = 256, within 227 KB
  static constexpr int STAGES = D > 128 ? 2 : 3;
  static constexpr int SMEM = NW * STAGES * STAGE;
};

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int GB>
__global__ void __launch_bounds__(NW * 32)
dec_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
        const int* __restrict__ kv_start, __nv_bfloat16* __restrict__ out,
        float* __restrict__ lse, float* __restrict__ m_part,
        float* __restrict__ l_part, float* __restrict__ acc_part,
        unsigned* __restrict__ counters, int H, int G, int L, int chunk,
        int n_split, long long qsb, long long qsh, long long ksb,
        long long ksh, long long ksl, long long vsb, long long vsh,
        long long vsl, float scale_log2) {
  using C = MmaCfg<D>;
  constexpr int KS = D / 16, ND = D / 8;
  constexpr int R = GB / 8;  // query rows a quad holds: g, and g + 8 at GB = 16
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(kv_len[b], L);
  // rows [kv_start[b], len) are attended to; this split holds [start, start + n)
  const int start = max(split * chunk, kv_start != nullptr ? kv_start[b] : 0);
  const int n = min(split * chunk + chunk, len) - start;
  const long long head0 = (long long)b * H + (long long)hk * G;

  if (n > 0) {
    // rows g and g + 8 of Q as A fragments: qa[ks][r][h] is row g + 8 r,
    // columns ks * 16 + h * 8 + 2 t (+1); at GB = 8 rows 8..15 are zero
    uint32_t qa[KS][2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hq = g + 8 * r;  // the query head of this row
      const unsigned short* qr = reinterpret_cast<const unsigned short*>(q) +
                                 b * qsb + (hk * G + min(hq, G - 1)) * qsh;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = ks * 16 + h * 8 + 2 * t;
          qa[ks][r][h] = r < R && hq < G
                             ? (uint32_t)qr[c] | ((uint32_t)qr[c + 1] << 16)
                             : 0u;
        }
    }
    // GB = 8: rows g (p's hi part) and g + 8 (its lo part), both head g;
    // GB = 16: row g (head g) and row g + 8 (head g + 8)
    float o[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    float m[R], l[R];  // rows g and g + 8, log2 units
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
    }

    const __nv_bfloat16* kb = k + b * ksb + hk * ksh + (long long)start * ksl;
    const __nv_bfloat16* vb = v + b * vsb + hk * vsh + (long long)start * vsl;
    const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                          warp * C::STAGES * C::STAGE;
    const int n_tiles = (n + TK - 1) / TK;
    const int mine = n_tiles > warp ? (n_tiles - warp + NW - 1) / NW : 0;
    auto issue = [&](int i) {  // the warp's i-th tile: tile warp + i * NW
      const int r0 = (warp + i * NW) * TK;
      const uint32_t st = ring + (i % C::STAGES) * C::STAGE;
#pragma unroll
      for (int c = 0; c < C::CPY; ++c) {
        const int idx = lane + 32 * c, row = idx / C::CPR, ch = idx % C::CPR;
        const bool ok = r0 + row < n;
        const uint32_t dst = st + (row * C::RS + ch * 8) * 2;
        cp_async16(dst, ok ? kb + (r0 + row) * ksl + ch * 8 : kb, ok ? 16 : 0);
        cp_async16(dst + C::TILE, ok ? vb + (r0 + row) * vsl + ch * 8 : vb, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < C::STAGES - 1; ++i) {
      if (i < mine) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      if (i + C::STAGES - 1 < mine) issue(i + C::STAGES - 1);
      cp_async_commit();
      cp_async_wait<C::STAGES - 1>();  // this lane's part of tile i has landed
      __syncwarp();             // and every other lane's
      const uint32_t kt = ring + (i % C::STAGES) * C::STAGE, vt = kt + C::TILE;
      const int r0 = (warp + i * NW) * TK;

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int j = lane >> 3, r = lane & 7;
        const uint32_t addr = kt + (((j >> 1) * 8 + r) * C::RS + ks * 16 + (j & 1) * 8) * 2;
        uint32_t b0, b1, b2, b3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(addr));
        mma_bf16(s[0], qa[ks][0][0], qa[ks][1][0], qa[ks][0][1], qa[ks][1][1], b0, b1);
        mma_bf16(s[1], qa[ks][0][0], qa[ks][1][0], qa[ks][0][1], qa[ks][1][1], b2, b3);
      }
      // s[nt][2 r + e]: row g + 8 r, key r0 + nt * 8 + 2 t + e
      float corr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * r + e];
            x = r0 + nt * 8 + 2 * t + e < n ? x * scale_log2 : -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);  // >= NEG_INF: never -inf
        corr[r] = exp2f(m[r] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * r + e];
            x = exp2f(x - m_new);  // 0 where masked
            ps += x;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[r] = l[r] * corr[r] + ps;
        m[r] = m_new;
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] *= corr[R == 2 ? e >> 1 : 0];

      // p of row g + 8 r as hi = bf16(p) and lo = bf16(p - hi)
      uint32_t ph[2][2], pl[2][2];  // [r][nt]
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float p0 = s[nt][2 * r], p1 = s[nt][2 * r + 1];
          ph[r][nt] = pack_bf16(p0, p1);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&ph[r][nt]);
          pl[r][nt] = pack_bf16(p0 - __low2float(hv), p1 - __high2float(hv));
        }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        const int j = lane >> 3, r = lane & 7;
        const uint32_t addr = vt + (((j & 1) * 8 + r) * C::RS + (nd + (j >> 1)) * 8) * 2;
        uint32_t b0, b1, b2, b3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(addr));
        if (R == 1) {  // hi in row g, lo in row g + 8
          mma_bf16(o[nd], ph[0][0], pl[0][0], ph[0][1], pl[0][1], b0, b1);
          mma_bf16(o[nd + 1], ph[0][0], pl[0][0], ph[0][1], pl[0][1], b2, b3);
        } else {  // rows g and g + 8: the hi parts, then the lo parts
          mma_bf16(o[nd], ph[0][0], ph[1][0], ph[0][1], ph[1][1], b0, b1);
          mma_bf16(o[nd + 1], ph[0][0], ph[1][0], ph[0][1], ph[1][1], b2, b3);
          mma_bf16(o[nd], pl[0][0], pl[1][0], pl[0][1], pl[1][1], b0, b1);
          mma_bf16(o[nd + 1], pl[0][0], pl[1][0], pl[0][1], pl[1][1], b2, b3);
        }
      }
      __syncwarp();  // every lane is done with the stage before it is refilled
    }
    cp_async_wait<0>();

    // the warp's partial to shared memory, free once every ring is drained
    __syncthreads();
    float* wm = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int hq = g + 8 * r;
      if (hq >= G) continue;
      if (t == 0) {
        wm[warp * GB + hq] = m[r];
        wm[(NW + warp) * GB + hq] = l[r];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          wm[2 * NW * GB + (warp * GB + hq) * D + nd * 8 + 2 * t + e] =
              R == 1 ? o[nd][e] + o[nd][e + 2] : o[nd][2 * r + e];
    }
  }
  finish<__nv_bfloat16, D, GB>(smem, n > 0, out, lse, m_part, l_part, acc_part,
                               counters, G, n_split, split, head0, b, hk);
}

template <int D, int GB>
int launch_mma(const void* q, const void* k, const void* v, const int* kv_len,
               const int* kv_start, void* out, float* lse, float* m_part, float* l_part,
               float* acc_part,
               unsigned* counters, int B, int H, int G, int L, int chunk,
               int n_split, long long qsb, long long qsh, long long ksb,
               long long ksh, long long ksl, long long vsb, long long vsh,
               long long vsl, float scale, cudaStream_t st) {
  const size_t smem = merge_smem(MmaCfg<D>::SMEM, D, n_split, GB);
  cudaError_t err = cudaFuncSetAttribute(
      dec_mma<D, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dec_mma<D, GB><<<dim3(n_split, H / G, B), NW * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, kv_start,
      static_cast<__nv_bfloat16*>(out), lse,
      m_part, l_part, acc_part, counters, H, G, L, chunk, n_split, qsb, qsh, ksb,
      ksh, ksl, vsb, vsh, vsl, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int LPR, int CPL, int GB>
int launch_f32(const void* q, const void* k, const void* v, const int* kv_len,
               const int* kv_start, void* out, float* lse, float* m_part, float* l_part,
               float* acc_part,
               unsigned* counters, int B, int H, int G, int L, int chunk,
               int n_split, long long qsb, long long qsh, long long ksb,
               long long ksh, long long ksl, long long vsb, long long vsh,
               long long vsl, float scale, cudaStream_t st) {
  using C = Cfg<LPR, CPL>;
  const size_t smem = merge_smem(C::SMEM, C::D, n_split, GB);
  cudaError_t err = cudaFuncSetAttribute(
      dec_split<LPR, CPL, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dec_split<LPR, CPL, GB><<<dim3(n_split, H / G, B), NW * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, kv_start, static_cast<float*>(out), lse,
      m_part,
      l_part, acc_part, counters, H, G, L, chunk, n_split, qsb, qsh, ksb, ksh,
      ksl, vsb, vsh, vsl, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the head dims built: f32 (head dim, lanes a row, 16-byte chunks a lane)
// on dec_split, bf16 (head dim) on dec_mma
#define DEC_F32(X) \
  X(8, 2, 1) X(16, 4, 1) X(32, 8, 1) X(64, 16, 1) X(128, 32, 1) X(256, 32, 2)
#define DEC_BF16(X) X(16) X(32) X(64) X(128) X(256)

extern "C" int decode_attention_max_group() { return MAX_G; }

// the ring's shared memory a block takes (the merges may ask for more)
extern "C" int decode_attention_smem(int dtype, int D) {
#define F32_SMEM(DD, LPR, CPL) \
  if (dtype == 0 && D == DD) return Cfg<LPR, CPL>::SMEM;
#define BF16_SMEM(DD) \
  if (dtype == 1 && D == DD) return MmaCfg<DD>::SMEM;
  DEC_F32(F32_SMEM)
  DEC_BF16(BF16_SMEM)
#undef F32_SMEM
#undef BF16_SMEM
  return 0;
}

// kv_start: (B,) int32 first row attended to, or null for row 0.
// lse: (B, H) f32 log-sum-exp written beside the output, or null for none.
// dtype: 0 = float32 (dec_split), 1 = bfloat16 (dec_mma); D one of the head
// dims above; G = H / Hkv at most MAX_G, built for the group bound 8 where
// it holds G and 16 otherwise; k and v 16-byte aligned with strides in
// multiples of 16 bytes, which the caller checks.  counters: B * Hkv zeros,
// left zero.
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, const int* kv_len,
    const int* kv_start, void* out, float* lse, float* m_part, float* l_part, float* acc_part,
    unsigned* counters,
    int B, int H, int G, int L, int D, int chunk, int n_split, long long qsb,
    long long qsh, long long ksb, long long ksh, long long ksl, long long vsb,
    long long vsh, long long vsl, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_G) return static_cast<int>(cudaErrorInvalidValue);
#define F32_GB(DD, LPR, CPL, GB)                                                \
  return launch_f32<LPR, CPL, GB>(q, k, v, kv_len, kv_start, out, lse, m_part, \
                                  l_part,                                       \
                                  acc_part, counters, B, H, G, L, chunk,        \
                                  n_split, qsb, qsh, ksb, ksh, ksl, vsb, vsh,   \
                                  vsl, scale, st);
#define F32_CASE(DD, LPR, CPL)                                                  \
  if (dtype == 0 && D == DD) {                                                  \
    if (G <= 8) F32_GB(DD, LPR, CPL, 8)                                         \
    F32_GB(DD, LPR, CPL, 16)                                                    \
  }
#define BF16_GB(DD, GB)                                                         \
  return launch_mma<DD, GB>(q, k, v, kv_len, kv_start, out, lse, m_part, l_part,\
                            acc_part,                                           \
                            counters, B, H, G, L, chunk, n_split, qsb, qsh,     \
                            ksb, ksh, ksl, vsb, vsh, vsl, scale, st);
#define BF16_CASE(DD)                                                           \
  if (dtype == 1 && D == DD) {                                                  \
    if (G <= 8) BF16_GB(DD, 8)                                                  \
    BF16_GB(DD, 16)                                                             \
  }
  DEC_F32(F32_CASE)
  DEC_BF16(BF16_CASE)
#undef F32_GB
#undef F32_CASE
#undef BF16_GB
#undef BF16_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
