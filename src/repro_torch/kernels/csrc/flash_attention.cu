// Flash attention (forward) for Hopper (sm_90a): online softmax over KV
// tiles, causal mask k <= q, optional window k > q - window, scale 1/sqrt(D),
// f32 scores, output in q's dtype.  With positions (q_pos, k_pos: (B, S)
// int32, either may be null for the row index) the masks compare positions
// instead of indices: key j is kept for query i when k_pos[b,j] <=
// q_pos[b,i] (causal) and k_pos[b,j] > q_pos[b,i] - window (window > 0), the
// reference's _attend_chunk mask (src/repro/models/attention.py:53-57); every
// KV tile is then visited, and a row with no kept key gives 0.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _fa_kernel).
// Shapes: q (B, H, S, D); k, v (B, Hkv, S, D); out (B, H, S, D), each given
// by strides with the last dimension contiguous, so the model hands in its
// (B, S, H, D) projections as permuted views and nothing is copied.  Query
// head h reads KV head h / G with G = H / Hkv; G = 1 is the TPU kernel's
// function.  Any S: the ragged last tile is masked here (the TPU kernel's
// S % block == 0 is a TPU tiling rule).
//
// What bounds it on this card: operations.  A (q tile, kv tile) pair does
// 4 * 64 * 64 * D flops on 2 * 64 * D loaded values; at S = 2048 the whole
// call does ~S/2 flops per byte read, far above the ~295 flops a byte where
// the tensor cores, not memory, set the limit.  Two kernels share the grid
// below: fa_mma runs bf16 on the tensor cores (mma.sync) at the head dims
// that fa_wgmma (flash_attention_wgmma.cu: wgmma and TMA, the model's path
// at D = 64 and 128) does not take; fa_fwd runs f32 on the CUDA cores
// (67 TFLOP/s peak).  flash_attention.route picks the kernel.
//
// Design.  The TPU kernel's grid (B*H, n_q, n_kv) makes the KV axis a
// sequential grid dimension with (m, l, acc) in VMEM scratch.  Here the grid
// is (query tiles, B*H) and one block walks its KV tiles in a loop, holding
// (m, l, acc) in registers.  Tiles that lie wholly above the causal
// diagonal, below the window or past S are never visited, and the heaviest
// query tiles (the last, under a causal mask) are launched first.  Masked
// entries get p = 0 explicitly, so a row that sees no valid key in a tile
// keeps l = 0 and acc = 0.  In fa_fwd a block of 256 threads takes 64 query
// rows; thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty..4*ty+3,
// score columns tx + 16*j and output columns tx + 16*j.  Q, K and V tiles
// are staged in shared memory as f32 (rows padded by 4 floats, so the
// float4 reads of 8 neighbouring rows fall in distinct banks); P reuses K's
// space.  fa_mma is described where it is defined.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block
constexpr int RPT = 4;    // rows per thread
constexpr int TX = 16;    // threads across a row
constexpr float NEG_INF = -1e30f;

// max and sum over the 16 lanes that share a row (an aligned half-warp)
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

template <int D> struct Smem {
  static constexpr int QS = D + 4;       // row stride of Q and K tiles
  static constexpr int PS = BK + 4;      // row stride of P
  static constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  static constexpr size_t bytes = sizeof(float) * (BQ * QS + KP + BK * D);
};

// rows [row0, row0 + 64) of a (S, D) matrix with row stride rs, zero past S
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const float* src, long long rs,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < BK * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int s = row0 + r;
    dst[r * dst_stride + d] = s < S ? src[(long long)s * rs + d] : 0.f;
  }
}

template <int D, bool POS>
__global__ void __launch_bounds__(NT, 2)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, int H, int G, int S,
       int n_q, long long qsb, long long qsh, long long qss, long long ksb,
       long long ksh, long long kss, long long vsb, long long vsh,
       long long vss, long long osb, long long osh, long long oss,
       float scale, int causal, int window, const int* __restrict__ q_pos,
       const int* __restrict__ k_pos) {
  using L = Smem<D>;
  constexpr int DC = D / TX;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][QS]
  float* Ks = Qs + BQ * L::QS;      // [BK][QS], then P [BQ][PS]
  float* Vs = Ks + L::KP;           // [BK][D]
  float* Ps = Ks;

  const int qt = n_q - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, hk = h / G;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = qt * BQ;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  load_tile<D>(Qs, L::QS, qb, qss, q0, S);

  // the KV tiles this query tile can see: all of them under positions
  const bool posn = POS;
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_end = (causal && !posn ? q_last : S - 1) / BK + 1;
  int kt_begin = 0;
  if (window > 0 && !posn) {
    const int k_min = q0 - window + 1;  // lowest key any row here keeps
    kt_begin = k_min > 0 ? k_min / BK : 0;
  }
  int qpv[RPT];  // this thread's query positions
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + ty * RPT + i;
    qpv[i] = POS && q_pos != nullptr && qi < S ? q_pos[(long long)b * S + qi] : qi;
  }

  float m[RPT], l[RPT], acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P and V are no longer read
    load_tile<D>(Ks, L::QS, kb, kss, k0, S);
    load_tile<D>(Vs, D, vb, vss, k0, S);
    __syncthreads();

    // scores s[i][j] = q[4ty+i] . k[tx+16j]
    float s[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RPT + i) * L::QS + d]);
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + TX * j) * L::QS + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    // mask, online softmax, p = 0 where masked
    int kpv[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int kj = k0 + tx + TX * j;
      kpv[j] = POS && k_pos != nullptr && kj < S ? k_pos[(long long)b * S + kj] : kj;
    }
    bool keep[RPT][RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = qpv[i];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int kp = kpv[j];
        bool ok = k0 + tx + TX * j < S;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        keep[i][j] = ok;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        s[i][j] = keep[i][j] ? expf(s[i][j] - m_new) : 0.f;
        ps += s[i][j];
      }
      l[i] = corr * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done reading K: P takes its place
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        Ps[(ty * RPT + i) * L::PS + tx + TX * j] = s[i][j];
    __syncthreads();

    // acc[i][c] += sum_j p[4ty+i][j] * v[j][tx+16c]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * RPT + i) * L::PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = Vs[(j + jj) * D + tx + TX * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

  float* ob = out + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(long long)qp * oss + tx + TX * c] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, f32 accumulators.
//
// A block of 4 warps takes 64 query rows, 16 a warp, in the FA2 layout: the
// warp's Q rows stay in registers as A fragments for the whole KV walk;
// S = Q K^T comes out in C fragments (rows g and g + 8 of the warp's 16,
// g = lane / 4, two columns a thread per 8-key tile); the online softmax
// reduces over the 4 lanes of a quad; P is rounded to bf16 (as the reference
// casts p to v's dtype) and re-used as the A fragment of O += P V, with V's
// B fragments read transposed by ldmatrix.  K and V tiles are staged in
// shared memory with rows padded by 16 bytes, so the fragment reads of 8
// rows fall in distinct banks.  Needs D % 16 == 0 and every stride a
// multiple of 8 elements (16-byte loads); the wrapper checks.
// ---------------------------------------------------------------------------

constexpr int MW = 4;  // warps per block in the mma kernel

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

// 64 rows of a (S, D) bf16 matrix with row stride rs into dst[r][D + 8],
// 16 bytes a load, zero past S
template <int D>
__device__ __forceinline__ void load_tile16(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long rs, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < BK * CH; i += MW * 32) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int s = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) v = *reinterpret_cast<const uint4*>(src + (long long)s * rs + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
  }
}

template <int D, bool POS>
__global__ void __launch_bounds__(MW * 32)
fa_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
       int H, int G, int S, int n_q, long long qsb, long long qsh,
       long long qss, long long ksb, long long ksh, long long kss,
       long long vsb, long long vsh, long long vss, long long osb,
       long long osh, long long oss, float scale, int causal, int window,
       const int* __restrict__ q_pos, const int* __restrict__ k_pos) {
  constexpr int RS = D + 8;  // padded row stride of the K and V tiles
  constexpr int KD = D / 16, ND = D / 8, NK = BK / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * RS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * RS];

  const int qt = n_q - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H, hk = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16;  // this warp's first query row

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  // the warp's Q rows as A fragments, zero past S
  uint32_t qf[KD][4];
  {
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
      const int c = ks * 16 + tig * 2;
      auto ld = [&](int r, int cc) -> uint32_t {
        return r < S ? *reinterpret_cast<const uint32_t*>(qb + (long long)r * qss + cc)
                     : 0u;
      };
      qf[ks][0] = ld(ra, c);
      qf[ks][1] = ld(rb, c);
      qf[ks][2] = ld(ra, c + 8);
      qf[ks][3] = ld(rb, c + 8);
    }
  }

  const bool posn = POS;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_end = (causal && !posn ? q_last : S - 1) / BK + 1;
  int kt_begin = 0;
  if (window > 0 && !posn) {
    const int k_min = q0 - window + 1;
    kt_begin = k_min > 0 ? k_min / BK : 0;
  }
  int qpv[2];  // the positions of rows r0 + g and r0 + g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = r0 + g + 8 * hf;
    qpv[hf] = POS && q_pos != nullptr && qi < S ? q_pos[(long long)b * S + qi] : qi;
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile16<D>(Ks, kb, kss, k0, S);
    load_tile16<D>(Vs, vb, vss, k0, S);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const __nv_bfloat16* kr = Ks + (nt * 8 + g) * RS + ks * 16 + tig * 2;
        mma_bf16(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // mask, online softmax over the quad; element e of tile nt is row
    // r0 + g + 8 * (e / 2), key k0 + nt * 8 + tig * 2 + e % 2
    int kpv[NK][2];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + nt * 8 + tig * 2 + e;
        kpv[nt][e] = POS && k_pos != nullptr && kj < S
                         ? k_pos[(long long)b * S + kj] : kj;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qp = qpv[hf];
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kpv[nt][e];
          bool ok = k0 + nt * 8 + tig * 2 + e < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          float& x = s[nt][hf * 2 + e];
          x = ok ? x * scale : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);  // >= NEG_INF: never -inf
      const float corr = expf(m[hf] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int nt = 0; nt < NK; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][hf * 2 + e];
          x = expf(x - m_new);  // exp(-inf) = 0 where masked
          ps += x;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[hf] = corr * l[hf] + ps;
      m[hf] = m_new;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[nd][hf * 2] *= corr;
        o[nd][hf * 2 + 1] *= corr;
      }
    }

    // O += P V: the C fragments of key tiles 2j, 2j+1 are the A fragment
    // of key step j
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                       pack_bf16(s[2 * j][2], s[2 * j][3]),
                       pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                       pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      // lanes 0-15 address rows j*16 + 0..15 of V; .trans hands each lane
      // the key pair of its B fragment
      const __nv_bfloat16* vrow = Vs + (j * 16 + (lane & 15)) * RS;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t b0, b1;
        const unsigned addr = static_cast<unsigned>(
            __cvta_generic_to_shared(vrow + nd * 8));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(addr));
        mma_bf16(o[nd], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = r0 + g + 8 * hf;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[hf], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(ob + (long long)qp * oss + nd * 8 + tig * 2) =
          pack_bf16(o[nd][hf * 2] * inv, o[nd][hf * 2 + 1] * inv);
  }
}

// POS: a call with positions; without them the kernels compile to the
// index masks alone
template <int D, bool POS>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int H, int G, int S, long long qsb, long long qsh,
           long long qss, long long ksb, long long ksh, long long kss,
           long long vsb, long long vsh, long long vss, long long osb,
           long long osh, long long oss, float scale, int causal, int window,
           const int* q_pos, const int* k_pos, cudaStream_t st) {
  const int n_q = (S + BQ - 1) / BQ;
  const dim3 grid(n_q, B * H);
  if (dtype == 1) {
    fa_mma<D, POS><<<grid, MW * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), H, G, S, n_q, qsb, qsh, qss, ksb,
        ksh, kss, vsb, vsh, vss, osb, osh, oss, scale, causal, window, q_pos,
        k_pos);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Smem<D>::bytes;
  // above 48 KB a block's dynamic shared memory must be asked for, or the
  // launch is refused
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<D, POS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_fwd<D, POS><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, G, S, n_q,
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, scale,
      causal, window, q_pos, k_pos);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (fa_fwd), 1 = bfloat16 (fa_mma: every stride a multiple
// of 8 elements and every pointer 16-byte aligned, which the caller checks).
// q_pos, k_pos: (B, S) int32 positions, or null for the row index.  A head
// dim not built here returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int H, int G, int S, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, float scale,
    int causal, int window, const int* q_pos, const int* k_pos, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CASE(DD)                                                          \
  case DD:                                                                   \
    return q_pos != nullptr || k_pos != nullptr                              \
               ? launch<DD, true>(dtype, q, k, v, out, B, H, G, S, qsb, qsh, \
                                  qss, ksb, ksh, kss, vsb, vsh, vss, osb,     \
                                  osh, oss, scale, causal, window, q_pos,     \
                                  k_pos, st)                                  \
               : launch<DD, false>(dtype, q, k, v, out, B, H, G, S, qsb, qsh, \
                                   qss, ksb, ksh, kss, vsb, vsh, vss, osb,    \
                                   osh, oss, scale, causal, window, q_pos,    \
                                   k_pos, st);
  switch (D) {  // the head dims of flash_attention.HEAD_DIMS
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(96)
    FA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}
