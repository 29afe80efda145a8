// Hopper (sm_90a) building blocks shared by the wgmma attention kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu) and the scan's
// backward (ssm_scan_bwd.cu): mbarriers, TMA loads, wgmma descriptors and
// products, the host's tensor maps, and the attention kernels' tile and
// element predicates over given positions.
//
// Layout they assume: a bf16 (rows, D) tile in shared memory is stored as
// D / 64 "halves" of (rows, 64) with the 128-byte swizzle that TMA writes
// (CU_TENSOR_MAP_SWIZZLE_128B), the halves rows * 128 bytes apart, each
// tile 1024-byte aligned.  Such a tile is read by wgmma either K-major (the
// head dim is the product's depth: A or B of Q K^T) or MN-major (the rows
// are the depth: B of P V), with the descriptors below.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 4-D TMA load of one box into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// 3-D TMA load of one box into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// the map's coordinates for (d, s, h, b): the host sorted the three outer
// dimensions by stride; perm holds the position (1..3) of s, h and b
__device__ __forceinline__ void tma_load_sbh(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int d, int s, int h,
                                             int b, int perm) {
  const int ps = perm & 3, ph = (perm >> 2) & 3;
  auto at = [&](int i) { return ps == i ? s : ph == i ? h : b; };
  tma_load(dst, map, bar, d, at(1), at(2), at(3));
}

// bulk copy of ``bytes`` contiguous bytes (a multiple of 16, both addresses
// 16-byte aligned) into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_O8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_O32 WG_O8(0), WG_O8(8), WG_O8(16), WG_O8(24)
#define WG_O64 WG_O32, WG_O8(32), WG_O8(40), WG_O8(48), WG_O8(56)
#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// C (64 x 128) (+)= A (64 x 16, shared, K-major) B^T (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_O64
      : "l"(da), "l"(db), "r"(accumulate));
}

// C (64 x 64) (+)= A (64 x 16, shared, K-major) B^T (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_O32
      : "l"(da), "l"(db), "r"(accumulate));
}

// C (64 x 128) += A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : WG_O64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// C (64 x 64) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : WG_O32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- masks by given positions (the wgmma attention kernels' POS builds) ----

// (b, S) int32 positions of queries and keys, and each one's table of the
// least and greatest position (x, y) of every 64-row tile of a batch row,
// (B, T64) with T64 = ceil(S / 64); all null without positions
struct PosArgs {
  const int* q;
  const int* k;
  const int2* qtab;
  const int2* ktab;
  int T64;
};

// the least and greatest position over rows r0 .. r0 + rows - 1 (r0 < S,
// r0 a multiple of 64) of one batch row's table ``tab``: the tiles are
// merged, the last one holding only rows below S
__device__ __forceinline__ int2 pos_range(const int2* tab, int T64, int r0, int rows) {
  const int e1 = min((r0 + rows - 1) >> 6, T64 - 1);
  int2 r = tab[r0 >> 6];
  for (int e = (r0 >> 6) + 1; e <= e1; ++e) {
    const int2 x = tab[e];
    r.x = min(r.x, x.x);
    r.y = max(r.y, x.y);
  }
  return r;
}

// keys with positions in [k.x, k.y] against queries in [q.x, q.y]: no pair
// is kept (the tile is skipped)
__device__ __forceinline__ bool pos_none(int2 q, int2 k, int causal, int window) {
  return (causal && k.x > q.y) || (window > 0 && k.y <= q.x - window);
}
// every pair is kept (no element mask)
__device__ __forceinline__ bool pos_all(int2 q, int2 k, int causal, int window) {
  return (!causal || k.y <= q.x) && (window <= 0 || k.x > q.y - window);
}
// the pair (query at qp, key at kp) is kept
__device__ __forceinline__ bool pos_kept(int qp, int kp, int causal, int window) {
  return (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// warp 0 of a block, all 32 lanes: bit t of ``bits`` (shared memory, n / 32
// words rounded up) set where keep(t), for the tiles t < n
template <typename Keep>
__device__ __forceinline__ void mark_tiles(uint32_t* bits, int n, Keep keep) {
  const int lane = threadIdx.x & 31;
  for (int w = 0; 32 * w < n; ++w) {
    const int t = 32 * w + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, t < n && keep(t));
    if (lane == 0) bits[w] = b;
  }
}

// the first tile t' >= t whose bit is set, or n
__device__ __forceinline__ int next_tile(const uint32_t* bits, int t, int n) {
  if (t >= n) return n;
  int w = t >> 5;
  uint32_t m = bits[w] & (0xffffffffu << (t & 31));
  const int nw = (n + 31) >> 5;
  while (m == 0) {
    if (++w >= nw) return n;
    m = bits[w];
  }
  return (w << 5) + __ffs(m) - 1;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver API's cuTensorMapEncodeTiled, found through the runtime,
// so the library needs no -lcuda.  A driver call needs the device's context
// current on the calling thread, which the runtime binds at the thread's
// first call that initializes it: a thread whose first CUDA work is a map
// (autograd's backward thread, for which PyTorch skips cudaSetDevice where
// the device is already the current one) would get CUresult 201, so each
// call makes the current device's primary context current first.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
  return fn;
}

// A 4-D map over a strided (B, heads, S, D) bf16 view whose last dimension is
// contiguous: dimension 0 is D in boxes of 64, the other three are (S, heads,
// B) sorted by stride; boxes are ``rows`` rows of S, and rows past S read
// as zeros.  perm gets the positions of s, h and b among dimensions 1..3.
// Returns 0 or the CUresult.
int make_map(CUtensorMap* map, int* perm, const void* base, int D, int S,
             int heads, int B, long long ss, long long sh, long long sb,
             int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  struct Dim { cuuint64_t size, stride; cuuint32_t box; int which; };
  Dim d[3] = {{(cuuint64_t)S, (cuuint64_t)ss * 2, (cuuint32_t)rows, 0},
              {(cuuint64_t)heads, (cuuint64_t)sh * 2, 1, 1},
              {(cuuint64_t)B, (cuuint64_t)sb * 2, 1, 2}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (d[j].stride > d[j + 1].stride) { Dim t = d[j]; d[j] = d[j + 1]; d[j + 1] = t; }
  int pos[3];
  for (int i = 0; i < 3; ++i) pos[d[i].which] = i + 1;
  *perm = pos[0] | (pos[1] << 2) | (pos[2] << 4);
  const cuuint64_t dims[4] = {(cuuint64_t)D, d[0].size, d[1].size, d[2].size};
  const cuuint64_t strides[3] = {d[0].stride, d[1].stride, d[2].stride};
  const cuuint32_t box[4] = {64, d[0].box, d[1].box, d[2].box};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                   dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

}  // namespace
