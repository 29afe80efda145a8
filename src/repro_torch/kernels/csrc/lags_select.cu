// LAGS scheduler tick for Hopper (sm_90a): PELT + Load Credit EMA over T
// tenants, then the k runnable tenants of lowest key, in one cluster launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lags_select.py::lags_select
// (body _lags_kernel).  It computes, per lane,
//   new_load   = y*load + (1-y)*frac                  y = 0.5^(1/halflife)
//   new_credit = (1-alpha)*credit + alpha*new_load    alpha = 2/(window+1)
//   key        = runnable ? new_credit + (float)lane*1e-12f : INF
// and returns the k lanes of lowest (key, lane) in ascending order, -1 where
// the key is not finite and past the last runnable lane.
//
// What bounds it on this card: latency, not bytes and not operations.  The
// tick moves 21 bytes a tenant (1.4 MB at T=65536, 0.4 us at 3.35 TB/s), so
// the time is set by the chain of dependent steps: the launch, one round trip
// to device memory, and the barriers of the selection.  The design keeps that
// chain short and independent of k:
//
// - One launch.  A thread-block cluster of up to 8 CTAs (the portable size),
//   each owning a contiguous range of lanes in lane order, PER lanes a
//   thread (4 or 8, 16-byte loads and stores where the pointers allow).  The
//   TPU kernel holds all T keys in one block's VMEM; 65536 f32 keys (256 KB)
//   exceed a CTA's 227 KB of shared memory, and one CTA of 1024 threads
//   would hold 64 keys a thread.  Why clusters: a cluster spreads the keys
//   over 8 SMs, 8 a thread in registers, and its CTAs write each other's
//   shared memory (distributed shared memory), so no partial result goes
//   through device memory and no second kernel merges them.  Up to 8192
//   lanes the cluster is one CTA, launched plainly, with block barriers: a
//   cluster barrier costs about 1200 cycles more.
// - Selection by radix select, not by k rounds of arg-min.  The key's
//   order-preserving 32-bit image (negative keys: all bits flipped;
//   non-negative: the sign bit set) is selected on in up to four passes of
//   8-bit digits, most significant first.  Each pass builds a 256-bin
//   histogram of the keys that match the prefix so far (one shared-memory
//   atomic a key), pushes it as 16-bit counts into every CTA of the
//   cluster, and after one cluster barrier finds, from local memory, the
//   digit at which the running count reaches k.  The passes stop early
//   where that digit's bin holds exactly the picks still sought.  Then c
//   picks lie below the prefix and r = min(k, #finite) - c at it.
// - Ties at the prefix.  The r picks there are the r lowest such lanes: a
//   lane's rank among them is the count in lower CTAs (read from the same
//   histograms) plus a block scan in lane order.  Where the passes stopped
//   early every key at the prefix is picked, and up to 32 survivors take
//   slots from an atomic counter instead.  Every survivor (at most
//   min(k, T) <= 2048) is written into CTA 0's shared memory, which orders
//   them by (key, lane) -- by counting ranks for up to 32, by a merge sort
//   in shared memory above -- and writes picked.  (key, lane) is a total
//   order, so the picks are the one-block kernel's.
//
// A runnable lane whose key is +inf (or NaN) is never picked, as the
// reference's isfinite(m); a key of -inf is selected and written as -1, as
// in the plain version's stable sort.
//
// Exactness.  Every product and sum is __fmul_rn/__fadd_rn, in the
// reference's order, and the file is built with -fmad=false, so nothing is
// contracted into an FMA.  The coefficients arrive as the f32 casts of the
// Python doubles, as in the plain PyTorch version beside the wrapper.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CTAS = 8;        // the portable cluster size
constexpr int MAX_PER = 8;         // lanes a thread
constexpr int MAX_T = MAX_CTAS * MAX_THREADS * MAX_PER;  // 65536
constexpr int MAX_PICKS = 2048;    // survivors CTA 0 sorts: min(k, T)
constexpr unsigned NONE = 0xffffffffu;     // image of a lane never picked
constexpr unsigned NEG_INF = 0x007fffffu;  // image of -inf
constexpr unsigned FULL = 0xffffffffu;

struct Shared {
  unsigned hist[4][256];  // this CTA's, one per pass: no reuse, no race
  // every CTA's histogram as its CTA pushed it, 16-bit counts in pairs (a
  // CTA holds at most 8192 lanes); two buffers, used by alternate passes
  unsigned all[2][MAX_CTAS][128];
  // survivors (image << 32 | lane), and the merge sort's second buffer
  unsigned long long sorted[2][MAX_PICKS];
  unsigned warp_sum[32];
  // written by warp 0 after each pass, read by every thread
  unsigned prefix, rem, n_pick, lower_less, lower_tie, done;
  unsigned count;  // survivors gathered so far, on the atomic path
};

// Order-preserving image of a key: a < b as floats iff image(a) < image(b).
__device__ __forceinline__ unsigned image(float key) {
  if (!(key < CUDART_INF_F)) return NONE;  // +inf and NaN are never picked
  unsigned b = __float_as_uint(key);
  if ((b << 1) == 0) b = 0;  // -0 and +0 are one key
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned warp_incl_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Ascending bitonic sort of one value a lane over the warp; `lane` is
// the value's index.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v,
                                                        unsigned lane) {
#pragma unroll
  for (unsigned size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (unsigned stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, v, stride);
      const bool take_min = ((lane & stride) == 0) == ((lane & size) == 0);
      v = take_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// The tick of one lane; returns the image of its key.
__device__ __forceinline__ unsigned tick(float load, float credit, float frac,
                                         bool run, int lane, float& nl,
                                         float& nc, float y, float omy,
                                         float alpha, float oma) {
  nl = __fadd_rn(__fmul_rn(y, load), __fmul_rn(omy, frac));
  nc = __fadd_rn(__fmul_rn(oma, credit), __fmul_rn(alpha, nl));
  return run ? image(__fadd_rn(nc, __fmul_rn((float)lane, 1e-12f))) : NONE;
}

template <int PER>
__device__ __forceinline__ void tick_lanes(
    const float* __restrict__ load, const float* __restrict__ credit,
    const float* __restrict__ frac, const uint8_t* __restrict__ runnable,
    float* __restrict__ new_load, float* __restrict__ new_credit, int first,
    int T, bool vec, float y, float omy, float alpha, float oma,
    unsigned (&u)[PER]) {
  if (vec && first + PER <= T) {
    // 16-byte loads and stores; the wrapper checked the alignment
    unsigned run[PER / 4];  // runnable, four bytes a word
    if constexpr (PER == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(runnable + first);
      run[0] = w.x;
      run[PER / 4 - 1] = w.y;
    } else {
      run[0] = *reinterpret_cast<const unsigned*>(runnable + first);
    }
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(load + first)[q];
      const float4 b = reinterpret_cast<const float4*>(credit + first)[q];
      const float4 d = reinterpret_cast<const float4*>(frac + first)[q];
      const float l[4] = {a.x, a.y, a.z, a.w}, c[4] = {b.x, b.y, b.z, b.w},
                  f[4] = {d.x, d.y, d.z, d.w};
      float nl[4], nc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        u[4 * q + j] = tick(l[j], c[j], f[j], (run[q] >> (8 * j)) & 0xffu,
                            first + 4 * q + j, nl[j], nc[j], y, omy, alpha,
                            oma);
      reinterpret_cast<float4*>(new_load + first)[q] =
          make_float4(nl[0], nl[1], nl[2], nl[3]);
      reinterpret_cast<float4*>(new_credit + first)[q] =
          make_float4(nc[0], nc[1], nc[2], nc[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int lane = first + j;
      u[j] = NONE;
      if (lane < T) {
        float nl, nc;
        u[j] = tick(load[lane], credit[lane], frac[lane], runnable[lane] != 0,
                    lane, nl, nc, y, omy, alpha, oma);
        new_load[lane] = nl;
        new_credit[lane] = nc;
      }
    }
  }
}

// Warp 0 of every CTA, after pass `pass`'s barrier: sum the cluster's
// histograms (lane i holds bins 8i..8i+7), find the digit at which the
// running count reaches `want`, the rank still sought, and publish the new
// state.  `done` is set where the digit's bin holds exactly the picks still
// sought: every key matching the new prefix is picked, and no later pass
// can change the selection.
__device__ __forceinline__ void find_digit(Shared& sm, int pass, unsigned rank,
                                           unsigned nctas, int k,
                                           unsigned prefix, unsigned want,
                                           unsigned lower_less) {
  const int lane = threadIdx.x & 31;
  unsigned tot[8], low[8];  // all CTAs; CTAs of lower rank
  if (nctas == 1) {
    const uint4* h = reinterpret_cast<const uint4*>(&sm.hist[pass][0]) +
                     2 * lane;
    const uint4 a = h[0], b = h[1];
    const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tot[i] = v[i];
      low[i] = 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) tot[i] = low[i] = 0;
#pragma unroll
    for (unsigned j = 0; j < MAX_CTAS; ++j) {
      if (j < nctas) {
        if (j == rank) {  // the CTAs before this one, in rank order
#pragma unroll
          for (int i = 0; i < 8; ++i) low[i] = tot[i];
        }
        const uint4 a =
            reinterpret_cast<const uint4*>(&sm.all[pass & 1][j][0])[lane];
        const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tot[i] += (w[i / 2] >> (16 * (i % 2))) & 0xffffu;
      }
    }
  }
  // running totals within the lane, then across the warp
  unsigned pre[8], pre_low[8];
  pre[0] = tot[0];
  pre_low[0] = low[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    pre[i] = pre[i - 1] + tot[i];
    pre_low[i] = pre_low[i - 1] + low[i];
  }
  const unsigned inc = warp_incl_scan(pre[7]);
  const unsigned excl = inc - pre[7];
  const unsigned excl_low = rank > 0 ? warp_incl_scan(pre_low[7]) - pre_low[7]
                                     : 0u;
  unsigned n = min(static_cast<unsigned>(k), __shfl_sync(FULL, inc, 31));
  if (pass > 0) {
    n = sm.n_pick;
  } else {
    want = n;  // pass 0: the n lowest finite keys
    if (n == 0) {
      if (lane == 0) sm.n_pick = 0;
      return;
    }
  }
  const unsigned who =
      __ffs(__ballot_sync(FULL, excl < want && want <= inc)) - 1;
  if (lane == static_cast<int>(who)) {
    // the digit's bin: the first whose running total reaches want
    unsigned b = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) b += excl + pre[i] < want;
    unsigned cum = excl, cum_low = excl_low, bin = tot[0], tie_low = low[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      if (b == static_cast<unsigned>(i)) {
        cum = excl + pre[i - 1];
        cum_low = excl_low + pre_low[i - 1];
        bin = tot[i];
        tie_low = low[i];
      }
    }
    sm.prefix = prefix | ((8 * lane + b) << (24 - 8 * pass));
    sm.rem = want - cum;
    sm.n_pick = n;
    sm.lower_less = lower_less + cum_low;
    sm.lower_tie = tie_low;
    sm.done = cum + bin == want;
  }
}

template <int PER>
__global__ void __launch_bounds__(MAX_THREADS, 1)
lags_cluster_select(const float* __restrict__ load,
                    const float* __restrict__ credit,
                    const float* __restrict__ frac,
                    const uint8_t* __restrict__ runnable,
                    float* __restrict__ new_load,
                    float* __restrict__ new_credit, int* __restrict__ picked,
                    int T, int k, int vec, float y, float omy, float alpha,
                    float oma) {
  __shared__ __align__(16) Shared sm;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nctas = cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a barrier over every thread that takes part: a block's barrier where
  // the cluster is one CTA (a cluster barrier costs about 1200 cycles more)
  auto sync_all = [&]() {
    if (nctas == 1) __syncthreads(); else cluster.sync();
  };

  for (int i = tid; i < 4 * 256; i += blockDim.x) (&sm.hist[0][0])[i] = 0;
  if (tid == 0) sm.count = 0;

  // the tick: state out, key images kept in registers
  const int first = static_cast<int>(rank) * blockDim.x * PER + tid * PER;
  unsigned u[PER];
  tick_lanes<PER>(load, credit, frac, runnable, new_load, new_credit, first, T,
                  vec != 0, y, omy, alpha, oma, u);
  __syncthreads();  // histograms zeroed

  // Radix select: up to four passes of 8-bit digits, most significant
  // first.  After the last pass run, the picks are the keys whose digits so
  // far (u & mask) lie below prefix, and the first rem in lane order of
  // those whose digits equal it.
  unsigned prefix = 0, mask = 0, rem = 0, n = 0, lower_less = 0, lower_tie = 0;
  bool done = false;
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // one shared-memory atomic a key: faster on this card than
      // aggregating equal digits first, even where all keys are equal
      if (u[j] != NONE && ((u[j] ^ prefix) & mask) == 0)
        atomicAdd(&sm.hist[pass][(u[j] >> shift) & 0xffu], 1u);
    }
    if (nctas > 1) {
      // push this CTA's histogram into every CTA's shared memory: the
      // stores overlap the barrier, and the digit search reads locally
      __syncthreads();
      for (unsigned i = tid; i < 128 * nctas; i += blockDim.x) {
        const unsigned pair = i & 127u;
        const unsigned v = sm.hist[pass][2 * pair] |
                           (sm.hist[pass][2 * pair + 1] << 16);
        cluster.map_shared_rank(&sm.all[pass & 1][rank][0], i >> 7)[pair] = v;
      }
    }
    sync_all();  // every CTA's histogram of this pass is complete
    if (warp == 0)
      find_digit(sm, pass, rank, nctas, k, prefix, rem, lower_less);
    __syncthreads();
    n = sm.n_pick;
    if (n == 0) break;  // nothing finite: the same in every CTA
    prefix = sm.prefix;
    rem = sm.rem;
    lower_less = sm.lower_less;
    lower_tie = sm.lower_tie;
    mask |= 0xffu << shift;
    done = sm.done;
    if (done) break;  // the same in every CTA
  }

  bool below[PER], at[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    below[j] = (u[j] & mask) < prefix;  // NONE never lies below
    at[j] = u[j] != NONE && (u[j] & mask) == prefix;
  }
  if (n > 0 && done && n <= 32) {
    // every key at the prefix is picked: the survivors' order is left to
    // the sort, so each takes a slot from a counter in CTA 0
    unsigned* count = nctas == 1 ? &sm.count
                                 : cluster.map_shared_rank(&sm.count, 0);
    unsigned long long* dst = nctas == 1
        ? &sm.sorted[0][0] : cluster.map_shared_rank(&sm.sorted[0][0], 0);
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (below[j] || at[j])
        dst[atomicAdd(count, 1u)] =
            (static_cast<unsigned long long>(u[j]) << 32) |
            static_cast<unsigned>(first + j);
  } else if (n > 0) {
    // n - rem picks lie below the prefix; rem more are the lowest lanes at
    // it.  Slots by a block scan in lane order of (below, at) counts,
    // packed 16:16 (at most 8192 lanes a CTA).
    unsigned nless = 0, ntie = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      nless += below[j];
      ntie += at[j];
    }
    const unsigned packed = (nless << 16) | ntie;
    const unsigned inc = warp_incl_scan(packed);
    if (lane == 31) sm.warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const unsigned w = lane < static_cast<int>(blockDim.x >> 5)
                             ? sm.warp_sum[lane] : 0u;
      sm.warp_sum[lane] = warp_incl_scan(w) - w;
    }
    __syncthreads();
    const unsigned excl = sm.warp_sum[warp] + inc - packed;
    unsigned li = lower_less + (excl >> 16);
    unsigned ti = lower_tie + (excl & 0xffffu);
    const unsigned c = n - rem;
    unsigned long long* dst = nctas == 1
        ? &sm.sorted[0][0] : cluster.map_shared_rank(&sm.sorted[0][0], 0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const unsigned long long v =
          (static_cast<unsigned long long>(u[j]) << 32) |
          static_cast<unsigned>(first + j);
      if (below[j]) {
        dst[li++] = v;
      } else if (at[j]) {
        if (ti < rem) dst[c + ti] = v;
        ++ti;
      }
    }
  }
  sync_all();  // survivors are in CTA 0; no CTA reads another after this
  if (rank != 0) return;

  // sort the n survivors by (image, lane), ascending
  const auto write = [&](unsigned i, unsigned long long v) {
    picked[i] = (v >> 32) == NEG_INF ? -1 : static_cast<int>(v & FULL);
  };
  unsigned long long* const buf = &sm.sorted[0][0];
  if (n <= 32) {
    // a survivor's place is the count of survivors below it
    if (tid < static_cast<int>(n)) {
      const unsigned long long v = buf[tid];
      unsigned r = 0;
#pragma unroll
      for (unsigned j = 0; j < 32; ++j)
        if (j < n) r += buf[j] < v;
      write(r, v);
    }
  } else {
    // merge sort of P = 2^m >= n values: runs of 32 sorted in a warp's
    // registers, then each level of merges puts every value at its rank:
    // its place in its run plus the count of the partner run's values
    // below it (at or below it, for the second run of a pair, so that the
    // padding values, all equal, keep distinct places).  Values alternate
    // between the two buffers, one barrier a level.
    unsigned P = 64;
    while (P < n) P <<= 1;
    for (unsigned i = n + tid; i < P; i += blockDim.x) buf[i] = ~0ull;
    __syncthreads();
    // P and blockDim are multiples of 32: `e < P` holds for whole warps
    for (unsigned e = tid; e < P; e += blockDim.x)
      buf[e] = warp_sort(buf[e], e & 31);
    __syncthreads();
    unsigned src = 0;
    for (unsigned L = 32; L < P; L <<= 1) {
      const unsigned long long* a = sm.sorted[src];
      unsigned long long* b = sm.sorted[src ^ 1];
      for (unsigned e = tid; e < P; e += blockDim.x) {
        const unsigned long long v = a[e];
        const unsigned run = e & ~(L - 1), partner = run ^ L;
        const bool second = (e & L) != 0;
        unsigned lo = 0, hi = L;
        while (lo < hi) {
          const unsigned mid = (lo + hi) >> 1;
          const unsigned long long w = a[partner + mid];
          if (w < v || (second && w == v)) lo = mid + 1; else hi = mid;
        }
        b[(run & ~(2 * L - 1)) + (e - run) + lo] = v;
      }
      __syncthreads();
      src ^= 1;
    }
    for (unsigned i = tid; i < n; i += blockDim.x) write(i, sm.sorted[src][i]);
  }
  for (unsigned i = n + tid; i < static_cast<unsigned>(k); i += blockDim.x)
    picked[i] = -1;
}

__global__ void lags_empty() {}

}  // namespace

// The most clusters of the largest shape (8 CTAs of 1024 threads) the card
// can hold at once; 0 means the kernel cannot launch at T = 65536.  A
// negative value is minus the cudaError_t of the query.
extern "C" int lags_select_max_clusters() {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(MAX_CTAS);
  cfg.blockDim = dim3(MAX_THREADS);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = MAX_CTAS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, lags_cluster_select<8>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// One tick: a cluster of `ctas` CTAs of `threads` threads, `per` lanes a
// thread (the wrapper's plan).  `vec` says the float pointers are 16-byte
// aligned and runnable `per`-byte aligned.  Returns a cudaError_t.
extern "C" int lags_select_launch(const float* load, const float* credit,
                                  const float* frac, const uint8_t* runnable,
                                  float* new_load, float* new_credit,
                                  int* picked, int T, int k, int ctas,
                                  int threads, int per, int vec, float y,
                                  float one_minus_y, float alpha,
                                  float one_minus_alpha, void* stream) {
  const long long span = static_cast<long long>(ctas) * threads * per;
  if (T < 1 || T > MAX_T || k < 1 || (k < T ? k : T) > MAX_PICKS ||
      ctas < 1 || ctas > MAX_CTAS || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || (per != 4 && per != 8) || span < T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = ctas > 1;  // one CTA: a plain launch, its own cluster
  const cudaError_t err =
      per == 4
          ? cudaLaunchKernelEx(&cfg, lags_cluster_select<4>, load, credit,
                               frac, runnable, new_load, new_credit, picked, T,
                               k, vec, y, one_minus_y, alpha, one_minus_alpha)
          : cudaLaunchKernelEx(&cfg, lags_cluster_select<8>, load, credit,
                               frac, runnable, new_load, new_credit, picked, T,
                               k, vec, y, one_minus_y, alpha, one_minus_alpha);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, for the floor of one launch under the same timer.
extern "C" int lags_select_empty_launch(void* stream) {
  lags_empty<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
