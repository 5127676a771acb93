// grouped_agg: per-group f64 sum and exact count of every row whose int32
// id lies in [0, G); other ids are dropped.
//
// Replaces the TPU kernel repro/kernels/grouped_agg.py (grouped_agg ->
// pl.pallas_call), a one-hot group matrix contracted on the MXU. Bound:
// bytes — ids (4 B) and values (4 or 8 B) read once, G sums and counts
// (16 B) written once, against 3.35 TB/s.
//
// What held the first design back (the fused_scan_agg body with an empty
// program): its shared-memory partials stopped at 3,072 groups, the 48 KB
// default, and above that every row added one f64 and one u64 atomic into
// device memory, which falls out of L2 once G passes about 3 million; and
// both outputs were zero-filled by two launches before the kernel.
//
// Design: the partials stay on chip, in one of three regimes that the
// wrapper picks from (R, G) (grouped_agg.py::plan, which the CPU tests
// cover):
// - smem: the groups are cut into n_ranges ranges of `per` groups, each of
//   which fits one block's opt-in 227 KB at 12 B a group (an f64 sum and a
//   u32 count; a block counts fewer than 2^32 rows), and the rows into
//   n_chunks chunks. Block (chunk c, range q) reads chunk c's ids, and the
//   values of the rows in range q, into partials in its shared memory; the
//   blocks of one chunk are adjacent, so the ids they share come from L2.
//   Over few groups warps first combine a tile's rows of one group in
//   registers (as fused_scan_agg does); over many, where rows rarely share
//   a group within a tile, every row adds its own shared atomics. With one
//   chunk each block writes its range
//   directly (no atomics, no zero-fill: the outputs are torch.empty); with
//   more, it adds its non-empty groups into zero-filled outputs.
// - l2: few rows a group (a residual's group-by) over outputs that fit
//   L2: zeroing and flushing a block's shared partials would cost as much
//   as the rows, so every row adds straight into the zero-filled outputs,
//   which stay in L2 (the same kernel with the outputs as its partials).
// - range: larger G, in four launches with no atomics to device memory.
//   Group ids are cut into buckets of 2^shift consecutive ids.
//   range_hist counts each block's rows per bucket in shared memory;
//   range_scan turns the (bucket, block) counts into offsets;
//   range_scatter writes each row's value and id within its bucket as one
//   record in bucket order, a tile at a time put in bucket order in shared memory so
//   that its stores come out in runs (wide buckets make the runs long: the
//   stores, not the reads, are this pass's cost); range_agg aggregates a
//   window of `win` groups of a bucket in one block's shared memory, the
//   windows of a bucket in adjacent blocks that share its rows in L2. When
//   one block owns a whole window (split == 1) it writes its sums and
//   counts directly, so the outputs need no zero-fill; a bucket split over
//   several blocks flushes each block's partials with atomics.
// (Partials spread over a cluster's distributed shared memory with remote
// atomics measured several times slower than range at 119,009 groups and
// were dropped; PERF.md has the numbers.)
// Sums accumulate in f64 whatever the value type; counts are exact. Atomic
// order varies run to run, so sums are reproducible only to a tolerance.
#include <type_traits>

#include "program.cuh"

#define FULL 0xffffffffu
#define SMEM_MAX (227 * 1024)  // a block's opt-in shared memory on sm_90
#define SCATTER_TILE 8192       // rows range_scatter puts in bucket order at once

__device__ __forceinline__ double value_at(const void* v, int vdt,
                                           long long r) {
  return vdt == DT_F64 ? static_cast<const double*>(v)[r]
                       : (double)static_cast<const float*>(v)[r];
}

// Zero n f64 sums and n u32 counts laid out back to back in shared memory.
__device__ __forceinline__ void zero_partials(double* s_sum, unsigned* s_cnt,
                                              int n) {
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    s_sum[g] = 0.0;
    s_cnt[g] = 0u;
  }
}

// ------------------------------------------------------------ smem and l2
// K rows a lane per tile. combine: warps combine a tile's rows by group
// for up to 8 rounds (K = 8); else every row adds its own atomics and its
// value is loaded with its id, in one round trip (K = 16: more loads in
// flight; the blocks of a chunk share the values in L2). L2: the l2
// regime, in which the partials are the zero-filled outputs themselves,
// kept in L2 (one range, n_chunks = the grid).
template <int K, bool L2>
__global__ void __launch_bounds__(1024)
agg_smem_kernel(const int* __restrict__ ids, const void* __restrict__ values,
                int vdt, long long R, int G, int per, int n_chunks,
                int combine, double* __restrict__ sums,
                unsigned long long* __restrict__ counts) {
  using Cnt = typename std::conditional<L2, unsigned long long, unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_sum;
  Cnt* s_cnt;
  if constexpr (L2) {
    s_sum = sums;
    s_cnt = counts;
  } else {
    s_sum = reinterpret_cast<double*>(smem);
    s_cnt = reinterpret_cast<unsigned*>(s_sum + per);
  }
  const int n_ranges = gridDim.x / n_chunks;
  const int q = blockIdx.x % n_ranges, chunk = blockIdx.x / n_ranges;
  const int g0 = q * per, gn = min(per, G - g0);
  if constexpr (!L2) zero_partials(s_sum, s_cnt, gn);
  __syncthreads();
  const bool has_values = vdt >= 0;
  const int rounds = combine ? 8 : 0;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)chunk * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)n_chunks * blockDim.x) >> 5;
  for (long long base = warp * 32 * K; base < R;
       base += n_warps * 32 * K) {
    const long long r0 = base + lane;
    unsigned g[K];  // the id within the block's range
    double v[K];
    unsigned pend = 0u;  // bit k: row k is in range and not yet added
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long r = r0 + 32 * k;
      g[k] = r < R ? (unsigned)ids[r] - (unsigned)g0 : 0xffffffffu;
      v[k] = !combine && has_values && r < R ? value_at(values, vdt, r)
                                             : 0.0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g[k] < (unsigned)gn) {
        pend |= 1u << k;
        if (combine && has_values) v[k] = value_at(values, vdt, r0 + 32 * k);
      }
    }
    for (int round = 0;; ++round) {
      const unsigned lanes = __ballot_sync(FULL, pend != 0u);
      if (!lanes) break;
      if (round == rounds) {  // then one shared atomic per row
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((pend >> k) & 1u) {
            if (has_values) atomicAdd(&s_sum[g[k]], v[k]);
            atomicAdd(&s_cnt[g[k]], (Cnt)1);
          }
        }
        break;
      }
      unsigned first = 0u;  // the group of this lane's lowest pending row
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if ((pend >> k) & 1u) first = g[k];
      const unsigned gs = __shfl_sync(FULL, first, __ffs(lanes) - 1);
      double x = 0.0;
      unsigned c = 0u;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool m = ((pend >> k) & 1u) && g[k] == gs;
        x += m ? v[k] : 0.0;
        c += m ? 1u : 0u;
        pend &= m ? ~(1u << k) : ~0u;
      }
      c = __reduce_add_sync(FULL, c);
      if (has_values) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
      }
      if (lane == 0) {
        if (has_values) atomicAdd(&s_sum[gs], x);
        atomicAdd(&s_cnt[gs], (Cnt)c);
      }
    }
  }
  if constexpr (L2) return;
  __syncthreads();
  for (int l = threadIdx.x; l < gn; l += blockDim.x) {
    if (n_chunks == 1) {
      sums[g0 + l] = s_sum[l];
      counts[g0 + l] = s_cnt[l];
    } else if (s_cnt[l]) {
      if (has_values) atomicAdd(&sums[g0 + l], s_sum[l]);
      atomicAdd(&counts[g0 + l], (unsigned long long)s_cnt[l]);
    }
  }
}

// ---------------------------------------------------------------- range
// Rows [blockIdx.x * chunk, ...) of every block; each counts its rows per
// bucket and writes them to hist[bucket * gridDim.x + blockIdx.x].
__global__ void __launch_bounds__(1024)
range_hist_kernel(const int* __restrict__ ids, long long R, int G, int shift,
                  int nb, long long chunk,
                  unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned s_hist[];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) s_hist[k] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(R, lo + chunk);
  for (long long base = lo + warp * 32 * TILE_K; base < hi;
       base += (long long)n_warps * 32 * TILE_K) {
    int g[TILE_K];
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const long long r = base + 32 * k + lane;
      g[k] = r < hi ? ids[r] : -1;
    }
#pragma unroll
    for (int k = 0; k < TILE_K; ++k)
      if ((unsigned)g[k] < (unsigned)G) atomicAdd(&s_hist[g[k] >> shift], 1u);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    hist[(long long)k * gridDim.x + blockIdx.x] = s_hist[k];
}

// One warp per bucket: an exclusive scan of its row of hist in place, and
// the bucket's total.
__global__ void range_scan_kernel(unsigned long long* __restrict__ hist,
                                  int nb, int nblk,
                                  unsigned long long* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const long long k = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (k >= nb) return;
  unsigned long long* row = hist + k * nblk;
  unsigned long long run = 0ull;
  for (int j0 = 0; j0 < nblk; j0 += 32) {
    const int j = j0 + lane;
    const unsigned long long x = j < nblk ? row[j] : 0ull;
    unsigned long long inc = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    if (j < nblk) row[j] = run + inc - x;
    run += __shfl_sync(FULL, inc, 31);
  }
  if (lane == 0) tot[k] = run;
}

// out[i] <- in[0] + ... + in[i - 1] over n entries of shared memory (in
// and out may be the same array), by the whole block; `warp_sums` holds 32
// entries.
template <typename T>
__device__ void block_exclusive_scan(const T* in, T* out, int n,
                                     unsigned long long* warp_sums) {
  const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  unsigned long long own = 0ull;
  for (int i = lo; i < hi; ++i) own += in[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    unsigned long long w = lane < n_warps ? warp_sums[lane] : 0ull, wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(FULL, wi, d);
      if (lane >= d) wi += y;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  unsigned long long run = warp_sums[warp] + inc - own;
  for (int i = lo; i < hi; ++i) {
    const unsigned long long x = in[i];
    out[i] = (T)run;
    run += x;
  }
  __syncthreads();
}

// The same blocks and chunks as range_hist. Each tile of SCATTER_TILE rows
// is first put in bucket order in shared memory (a count and a rank per
// row, a scan of the counts), then written out, so that consecutive
// threads store consecutive slots of one bucket: each row as one 16-byte
// record (its value, and its id within its bucket in the second word's
// bits) at the next free slot of this block's share. One record stream of
// whole sectors costs less than an id stream and a value stream.
__global__ void __launch_bounds__(1024)
range_scatter_kernel(const int* __restrict__ ids,
                     const void* __restrict__ values, int vdt, long long R,
                     int G, int shift, int nb, long long chunk,
                     const unsigned long long* __restrict__ off,
                     const unsigned long long* __restrict__ tot,
                     double2* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long warp_sums[32];
  unsigned long long* s_base = reinterpret_cast<unsigned long long*>(smem);
  double* s_val = reinterpret_cast<double*>(s_base + nb);  // SCATTER_TILE
  unsigned* s_id = reinterpret_cast<unsigned*>(s_val + SCATTER_TILE);
  unsigned* s_cnt = s_id + SCATTER_TILE;                   // nb
  unsigned* s_off = s_cnt + nb;                            // nb
  for (int k = threadIdx.x; k < nb; k += blockDim.x) s_base[k] = tot[k];
  __syncthreads();
  block_exclusive_scan(s_base, s_base, nb, warp_sums);  // the buckets' starts
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    s_base[k] += off[(long long)k * gridDim.x + blockIdx.x];
  const bool has_values = vdt >= 0;
  const long long lo = blockIdx.x * chunk;
  const long long hi = min(R, lo + chunk);
  constexpr int K = SCATTER_TILE / 1024;  // rows a thread holds
  for (long long t0 = lo; t0 < hi; t0 += (long long)K * blockDim.x) {
    for (int k = threadIdx.x; k < nb; k += blockDim.x) s_cnt[k] = 0u;
    __syncthreads();
    int g[K];
    double v[K];
    unsigned rank[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long r = t0 + (long long)k * blockDim.x + threadIdx.x;
      g[k] = r < hi ? ids[r] : -1;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long r = t0 + (long long)k * blockDim.x + threadIdx.x;
      v[k] = has_values && (unsigned)g[k] < (unsigned)G
                 ? value_at(values, vdt, r) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((unsigned)g[k] < (unsigned)G)
        rank[k] = atomicAdd(&s_cnt[(unsigned)g[k] >> shift], 1u);
    __syncthreads();
    block_exclusive_scan(s_cnt, s_off, nb, warp_sums);
    const int n_tile = (int)(s_off[nb - 1] + s_cnt[nb - 1]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((unsigned)g[k] < (unsigned)G) {
        const unsigned slot = s_off[(unsigned)g[k] >> shift] + rank[k];
        s_id[slot] = (unsigned)g[k];
        s_val[slot] = v[k];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile; i += blockDim.x) {
      const unsigned gi = s_id[i], b = gi >> shift;
      const unsigned long long pos = s_base[b] + (unsigned)(i - (int)s_off[b]);
      rec[pos] = make_double2(s_val[i],
                              __longlong_as_double(gi - (b << shift)));
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += blockDim.x) s_base[k] += s_cnt[k];
  }
}

// Block (bucket k, slice s, window w) aggregates the rows of its slice of
// bucket k whose id falls in window w (win groups) in shared memory, and
// writes or adds those groups. The wpb windows of one slice are adjacent
// blocks, so the rows they all read come from L2.
__global__ void __launch_bounds__(1024)
range_agg_kernel(const double2* __restrict__ rec, int has_values,
                 const unsigned long long* __restrict__ tot, int G, int shift,
                 int split, int wpb, int win, double* __restrict__ sums,
                 unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long warp_sums[32];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned* s_cnt = reinterpret_cast<unsigned*>(s_sum + win);
  const int w = blockIdx.x % wpb, ks = blockIdx.x / wpb;
  const int k = ks / split, s = ks % split;
  const long long g0 = ((long long)k << shift) + (long long)w * win;
  const int wn = (int)min((long long)win, (long long)G - g0);
  if (wn <= 0) return;  // past the last group: the whole block leaves
  // the bucket's first row: the sum of the totals before it
  unsigned long long before = 0ull;
  for (int j = threadIdx.x; j < k; j += blockDim.x) before += tot[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) before += __shfl_xor_sync(FULL, before, d);
  if (lane == 0) warp_sums[warp] = before;
  zero_partials(s_sum, s_cnt, wn);
  __syncthreads();
  before = 0ull;
  for (int j = 0; j < (int)(blockDim.x >> 5); ++j) before += warp_sums[j];
  const unsigned long long n_k = tot[k];
  const long long lo = (long long)(before + n_k * s / split);
  const long long hi = (long long)(before + n_k * (s + 1) / split);
  const long long w0 = (long long)w * win;
  for (long long r = lo + threadIdx.x; r < hi; r += blockDim.x) {
    const double2 x = rec[r];
    const long long l = __double_as_longlong(x.y) - w0;
    if (l >= 0 && l < wn) {
      if (has_values) atomicAdd(&s_sum[l], x.x);
      atomicAdd(&s_cnt[l], 1u);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < wn; q += blockDim.x) {
    if (split == 1) {
      sums[g0 + q] = s_sum[q];
      counts[g0 + q] = s_cnt[q];
    } else if (s_cnt[q]) {
      if (has_values) atomicAdd(&sums[g0 + q], s_sum[q]);
      atomicAdd(&counts[g0 + q], (unsigned long long)s_cnt[q]);
    }
  }
}

// ------------------------------------------------------------- launches
// Let `kernel` take all of a block's shared memory that its own static
// arrays leave.
template <typename K>
static int opt_in(K kernel) {
  cudaFuncAttributes a;
  const int err = (int)cudaFuncGetAttributes(&a, kernel);
  return err ? err : (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX - (int)a.sharedSizeBytes);
}

// vdt: -1 (counts only), DT_F32 or DT_F64. n_ranges * n_chunks blocks of
// `threads`, each with per * 12 bytes of partials (<= SMEM_MAX; n_ranges *
// per >= G). sums (G,) f64 and counts (G,) u64 are one buffer (counts =
// sums + G). With n_chunks == 1 every output is written; otherwise one
// memset zeroes both first.
extern "C" int grouped_agg_smem_launch(const void* ids, const void* values,
                                       int vdt, long long R, int G, int per,
                                       int n_ranges, int n_chunks,
                                       int combine, int threads, void* sums,
                                       void* counts, void* stream) {
  static const int opted = [] {
    const int e = opt_in(agg_smem_kernel<8, false>);
    return e ? e : opt_in(agg_smem_kernel<16, false>);
  }();
  if (opted) return opted;
  if (R <= 0 || G <= 0) return 0;
  double* su = static_cast<double*>(sums);
  if (counts != static_cast<void*>(su + G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 1) {
    const int err = (int)cudaMemsetAsync(sums, 0, (size_t)G * 16, s);
    if (err) return err;
  }
  auto kernel = combine ? agg_smem_kernel<8, false>
                        : agg_smem_kernel<16, false>;
  kernel<<<n_ranges * n_chunks, threads, (size_t)per * 12, s>>>(
      static_cast<const int*>(ids), values, vdt, R, G, per, n_chunks, combine,
      su, static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// The l2 regime: one memset of the outputs (one buffer, counts = sums + G),
// then `blocks` blocks of `threads` add every row into them with atomics.
extern "C" int grouped_agg_l2_launch(const void* ids, const void* values,
                                     int vdt, long long R, int G, int blocks,
                                     int threads, void* sums, void* counts,
                                     void* stream) {
  if (R <= 0 || G <= 0) return 0;
  double* su = static_cast<double*>(sums);
  if (counts != static_cast<void*>(su + G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(sums, 0, (size_t)G * 16, s);
  if (err) return err;
  agg_smem_kernel<8, true><<<blocks, threads, 0, s>>>(
      static_cast<const int*>(ids), values, vdt, R, G, G, blocks, 0, su,
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

// Buckets of 2^shift ids, nb of them (nb * 16 + SCATTER_TILE * 12 bytes <=
// SMEM_MAX); nblk blocks of 1024 for the histogram and the scatter, each
// over `chunk` rows; nb * split * wpb blocks aggregate, a window of `win`
// groups each (wpb windows cover a bucket). Scratch: hist (nb * nblk) and
// tot (nb) u64, rec (R) 16-byte records.
// sums and counts are one buffer (counts = sums + G). With split == 1 every
// output is written; otherwise one memset zeroes both first.
extern "C" int grouped_agg_range_launch(
    const void* ids, const void* values, int vdt, long long R, int G,
    int shift, int nb, int nblk, long long chunk, int split, int wpb,
    int win, void* hist, void* tot, void* rec, void* sums,
    void* counts, void* stream) {
  static const int opted = [] {
    int e = opt_in(range_hist_kernel);
    if (!e) e = opt_in(range_scatter_kernel);
    return e ? e : opt_in(range_agg_kernel);
  }();
  if (opted) return opted;
  if (R <= 0 || G <= 0) return 0;
  if (counts != static_cast<void*>(static_cast<double*>(sums) + G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (split > 1) {
    const int err = (int)cudaMemsetAsync(sums, 0, (size_t)G * 16, s);
    if (err) return err;
  }
  const int* id = static_cast<const int*>(ids);
  unsigned long long* h = static_cast<unsigned long long*>(hist);
  unsigned long long* t = static_cast<unsigned long long*>(tot);
  range_hist_kernel<<<nblk, 1024, (size_t)nb * 4, s>>>(id, R, G, shift, nb,
                                                        chunk, h);
  range_scan_kernel<<<(nb + 7) / 8, 256, 0, s>>>(h, nb, nblk, t);
  range_scatter_kernel<<<nblk, 1024, (size_t)nb * 16 + SCATTER_TILE * 12,
                         s>>>(
      id, values, vdt, R, G, shift, nb, chunk, h, t,
      static_cast<double2*>(rec));
  range_agg_kernel<<<nb * split * wpb, 1024, (size_t)win * 12, s>>>(
      static_cast<const double2*>(rec), vdt >= 0 ? 1 : 0, t, G, shift, split,
      wpb, win,
      static_cast<double*>(sums), static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}
