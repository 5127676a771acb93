// join_probe and join_expand: the residual's equi-join, from the right
// side's sorted keys to the (left row, right row) pairs.
//
// Replace no TPU kernel: the JAX package's hash_join
// (repro/queryproc/operators.py) expands its matches with numpy's
// np.repeat on the host. The port ran torch's chain instead: two
// searchsorted calls, then repeat_interleave twice (each with its own scan
// and host wait), an arange, a subtraction and a gather through the sort
// order. torch's expansion kernel gives one warp to each left row whatever
// its count, and the joins of the TPC-H mix probe unique keys, so almost
// every count is 0 or 1: a warp made two dependent loads to write at most
// one index, and 31 of its 32 lanes idled.
//
// join_probe: for each left key lk[i], its lower bound lo[i] in the sorted
// right keys rv and the number cnt[i] of right keys equal to it. Bound:
// bytes — lk read once (8 B a row), lo and cnt written once (12 B a row),
// rv read once. Design: a grid of resident blocks strides over the left
// rows, consecutive threads on consecutive rows. Each block first copies a
// sample of rv (every stride-th key, at most SAMPLES) into shared memory,
// so the top levels of each row's search are shared-memory loads that
// leave one stride of rv to search in device memory. There a binary search
// costs a random sector a level when the left keys come in random order,
// so the search starts from a guess interpolated between the two samples
// around the key (exact for keys dense in the stride, as TPC-H's are) and
// gallops from it (1, 2, 4, ... keys) before a binary search within the
// last step. The upper bound gallops the same way from lo, so a count of
// 0 or 1 costs one or two loads beside the lower bound. Streaming loads
// and stores for lk, lo and cnt leave L2 to rv.
//
// join_expand: the pairs, given lo and ends (the inclusive scan of cnt:
// left row i owns output rows [ends[i-1], ends[i])). Balanced over the
// merge of the left rows with the output rows (merge path): block p owns
// the EXPAND_NV merged items from diagonal p * EXPAND_NV, whatever mix of
// left rows and output rows they are, so a block costs the same at a
// fan-out of 0 or 1 as at one row matching 10^6. join_expand_split_kernel
// finds each block's first left row by a binary search over ends, one
// thread a block boundary. join_expand_kernel stages its left rows' ends,
// less its first output row, as int32 in shared memory; each thread finds
// the left row i of each of its outputs j by a binary search there (the
// step count is the block's, so no lane diverges), then writes
// l_idx[j] = i and r_idx[j] = r_order[lo[i] + j - ends[i-1]], consecutive
// threads on consecutive outputs, the loads of its EXPAND_VT outputs in
// flight together. Bound: bytes — ends read once (8 B a left row), lo of
// the matched rows, the r_order entries read, 16 B a pair written.
//
// Measured (chip_smoke.py, 60M random l_orderkey into orders' 15M keys;
// NVIDIA H100 80GB HBM3, 700.00 W): join_probe 9.43 ms with a plain binary
// search below the samples, 2.76 ms with the interpolated guess (bound
// 0.394); join_expand 2.19 ms (bound 0.609): each pair's r_order entry is
// a random 8-byte read that moves a 32-byte sector, and with the left keys
// sorted the same launch takes 0.87 ms. torch's searchsorted and
// repeat_interleave chain took 35.5 ms for the same pairs.
#include <climits>

#include <cuda_runtime.h>

#define PROBE_THREADS 256
#define PROBE_BLOCKS_PER_SM 8  // 2048 threads an SM, 16 KB of samples a block
#define SAMPLES 2048           // right keys a probe block keeps in shared memory
#define EXPAND_THREADS 256
#define EXPAND_VT 8            // output rows a thread writes, at most
#define EXPAND_NV (EXPAND_THREADS * EXPAND_VT)  // merged items a block

static __host__ __device__ long long min_ll(long long a, long long b) {
  return a < b ? a : b;
}

static __host__ __device__ long long max_ll(long long a, long long b) {
  return a > b ? a : b;
}

// The largest power of two <= n, 0 for n <= 0.
static __device__ int top_step(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

__global__ void __launch_bounds__(PROBE_THREADS)
join_probe_kernel(const long long* __restrict__ rv, long long n_right,
                  long long stride, int n_samples,
                  const long long* __restrict__ lk, long long n_left,
                  long long* __restrict__ lo_out, int* __restrict__ cnt_out) {
  __shared__ long long smp[SAMPLES];  // smp[s] = rv[s * stride]
  for (int s = threadIdx.x; s < n_samples; s += PROBE_THREADS)
    smp[s] = rv[s * stride];
  __syncthreads();
  const int top = top_step(n_samples);
  const long long step = (long long)gridDim.x * PROBE_THREADS;
  for (long long i = (long long)blockIdx.x * PROBE_THREADS + threadIdx.x;
       i < n_left; i += step) {
    const long long k = __ldcs(lk + i);
    int a = 0;  // samples below k
    for (int s = top; s > 0; s >>= 1)
      if (a + s <= n_samples && smp[a + s - 1] < k) a += s;
    // rv[(a - 1) * stride] < k <= rv[a * stride]: the lower bound lies in
    // ((a - 1) * stride, a * stride]
    long long lo = a == 0 ? 0 : (long long)(a - 1) * stride + 1;
    long long hi = a == n_samples ? n_right : (long long)a * stride;
    // a first guess between the two samples, by interpolation (exact for
    // keys dense in the window), then galloping from it to bracket the
    // lower bound and a binary search within the last step
    long long g = lo;
    if (a > 0 && a < n_samples) {
      const double kl = (double)smp[a - 1];
      double f = ((double)k - kl) / ((double)smp[a] - kl);
      f = f > 0.0 ? (f < 1.0 ? f : 1.0) : 0.0;  // NaN -> 0
      g = min_ll(max_ll(lo - 1 + __double2ll_rn(f * (double)(hi - lo + 1)),
                        lo), hi);
    }
    if (g < hi && rv[g] < k) {  // the lower bound lies in (g, hi]
      long long d = 1;
      while (g + d < hi && rv[g + d] < k) {
        g += d;
        d <<= 1;
      }
      lo = g + 1;
      hi = min_ll(g + d, hi);
    } else {  // it lies in [lo, g]
      long long d = 1;
      while (g - d >= lo && rv[g - d] >= k) {
        g -= d;
        d <<= 1;
      }
      lo = max_ll(g - d + 1, lo);
      hi = g;
    }
    while (lo < hi) {
      const long long m = lo + ((hi - lo) >> 1);
      if (rv[m] < k) lo = m + 1; else hi = m;
    }
    long long end = lo;  // the upper bound
    if (lo < n_right && rv[lo] == k) {
      long long last = lo, d = 1;  // rv[last] == k; gallop past it
      end = lo + 1;
      while (end < n_right && rv[end] == k) {
        last = end;
        d <<= 1;
        end = lo + d;
      }
      long long u0 = last + 1, u1 = min_ll(end, n_right);
      while (u0 < u1) {
        const long long m = u0 + ((u1 - u0) >> 1);
        if (rv[m] == k) u0 = m + 1; else u1 = m;
      }
      end = u0;
    }
    __stcs(lo_out + i, lo);
    __stcs(cnt_out + i, (int)(end - lo));
  }
}

// parts[p]: the left rows among the first min(p * EXPAND_NV, n_left +
// n_out) items of the merge, where left row i comes before output row j
// when ends[i] <= j.
__global__ void join_expand_split_kernel(const long long* __restrict__ ends,
                                         long long n_left, long long n_out,
                                         long long n_parts,
                                         long long* __restrict__ parts) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_parts) return;
  const long long d = min_ll(p * EXPAND_NV, n_left + n_out);
  long long lo = max_ll(0, d - n_out), hi = min_ll(d, n_left);
  while (lo < hi) {
    const long long m = lo + ((hi - lo) >> 1);
    if (ends[m] <= d - 1 - m) lo = m + 1; else hi = m;
  }
  parts[p] = lo;
}

__global__ void __launch_bounds__(EXPAND_THREADS)
join_expand_kernel(const long long* __restrict__ ends,
                   const long long* __restrict__ lo,
                   const long long* __restrict__ r_order,
                   const long long* __restrict__ parts, long long n_left,
                   long long n_out, long long* __restrict__ l_idx,
                   long long* __restrict__ r_idx) {
  // rel[0] = ends[a0 - 1] - b0 (the first row's start), rel[1 + t] =
  // ends[a0 + t] - b0: within [0, EXPAND_NV] for t >= 0, and rel[0] >=
  // -cnt[a0] > INT_MIN
  __shared__ int rel[EXPAND_NV + 1];
  const long long d0 = (long long)blockIdx.x * EXPAND_NV;
  const long long d1 = min_ll(d0 + EXPAND_NV, n_left + n_out);
  const long long a0 = parts[blockIdx.x], a1 = parts[blockIdx.x + 1];
  const long long b0 = d0 - a0;              // the block's first output row
  const int na = (int)(a1 - a0);             // left rows it spans
  const int nb = (int)(d1 - a1 - b0);        // output rows it writes
  for (int t = threadIdx.x; t <= na; t += EXPAND_THREADS) {
    const long long r = a0 - 1 + t;
    rel[t] = (int)((r < 0 ? 0 : __ldcs(ends + r)) - b0);
  }
  __syncthreads();
  const int top = top_step(na);
  long long row[EXPAND_VT], pos[EXPAND_VT];
#pragma unroll
  for (int v = 0; v < EXPAND_VT; ++v) {
    const int jj = v * EXPAND_THREADS + threadIdx.x;
    int c = 0;  // the block's left rows that end at or before b0 + jj
    for (int s = top; s > 0; s >>= 1)
      if (c + s <= na && rel[c + s] <= jj) c += s;
    row[v] = a0 + c;
    pos[v] = jj - rel[c];  // the pair's place among its row's matches
  }
#pragma unroll
  for (int v = 0; v < EXPAND_VT; ++v)
    if (v * EXPAND_THREADS + (int)threadIdx.x < nb) pos[v] += lo[row[v]];
#pragma unroll
  for (int v = 0; v < EXPAND_VT; ++v) {
    const int jj = v * EXPAND_THREADS + threadIdx.x;
    if (jj < nb) {
      __stcs(l_idx + b0 + jj, row[v]);
      __stcs(r_idx + b0 + jj, r_order[pos[v]]);
    }
  }
}

// rv: n_right >= 1 sorted int64 keys (fewer than 2^31, so a count fits
// int32); lk: n_left int64 keys; lo (n_left,) int64, cnt (n_left,) int32.
// A grid of at most PROBE_BLOCKS_PER_SM blocks on each of sms SMs.
extern "C" int join_probe_launch(const void* rv, long long n_right,
                                 const void* lk, long long n_left, void* lo,
                                 void* cnt, int sms, void* stream) {
  if (n_right < 1 || n_right > INT_MAX || n_left < 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  if (n_left > 0) {
    const long long stride = (n_right + SAMPLES - 1) / SAMPLES;
    const int n_samples = (int)((n_right + stride - 1) / stride);
    const long long blocks = min_ll((n_left + PROBE_THREADS - 1) /
                                    PROBE_THREADS,
                                    (long long)sms * PROBE_BLOCKS_PER_SM);
    join_probe_kernel<<<(unsigned)blocks, PROBE_THREADS, 0,
                        (cudaStream_t)stream>>>(
        static_cast<const long long*>(rv), n_right, stride, n_samples,
        static_cast<const long long*>(lk), n_left,
        static_cast<long long*>(lo), static_cast<int*>(cnt));
  }
  return (int)cudaGetLastError();
}

// The merged items a join_expand block owns; parts holds one entry more
// than the blocks.
extern "C" int join_expand_items_per_block() { return EXPAND_NV; }

// ends (n_left,) int64: the inclusive scan of the counts, ends[n_left - 1]
// == n_out; lo (n_left,) int64; r_order: the right rows in key order;
// parts (n_parts,) int64 scratch, n_parts = ceil((n_left + n_out) /
// EXPAND_NV) + 1; l_idx, r_idx (n_out,) int64.
extern "C" int join_expand_launch(const void* ends, const void* lo,
                                  const void* r_order, long long n_left,
                                  long long n_out, void* parts,
                                  long long n_parts, void* l_idx,
                                  void* r_idx, void* stream) {
  if (n_left < 1 || n_out < 0 ||
      n_parts != (n_left + n_out + EXPAND_NV - 1) / EXPAND_NV + 1)
    return (int)cudaErrorInvalidValue;
  if (n_out > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long* e = static_cast<const long long*>(ends);
    long long* p = static_cast<long long*>(parts);
    join_expand_split_kernel<<<(unsigned)((n_parts + 255) / 256), 256, 0,
                               s>>>(e, n_left, n_out, n_parts, p);
    join_expand_kernel<<<(unsigned)(n_parts - 1), EXPAND_THREADS, 0, s>>>(
        e, static_cast<const long long*>(lo),
        static_cast<const long long*>(r_order), p, n_left, n_out,
        static_cast<long long*>(l_idx), static_cast<long long*>(r_idx));
  }
  return (int)cudaGetLastError();
}
