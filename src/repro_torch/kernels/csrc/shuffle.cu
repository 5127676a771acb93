// hash_partition and fused_scan_shuffle: the storage side of the §4.2
// distributed shuffle.
//
// hash_partition replaces the TPU kernel repro/kernels/hash_partition.py
// (hash_partition -> pl.pallas_call): every row's target
// ((low32(key) * 2654435761 mod 2^32) >> 16) mod P and the rows per target.
// Bound: bytes — the keys read once and 4R bytes of pids written.
//
// fused_scan_shuffle replaces the TPU kernel
// repro/kernels/fused_scan_shuffle.py (fused_scan_shuffle ->
// pl.pallas_call): the predicate's packed words, every row's target, and
// the rows per target among the rows the predicate keeps, in one pass.
// Bound: bytes — the predicate columns and the keys read once, R/8 bytes of
// words and 4R bytes of pids written.
//
// Design: a warp takes tiles of 32 * TILE_K consecutive rows (lane l holds
// rows base + 32 * k + l, as program.cuh::eval_tile does), loads its
// TILE_K keys at once and hashes them in uint32 arithmetic, which wraps
// as the hash needs. The TPU's one-hot MXU histogram becomes counters in
// shared memory: for each row group the lanes that count a row find their
// peers with the same target (__match_any_sync) and the lowest of them adds
// the group's size, so the shared atomics per 32 rows are at most the
// number of distinct targets among them. At the end each block adds its
// non-zero counters to the global u64 histogram. fused_scan_shuffle forms
// its words with one __ballot_sync per row group, exactly as
// predicate_bitmap.cu, and counts only kept rows. Rows past R set no bit,
// write no pid and count nowhere, so no padding is needed. Comparisons run
// in each column's own type (program.cuh), not the TPU wrapper's f32.
#include "program.cuh"

#define THREADS 256
#define FULL 0xffffffffu
#define MAX_TARGETS 8192  // u32 shared counters: 32 KB, under the 48 KB default

__device__ __forceinline__ unsigned knuth_target(unsigned key, unsigned P) {
  return ((key * 2654435761u) >> 16) % P;
}

// Load and hash the tile's keys: bit k of the result says row r0 + 32 * k
// is in range; pid[k] is its target.
template <typename K>
__device__ __forceinline__ unsigned hash_tile(const K* __restrict__ keys,
                                              long long r0, long long R,
                                              unsigned P,
                                              unsigned (&pid)[TILE_K]) {
  K key[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const long long r = r0 + 32 * k;
    key[k] = r < R ? keys[r] : (K)0;
  }
  unsigned in = 0u;
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    pid[k] = knuth_target((unsigned)key[k], P);  // the key's low 32 bits
    in |= r0 + 32 * k < R ? 1u << k : 0u;
  }
  return in;
}

// Add the rows whose bit k of `count` is set to their targets' counters.
__device__ __forceinline__ void count_targets(unsigned* s_hist,
                                              const unsigned (&pid)[TILE_K],
                                              unsigned count, int lane) {
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const bool mine = (count >> k) & 1u;
    const unsigned active = __ballot_sync(FULL, mine);
    if (mine) {
      const unsigned peers = __match_any_sync(active, pid[k]);
      if (lane == __ffs(peers) - 1)
        atomicAdd(&s_hist[pid[k]], (unsigned)__popc(peers));
    }
  }
}

__device__ __forceinline__ void flush_targets(const unsigned* s_hist,
                                              unsigned P,
                                              unsigned long long* hist) {
  __syncthreads();
  for (unsigned t = threadIdx.x; t < P; t += blockDim.x)
    if (s_hist[t]) atomicAdd(&hist[t], (unsigned long long)s_hist[t]);
}

template <typename K>
__global__ void __launch_bounds__(THREADS)
hash_partition_kernel(const K* __restrict__ keys, long long R, unsigned P,
                      int* __restrict__ pids,
                      unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned s_hist[];
  for (unsigned t = threadIdx.x; t < P; t += blockDim.x) s_hist[t] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32 * TILE_K; base < R;
       base += n_warps * 32 * TILE_K) {
    const long long r0 = base + lane;
    unsigned pid[TILE_K];
    const unsigned in = hash_tile(keys, r0, R, P, pid);
#pragma unroll
    for (int k = 0; k < TILE_K; ++k)
      if ((in >> k) & 1u) pids[r0 + 32 * k] = (int)pid[k];
    count_targets(s_hist, pid, in, lane);
  }
  flush_targets(s_hist, P, hist);
}

template <typename K, bool POOL>
__global__ void __launch_bounds__(THREADS)
fused_scan_shuffle_kernel(const __grid_constant__ PredProgram P,
                          const K* __restrict__ keys, long long R,
                          unsigned n_targets, unsigned* __restrict__ words,
                          int* __restrict__ pids,
                          unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned s_hist[];
  for (unsigned t = threadIdx.x; t < n_targets; t += blockDim.x) s_hist[t] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long n_words = (R + 31) >> 5;
  for (long long base = warp * 32 * TILE_K; base < R;
       base += n_warps * 32 * TILE_K) {
    const long long r0 = base + lane;
    unsigned pid[TILE_K];
    const unsigned in = hash_tile(keys, r0, R, n_targets, pid);
    const unsigned keep = P.n_ops ? eval_tile<POOL>(P, r0, R) : in;
    unsigned mine = 0u;
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const unsigned w = __ballot_sync(FULL, (keep >> k) & 1u);
      if (lane == k) mine = w;
      if ((in >> k) & 1u) pids[r0 + 32 * k] = (int)pid[k];
    }
    const long long wi = (base >> 5) + lane;
    if (lane < TILE_K && wi < n_words) words[wi] = mine;
    count_targets(s_hist, pid, keep, lane);
  }
  flush_targets(s_hist, n_targets, hist);
}

static long long grid_for(long long R, int max_blocks) {
  const long long rows_per_block = (long long)THREADS * TILE_K;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  return blocks > max_blocks ? max_blocks : blocks;
}

// key_dt: DT_I32 or DT_I64 (program.cuh). pids (R,) int32; hist (P,) u64,
// zeroed by the caller. 1 <= P <= MAX_TARGETS.
extern "C" int hash_partition_launch(const void* keys, int key_dt,
                                     long long R, int P, void* pids,
                                     void* hist, int max_blocks,
                                     void* stream) {
  if (P < 1 || P > MAX_TARGETS || (key_dt != DT_I32 && key_dt != DT_I64))
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const unsigned blocks = (unsigned)grid_for(R, max_blocks);
    const size_t smem = (size_t)P * sizeof(unsigned);
    cudaStream_t s = (cudaStream_t)stream;
    int* pd = static_cast<int*>(pids);
    unsigned long long* h = static_cast<unsigned long long*>(hist);
    if (key_dt == DT_I32)
      hash_partition_kernel<int><<<blocks, THREADS, smem, s>>>(
          static_cast<const int*>(keys), R, (unsigned)P, pd, h);
    else
      hash_partition_kernel<long long><<<blocks, THREADS, smem, s>>>(
          static_cast<const long long*>(keys), R, (unsigned)P, pd, h);
  }
  return (int)cudaGetLastError();
}

// The program arguments as predicate_bitmap_launch takes them; n_ops == 0
// keeps every row. words (ceil(R/32),) u32.
extern "C" int fused_scan_shuffle_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    const long long* pool, int n_pool,
    const void* keys, int key_dt, long long R, int n_targets, void* words,
    void* pids, void* hist, int max_blocks, void* stream) {
  if (n_targets < 1 || n_targets > MAX_TARGETS ||
      (key_dt != DT_I32 && key_dt != DT_I64))
    return (int)cudaErrorInvalidValue;
  PredProgram P;
  const int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts,
                               col_ptrs, dtypes, n_cols, pool, n_pool);
  if (err) return err;
  if (R > 0) {
    const unsigned blocks = (unsigned)grid_for(R, max_blocks);
    const size_t smem = (size_t)n_targets * sizeof(unsigned);
    cudaStream_t s = (cudaStream_t)stream;
    unsigned* w = static_cast<unsigned*>(words);
    int* pd = static_cast<int*>(pids);
    unsigned long long* h = static_cast<unsigned long long*>(hist);
    const void* k = keys;
    const unsigned nt = (unsigned)n_targets;
    if (key_dt == DT_I32) {
      if (has_pool(P))
        fused_scan_shuffle_kernel<int, true><<<blocks, THREADS, smem, s>>>(
            P, static_cast<const int*>(k), R, nt, w, pd, h);
      else
        fused_scan_shuffle_kernel<int, false><<<blocks, THREADS, smem, s>>>(
            P, static_cast<const int*>(k), R, nt, w, pd, h);
    } else {
      if (has_pool(P))
        fused_scan_shuffle_kernel<long long, true>
            <<<blocks, THREADS, smem, s>>>(
                P, static_cast<const long long*>(k), R, nt, w, pd, h);
      else
        fused_scan_shuffle_kernel<long long, false>
            <<<blocks, THREADS, smem, s>>>(
                P, static_cast<const long long*>(k), R, nt, w, pd, h);
    }
  }
  return (int)cudaGetLastError();
}
