// fused_scan_agg: predicate -> keep -> per-group sum and count.
//
// Replaces the TPU kernel repro/kernels/fused_scan_agg.py
// (fused_scan_agg -> pl.pallas_call), which contracted a one-hot group
// matrix on the MXU. Bound: bytes — the predicate columns are read once,
// ids (4 B) and values (4 or 8 B) of the kept rows, and G sums and counts
// written, against 3.35 TB/s.
//
// Design: each warp takes tiles of 32 * TILE_K consecutive rows (lane l
// holds rows base + 32 * k + l, as in program.cuh::eval_tile), evaluates
// the predicate, and loads ids and values of the kept rows only. It then
// combines the tile group by group: it takes the group of the lowest
// pending row, every lane sums its pending rows of that group in
// registers, one shuffle tree adds the lanes, and lane 0 adds the sum and
// count with one atomic each. Rows of one group (keyless plans group by
// partition) cost one round per tile, Q1's six groups six. Past
// MAX_ROUNDS rounds (ids spread over many groups) the remaining rows add
// one atomic each instead. For G <= SMEM_GROUPS each block keeps f64 sums
// and u64 counts in shared memory and flushes its non-empty groups with
// global atomics at the end; above that cap the atomics go to global
// memory directly. Sums accumulate in f64 whatever the value type; counts
// are exact. Atomic order varies run to run, so sums are reproducible only
// to a tolerance. Rows whose id lies outside [0, G) are dropped (the TPU
// wrapper's poison group G), so a bad id can never write out of bounds.
// (grouped_agg, which ran this body with an empty program, has its own
// kernels in grouped_agg.cu.)
#include "program.cuh"

#define THREADS 256
#define SMEM_GROUPS 3072  // 16 B per group: 48 KB, the default smem limit
#define FULL 0xffffffffu

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
fused_scan_agg_kernel(const __grid_constant__ PredProgram P,
                      const int* __restrict__ ids,
                      const void* __restrict__ values, int vdt, long long R,
                      int G, double* __restrict__ sums,
                      unsigned long long* __restrict__ counts) {
  // shared partials are cheap to combine into, global ones are not
  constexpr int MAX_ROUNDS = SMEM ? 8 : 2;
  extern __shared__ __align__(8) unsigned char smem[];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned long long* s_cnt = reinterpret_cast<unsigned long long*>(s_sum + G);
  if (SMEM) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      s_sum[g] = 0.0;
      s_cnt[g] = 0ull;
    }
    __syncthreads();
  }
  double* dst_sum = SMEM ? s_sum : sums;
  unsigned long long* dst_cnt = SMEM ? s_cnt : counts;
  const bool has_values = vdt >= 0;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32 * TILE_K; base < R;
       base += n_warps * 32 * TILE_K) {
    const long long r0 = base + lane;
    unsigned keep;
    if (P.n_ops) {
      keep = eval_tile(P, r0, R);
    } else {
      keep = 0u;
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) keep |= r0 + 32 * k < R ? 1u << k : 0u;
    }
    unsigned g[TILE_K];
    double v[TILE_K];
    unsigned pend = 0u;  // bit k: row k is kept, in range and not yet added
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const long long r = r0 + 32 * k;
      g[k] = (keep >> k) & 1u ? (unsigned)ids[r] : 0xffffffffu;
      v[k] = 0.0;
      if (g[k] < (unsigned)G) {
        pend |= 1u << k;
        if (has_values)
          v[k] = vdt == DT_F64 ? static_cast<const double*>(values)[r]
                               : (double)static_cast<const float*>(values)[r];
      }
    }
    for (int round = 0;; ++round) {
      const unsigned lanes = __ballot_sync(FULL, pend != 0u);
      if (!lanes) break;
      if (round == MAX_ROUNDS) {
#pragma unroll
        for (int k = 0; k < TILE_K; ++k) {
          if ((pend >> k) & 1u) {
            if (has_values) atomicAdd(&dst_sum[g[k]], v[k]);
            atomicAdd(&dst_cnt[g[k]], 1ull);
          }
        }
        break;
      }
      unsigned first = 0u;  // the group of this lane's lowest pending row
#pragma unroll
      for (int k = TILE_K - 1; k >= 0; --k)
        if ((pend >> k) & 1u) first = g[k];
      const unsigned gs = __shfl_sync(FULL, first, __ffs(lanes) - 1);
      double x = 0.0;
      unsigned c = 0u;
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
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
        if (has_values) atomicAdd(&dst_sum[gs], x);
        atomicAdd(&dst_cnt[gs], (unsigned long long)c);
      }
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      if (s_cnt[g]) {
        if (has_values) atomicAdd(&sums[g], s_sum[g]);
        atomicAdd(&counts[g], s_cnt[g]);
      }
    }
  }
}

static int launch_agg(const PredProgram& P, const void* ids,
                      const void* values, int vdt, long long R, int G,
                      void* sums, void* counts, int max_blocks,
                      void* stream) {
  if (R > 0 && G > 0) {
    const long long rows_per_block = (long long)THREADS * TILE_K;
    long long blocks = (R + rows_per_block - 1) / rows_per_block;
    if (blocks > max_blocks) blocks = max_blocks;
    cudaStream_t s = (cudaStream_t)stream;
    const int* id = static_cast<const int*>(ids);
    double* su = static_cast<double*>(sums);
    unsigned long long* co = static_cast<unsigned long long*>(counts);
    if (G <= SMEM_GROUPS)
      fused_scan_agg_kernel<true><<<(unsigned)blocks, THREADS,
                                    (size_t)G * 16, s>>>(P, id, values, vdt,
                                                         R, G, su, co);
    else
      fused_scan_agg_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
          P, id, values, vdt, R, G, su, co);
  }
  return (int)cudaGetLastError();
}

// vdt: -1 (no values: counts only), DT_F32 or DT_F64. sums (G,) f64 and
// counts (G,) u64 must be zeroed by the caller.
extern "C" int fused_scan_agg_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    const void* ids, const void* values, int vdt, long long R, int G,
    void* sums, void* counts, int max_blocks, void* stream) {
  PredProgram P;
  const int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts,
                               col_ptrs, dtypes, n_cols);
  if (err) return err;
  return launch_agg(P, ids, values, vdt, R, G, sums, counts, max_blocks,
                    stream);
}
