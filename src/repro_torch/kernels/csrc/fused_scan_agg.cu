// fused_scan_agg: predicate -> keep -> per-group sums of V value columns
// and a count, in one pass.
//
// Replaces the TPU kernel repro/kernels/fused_scan_agg.py
// (fused_scan_agg -> pl.pallas_call), which contracted a one-hot group
// matrix on the MXU, one value column per call. Bound: bytes — the
// predicate columns read once, kept x (4 + the value columns' bytes a row)
// for the ids and values of the kept rows (each value at its stored width,
// 1 to 8 bytes), and G x (8V + 8) of sums and counts written, against
// 3.35 TB/s.
//
// What held the first design back: the engine launched it once per summed
// column, so Q1's four sums evaluated the predicate and read the ids four
// times (4 x 0.4885 ms against one pass's 0.7071 ms bound), and its
// interpreter, which ran leaf after leaf on rows loaded from device memory,
// is limited by instruction issue.
//
// Design: V (0 to MAX_VALUES) value columns per launch, and the staging of
// predicate_bitmap.cu (staging.cuh): a persistent grid in which a producer
// warp stages tiles of the predicate columns into a ring of shared-memory
// stages by bulk copies, and eight consumer warps run eval_staged over the
// ready stage, one sub-tile of 32 x TILE_K rows each (lane l holds rows
// base + 32 * k + l). A consumer releases the stage as soon as its rows
// are evaluated, then loads the ids and values of its kept rows straight
// from device memory: a bulk copy cannot skip dropped rows, and Q6 keeps 2%
// of them; the values do not wait for the ids, so both come in one round
// trip. It then combines the sub-tile group by group: it takes the group of
// the lowest pending row, every lane sums its pending rows of that group in
// registers, the warp adds the count with one __reduce_add_sync and the V
// sums with one transposed shuffle tree (reduce_values: each step halves
// the sums a lane carries, so V = 4 costs 6 f64 shuffles, not 20), and
// lanes 0, 8, 16 and 24 add the V sums with one atomic each, at once.
// Rows of one group (keyless plans group by partition) cost one round a
// sub-tile, Q1's six groups six. Past a cap of rounds (ids spread over
// many groups) the remaining rows add V + 1 atomics each instead. Each
// block takes one run of consecutive tiles, so its rows touch few groups,
// and keeps f64 sums and u64 counts in shared memory when G x (8V + 8)
// bytes fit beside two stages in the opt-in 227 KB; it flushes its
// non-empty groups with global atomics at the end. Otherwise the atomics
// go to global memory directly. Sums accumulate in f64 whatever the value
// type; counts are exact. Atomic order varies run to run, so sums are
// reproducible only to a tolerance. Rows whose id lies outside [0, G) are
// dropped (the TPU wrapper's poison group G), so a bad id can never write
// out of bounds.
//
// Measured (profile_kernels.py fused_scan_agg; NVIDIA H100 80GB HBM3,
// 700.00 W): loading the values only once the ids had arrived cost Q1 one
// sum 0.6187 ms and Q6 0.6229 ms, against 0.4723 and 0.4567 when they load
// together. Evaluating the next tile while a tile's rows load moved one
// value within 3% either way and made four values spill (1.3451 ms), and
// a cap of 104 or 112 registers (__maxnreg__) in place of the launch
// bounds gave 1.57-1.85 ms: four values stay at 2 blocks an SM with the
// launch bounds' 96 registers and a little spill.
#include "staging.cuh"

#define MAX_VALUES 4
#define FULL 0xffffffffu

// V value columns, column j of dtype vdt[j] (program.cuh's DT_*), read at
// its stored width and summed in f64.
struct AggArgs {
  const int* ids;
  const void* vals[MAX_VALUES];
  int vdt[MAX_VALUES];
  long long R;
  int G, smem_partials;
  size_t partials;  // byte offset of the shared partials
  double* sums;     // (V, G)
  unsigned long long* counts;
};

// Blocks an SM: 3 x 288 threads leave 72 registers a thread, which a lane's
// TILE_K rows of one value fit; more values take 2 blocks.
template <int V>
struct Occupancy {
  static constexpr int blocks = V <= 1 ? 3 : 2;
};

template <int V>
struct Pow2 {  // V rounded up to a power of two, and its log
  static constexpr int n = V <= 1 ? 1 : V <= 2 ? 2 : 4;
  static constexpr int log = V <= 1 ? 0 : V <= 2 ? 1 : 2;
};

// Sum each of the N values over the warp. Each step halves the values a
// lane carries: the lanes with bit `off` set keep the upper half and send
// the lower, the others the reverse. Returns, in every lane, the warp's sum
// of value lane >> (5 - log2 N).
template <int N>
__device__ __forceinline__ double reduce_values(double (&x)[N], int lane) {
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2) {
    const int off = 16 * 2 * h / N;  // 16, 8, ... for h = N/2, N/4, ...
    const bool hi = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const double send = hi ? x[i] : x[i + h];
      const double keep = hi ? x[i + h] : x[i];
      x[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  double s = x[0];
#pragma unroll
  for (int off = 16 / N; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// One consumer warp's sub-tile: lane l's rows rb + 32 * k (k < TILE_K),
// their group ids (~0u for a dropped row) and values.
template <int V>
struct Rows {
  unsigned g[TILE_K];
  double v[TILE_K][V > 0 ? V : 1];
};

// Value column j's kept rows, read as C.
template <typename C, int V>
__device__ __forceinline__ void load_values(const void* p, int j,
                                            long long rb, unsigned keep,
                                            Rows<V>& x) {
#pragma unroll
  for (int k = 0; k < TILE_K; ++k)
    x.v[k][j] = (keep >> k) & 1u
                    ? (double)static_cast<const C*>(p)[rb + 32 * k] : 0.0;
}

// Issue the loads of the ids and values of the rows `keep` keeps. The
// values do not wait for the ids: a kept row's value is loaded whatever its
// id, so both come in one round trip to device memory. A value column's
// dtype is decided once, outside the row loop, so its TILE_K loads are in
// flight together: f64 and f32 by typed loads, the other dtypes (bool, the
// integers, f16) each at its stored width through load_f64.
template <int V>
__device__ __forceinline__ void load_rows(const AggArgs& A, long long rb,
                                          unsigned keep, Rows<V>& x) {
#pragma unroll
  for (int k = 0; k < TILE_K; ++k)
    x.g[k] = (keep >> k) & 1u ? (unsigned)A.ids[rb + 32 * k] : 0xffffffffu;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int dt = A.vdt[j];
    if (dt == DT_F64) {
      load_values<double>(A.vals[j], j, rb, keep, x);
    } else if (dt == DT_F32) {
      load_values<float>(A.vals[j], j, rb, keep, x);
    } else {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k)
        x.v[k][j] = (keep >> k) & 1u ? load_f64(dt, A.vals[j], rb + 32 * k)
                                     : 0.0;
    }
  }
}

// Add the loaded rows whose id lies in [0, G) into their groups.
template <int V>
__device__ __forceinline__ void add_rows(const AggArgs& A, double* dst_sum,
                                         unsigned long long* dst_cnt,
                                         int max_rounds, const Rows<V>& x,
                                         int lane) {
  constexpr int VP = Pow2<V>::n;
  const unsigned G = (unsigned)A.G;
  unsigned pend = 0u;  // bit k: row k is kept, in range and not yet added
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) pend |= x.g[k] < G ? 1u << k : 0u;
  for (int round = 0;; ++round) {
    const unsigned lanes = __ballot_sync(FULL, pend != 0u);
    if (!lanes) break;
    if (round == max_rounds) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
        if ((pend >> k) & 1u) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            atomicAdd(&dst_sum[(size_t)j * G + x.g[k]], x.v[k][j]);
          atomicAdd(&dst_cnt[x.g[k]], 1ull);
        }
      }
      break;
    }
    unsigned first = 0u;  // the group of this lane's lowest pending row
#pragma unroll
    for (int k = TILE_K - 1; k >= 0; --k)
      if ((pend >> k) & 1u) first = x.g[k];
    const unsigned gs = __shfl_sync(FULL, first, __ffs(lanes) - 1);
    double sum[VP];
#pragma unroll
    for (int j = 0; j < VP; ++j) sum[j] = 0.0;
    unsigned c = 0u;
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const bool m = ((pend >> k) & 1u) && x.g[k] == gs;
#pragma unroll
      for (int j = 0; j < V; ++j) sum[j] += m ? x.v[k][j] : 0.0;
      c += m ? 1u : 0u;
      pend &= m ? ~(1u << k) : ~0u;
    }
    c = __reduce_add_sync(FULL, c);
    if (V > 0) {
      const double s = reduce_values<VP>(sum, lane);
      const int j = lane >> (5 - Pow2<V>::log);
      if ((lane & (32 / VP - 1)) == 0 && j < V)
        atomicAdd(&dst_sum[(size_t)j * G + gs], s);
    }
    if (lane == 0) atomicAdd(&dst_cnt[gs], (unsigned long long)c);
  }
}

// The consumer warp's keep bits of tile t: its sub-tile of the staged tile
// through eval_staged (waiting for the stage and releasing it), or every
// row in range when there is no program.
template <int W>
__device__ __forceinline__ unsigned tile_keep(
    const StagedProgram& S, const StageLayout& L, const unsigned char* stages,
    unsigned long long* full, unsigned long long* empty, long long R,
    long long t, int base, int lane, int& s, unsigned& phase) {
  const long long T = L.tile_rows, r0 = t * T;
  const int n = (int)min(T, R - r0);
  unsigned keep = 0u;
  if (L.n_cols == 0) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k)
      keep |= base + lane + 32 * k < n ? 1u << k : 0u;
    return keep;
  }
  mbar_wait(&full[s], phase);
  const unsigned char* st = stages + (size_t)s * L.stage_bytes;
  if (base < n)
    keep = base + SUB_ROWS <= n
               ? eval_staged<W, true>(S, st, L.off, base + lane, n)
               : eval_staged<W, false>(S, st, L.off, base + lane, n);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[s]);
  if (++s == L.n_stages) { s = 0; phase ^= 1u; }
  return keep;
}

template <int V, int W>
__global__ void __launch_bounds__(THREADS, Occupancy<V>::blocks)
fused_scan_agg_kernel(const __grid_constant__ StagedProgram S,
                      const __grid_constant__ StageLayout L,
                      const __grid_constant__ AggArgs A) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + MAX_STAGES;
  unsigned char* stages = smem + HEADER;
  double* s_sum = reinterpret_cast<double*>(smem + A.partials);
  unsigned long long* s_cnt =
      reinterpret_cast<unsigned long long*>(s_sum + (size_t)V * A.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (L.n_cols > 0 && threadIdx.x == 0) init_ring(full, empty, L.n_stages);
  if (A.smem_partials) {
    for (int i = threadIdx.x; i < (V + 1) * A.G; i += blockDim.x)
      s_sum[i] = 0.0;  // the counts' zero bits too
  }
  __syncthreads();
  double* dst_sum = A.smem_partials ? s_sum : A.sums;
  unsigned long long* dst_cnt = A.smem_partials ? s_cnt : A.counts;
  // shared partials are cheap to combine into, global ones are not
  const int max_rounds = A.smem_partials ? 8 : 2;
  const long long T = L.tile_rows, R = A.R;
  const long long n_tiles = (R + T - 1) / T;
  // one run of consecutive tiles a block: its rows touch few groups
  const long long t0 = n_tiles * blockIdx.x / gridDim.x;
  const long long t1 = n_tiles * (blockIdx.x + 1) / gridDim.x;
  if (warp == CONSUMER_WARPS) {
    if (L.n_cols > 0) produce(S.p, L, stages, full, empty, R, t0, t1, 1, lane);
  } else {
    // a tile holds at most one sub-tile for each consumer warp
    const int base = warp * SUB_ROWS;
    int s = 0;
    unsigned phase = 0u;
    for (long long t = t0; t < t1; ++t) {
      const long long r0 = t * T;
      const unsigned keep = tile_keep<W>(S, L, stages, full, empty, R, t,
                                         base, lane, s, phase);
      if (base < min(T, R - r0)) {
        Rows<V> x;
        load_rows<V>(A, r0 + base + lane, keep, x);
        add_rows<V>(A, dst_sum, dst_cnt, max_rounds, x, lane);
      }
    }
  }
  if (A.smem_partials) {
    __syncthreads();
    for (int g = threadIdx.x; g < A.G; g += blockDim.x) {
      if (s_cnt[g]) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          atomicAdd(&A.sums[(size_t)j * A.G + g], s_sum[(size_t)j * A.G + g]);
        atomicAdd(&A.counts[g], s_cnt[g]);
      }
    }
  }
}

template <int V, int W>
static int launch_v(const StagedProgram& S, const StageLayout& L,
                    const AggArgs& A, unsigned blocks, size_t smem,
                    cudaStream_t stream) {
  static const int opted = (int)cudaFuncSetAttribute(
      fused_scan_agg_kernel<V, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_PER_SM - SMEM_RESERVED);  // above 48 KB only after opting in
  if (opted) return opted;
  fused_scan_agg_kernel<V, W><<<blocks, THREADS, smem, stream>>>(S, L, A);
  return 0;
}

template <int W>
static int launch_w(int V, const StagedProgram& S, const StageLayout& L,
                    const AggArgs& A, unsigned blocks, size_t smem,
                    cudaStream_t stream) {
  switch (V) {
    case 0: return launch_v<0, W>(S, L, A, blocks, smem, stream);
    case 1: return launch_v<1, W>(S, L, A, blocks, smem, stream);
    case 2: return launch_v<2, W>(S, L, A, blocks, smem, stream);
    case 3: return launch_v<3, W>(S, L, A, blocks, smem, stream);
    default: return launch_v<4, W>(S, L, A, blocks, smem, stream);
  }
}

// values: n_values (at most MAX_VALUES) column pointers, value_dt[j] the
// dtype code of column j (any DT_*). sums (n_values, G) f64 and counts (G,)
// u64 must be zeroed by the caller. n_cols = 0 (no program) keeps every
// row.
extern "C" int fused_scan_agg_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    const long long* pool, int n_pool,
    const void* ids, const long long* value_ptrs, const int* value_dt,
    int n_values, long long R, int G, void* sums, void* counts, int sms,
    void* stream) {
  PredProgram P;
  int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts, col_ptrs,
                         dtypes, n_cols, pool, n_pool);
  if (err) return err;
  if (n_values < 0 || n_values > MAX_VALUES || (n_ops > 0) != (n_cols > 0) ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  if (R <= 0 || G <= 0) return (int)cudaGetLastError();
  AggArgs A;
  memset(&A, 0, sizeof(A));
  A.ids = static_cast<const int*>(ids);
  for (int j = 0; j < n_values; ++j) {
    A.vals[j] = reinterpret_cast<const void*>(value_ptrs[j]);
    A.vdt[j] = value_dt[j];
  }
  A.R = R;
  A.G = G;
  A.sums = static_cast<double*>(sums);
  A.counts = static_cast<unsigned long long*>(counts);
  const int max_bps = n_values <= 1 ? 3 : 2;  // Occupancy<V>::blocks
  const long long partial_bytes = (long long)G * (8 * n_values + 8);
  StageLayout L;
  int bps = 1;
  A.smem_partials = plan_stages(&L, dtypes, n_cols, col_ptrs, partial_bytes,
                                max_bps, &bps);
  if (!A.smem_partials)
    plan_stages(&L, dtypes, n_cols, col_ptrs, 0, max_bps, &bps);
  A.partials = HEADER + (size_t)L.n_stages * L.stage_bytes;
  const size_t smem = A.partials + (A.smem_partials ? partial_bytes : 0);
  const long long n_tiles = (R + L.tile_rows - 1) / L.tile_rows;
  const long long cap = (long long)sms * bps;
  const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
  const StagedProgram S = narrow_int_leaves(P);
  cudaStream_t s = (cudaStream_t)stream;
  err = stack_depth(P) <= 8
            ? launch_w<1>(n_values, S, L, A, blocks, smem, s)
            : launch_w<PP_MAX_DEPTH / 8>(n_values, S, L, A, blocks, smem, s);
  if (err) return err;
  return (int)cudaGetLastError();
}
