// predicate_bitmap: evaluate a postfix predicate program per row and pack
// 32 rows per uint32 word, least-significant bit first.
//
// Replaces the TPU kernel repro/kernels/predicate_bitmap.py
// (predicate_bitmap -> pl.pallas_call). Bound: bytes — each distinct
// predicate column read once and R/8 bytes of words written, against
// 3.35 TB/s.
//
// What held the first design back: a warp ran the program leaf after leaf,
// and each leaf loaded its own column and waited for those loads before the
// next leaf started, so every distinct column cost one serialised round
// trip to device memory per tile, and a column read by several leaves
// (Q19's l_quantity, by six) was loaded again from L1 for each.
//
// Design: the tiles are staged through shared memory. A persistent grid of
// up to three blocks per SM walks tiles of tile_rows consecutive rows. Each
// block keeps a ring of 2 to 4 stages in dynamic shared memory; a stage
// holds the block's next tile of every distinct program column. One
// producer warp fills the stages: lane 0 starts one 1-D bulk copy (TMA,
// cp.async.bulk) per column for the tile's 16-byte-aligned interior, and
// the lanes load the unaligned head and tail rows (a partition view may
// start on any row) with ordinary loads. Completion is counted on the
// stage's "full" mbarrier (32 producer arrivals plus the copies' bytes).
// Eight consumer warps interpret the program over the ready stage, reading
// leaves from shared memory, while the next stages load, then arrive on the
// stage's "empty" mbarrier. Every column is thus read from device memory
// exactly once per row, however many leaves read it, and the loads overlap
// the interpretation. With the loads out of the way the interpretation's
// instruction throughput is what is left, so the consumers run
// program.cuh::eval_staged: a stack of row masks (an AND or OR costs a few
// instructions for all of a lane's rows, not a few per row), no row bounds
// on full sub-tiles, 32-bit row numbers, and 32-bit compares for int32
// columns whose constants fit (narrow_int_leaves). Each consumer warp's
// 32 x TILE_K rows give TILE_K words by __ballot_sync, exactly the
// little-endian words of the first design, bit for bit.
#include "program.cuh"

#define CONSUMER_WARPS 8
#define THREADS (32 * (CONSUMER_WARPS + 1))
#define SUB_ROWS (32 * TILE_K)  // one consumer warp's eval_staged
#define MAX_STAGES 4
#define HEADER 128              // mbarriers, ahead of the stages

// Where each column's rows sit inside a stage; built by the host per launch.
struct StageLayout {
  int off[PP_MAX_COLS];      // row 0 of column c: region + its 16-byte head
  int region[PP_MAX_COLS];   // column c's 16-byte-aligned region in a stage
  int size[PP_MAX_COLS];     // bytes per value
  int n_cols, n_stages, tile_rows, stage_bytes;
};

// The producer warp: stage tile rows [r0, r0 + n) of every column.
__device__ __forceinline__ void fill_stage(const PredProgram& P,
                                           const StageLayout& L,
                                           unsigned char* st,
                                           unsigned long long* full,
                                           long long r0, long long n,
                                           int lane) {
  unsigned tx = 0u;
  for (int c = 0; c < L.n_cols; ++c) {
    const unsigned sz = (unsigned)L.size[c];
    const size_t a = (size_t)P.cols[c] + (size_t)r0 * sz;
    const size_t e = a + (size_t)n * sz;
    size_t lo = (a + 15) & ~(size_t)15, hi = e & ~(size_t)15;
    if (hi < lo) lo = hi = e;  // no aligned interior: every row by hand
    tx += (unsigned)(hi - lo);
    // head rows [0, n_head) and tail rows [tail, n) by ordinary loads
    const int n_head = (int)((lo - a) / sz), tail = (int)((hi - a) / sz);
    const int n_extra = n_head + (int)(n - tail);
    unsigned char* row0 = st + L.off[c];
    for (int x = lane; x < n_extra; x += 32) {
      const int i = x < n_head ? x : tail + (x - n_head);
      if (sz == 8)
        reinterpret_cast<long long*>(row0)[i] =
            reinterpret_cast<const long long*>(a)[i];
      else
        reinterpret_cast<int*>(row0)[i] = reinterpret_cast<const int*>(a)[i];
    }
  }
  if (lane == 0) {
    // this arrival comes after lane 0's own stores; the phase completes
    // once the other 31 lanes have arrived and the copies have landed
    mbar_arrive_expect_tx(full, tx);
    for (int c = 0; c < L.n_cols; ++c) {
      const unsigned sz = (unsigned)L.size[c];
      const size_t a = (size_t)P.cols[c] + (size_t)r0 * sz;
      const size_t e = a + (size_t)n * sz;
      const size_t lo = (a + 15) & ~(size_t)15, hi = e & ~(size_t)15;
      if (hi > lo)
        bulk_copy_g2s(st + L.region[c] + (lo - (a & ~(size_t)15)),
                      reinterpret_cast<const void*>(lo), (unsigned)(hi - lo),
                      full);
    }
  } else {
    mbar_arrive(full);
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS)
predicate_bitmap_kernel(const __grid_constant__ StagedProgram S,
                        const __grid_constant__ StageLayout L, long long R,
                        unsigned* __restrict__ words) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + MAX_STAGES;
  unsigned char* stages = smem + HEADER;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.n_stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long T = L.tile_rows;
  const long long n_tiles = (R + T - 1) / T;
  int s = 0;
  unsigned phase = 0u;
  if (warp == CONSUMER_WARPS) {
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      mbar_wait(&empty[s], phase ^ 1u);  // the first pass finds it free
      const long long r0 = t * T;
      fill_stage(S.p, L, stages + (size_t)s * L.stage_bytes, &full[s], r0,
                 min(T, R - r0), lane);
      if (++s == L.n_stages) { s = 0; phase ^= 1u; }
    }
    return;
  }
  const long long n_words = (R + 31) >> 5;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    mbar_wait(&full[s], phase);
    const long long r0 = t * T;
    const int n = (int)min(T, R - r0);
    const unsigned char* st = stages + (size_t)s * L.stage_bytes;
    for (int sub = warp; sub * SUB_ROWS < n; sub += CONSUMER_WARPS) {
      const int base = sub * SUB_ROWS;
      const unsigned keep =
          base + SUB_ROWS <= n
              ? eval_staged<W, true>(S, st, L.off, base + lane, n)
              : eval_staged<W, false>(S, st, L.off, base + lane, n);
      unsigned mine = 0u;
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
        const unsigned w = __ballot_sync(0xffffffffu, (keep >> k) & 1u);
        if (lane == k) mine = w;
      }
      const long long wi = ((r0 + sub * SUB_ROWS) >> 5) + lane;
      if (lane < TILE_K && wi < n_words) words[wi] = mine;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == L.n_stages) { s = 0; phase ^= 1u; }
  }
}

// The per-SM shared memory of sm_90 and what the runtime keeps per block.
#define SMEM_PER_SM (228 * 1024)
#define SMEM_RESERVED (1024)
#define MAX_BLOCKS_PER_SM 3  // 3 x 288 threads at 56 registers fit an SM

// Pick the tile, the ring depth and the blocks per SM: as many blocks per
// SM (up to MAX_BLOCKS_PER_SM) as hold two stages each, then up to
// MAX_STAGES stages a block; the tile halves (down to one sub-tile per
// consumer warp's share) until two stages fit in one block. More blocks
// mean more consumer warps an SM; on a 600,000-row partition most blocks
// get one tile, so these, not the ring, carry the time. Q19 with three
// blocks of two stages against two of three: 0.0138 -> 0.0121 ms on one
// partition, 0.3756 -> 0.3477 ms on 60M rows (NVIDIA H100 80GB HBM3,
// 700.00 W; profile_kernels.py, PERF.md).
static void plan_stages(StageLayout* L, const int* dtypes, int n_cols,
                        const long long* col_ptrs, int* blocks_per_sm) {
  memset(L, 0, sizeof(*L));
  L->n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c)
    L->size[c] = (dtypes[c] == DT_I64 || dtypes[c] == DT_F64) ? 8 : 4;
  for (int T = CONSUMER_WARPS * SUB_ROWS;; T /= 2) {
    int bytes = 0;
    for (int c = 0; c < n_cols; ++c) {
      L->region[c] = bytes;
      L->off[c] = bytes + (int)(col_ptrs[c] & 15);
      bytes += T * L->size[c] + 16;
    }
    L->tile_rows = T;
    L->stage_bytes = bytes;
    int bps = MAX_BLOCKS_PER_SM, room = 0;
    for (;; --bps) {
      room = SMEM_PER_SM / bps - SMEM_RESERVED - HEADER;
      if (bps == 1 || 2 * bytes <= room) break;
    }
    if (2 * bytes <= room || T == SUB_ROWS) {
      *blocks_per_sm = bps;
      L->n_stages = room / bytes < MAX_STAGES ? room / bytes : MAX_STAGES;
      return;
    }
  }
}

static int stack_depth(const PredProgram& P) {
  int d = 0, most = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const int kind = P.ops[i].x & 15;
    d += kind == K_AND || kind == K_OR ? -1 : 1;
    most = d > most ? d : most;
  }
  return most;
}

template <int W>
static int launch_staged(const StagedProgram& S, const StageLayout& L,
                         long long R, void* words, unsigned blocks,
                         size_t smem, cudaStream_t stream) {
  static const int opted = (int)cudaFuncSetAttribute(
      predicate_bitmap_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_PER_SM - SMEM_RESERVED);  // above 48 KB only after opting in
  if (opted) return opted;
  predicate_bitmap_kernel<W><<<blocks, THREADS, smem, stream>>>(
      S, L, R, static_cast<unsigned*>(words));
  return 0;
}

extern "C" int predicate_bitmap_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    long long R, int sms, void* words, void* stream) {
  PredProgram P;
  int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts, col_ptrs,
                         dtypes, n_cols);
  if (err) return err;
  if (n_cols < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    StageLayout L;
    int bps = 1;
    plan_stages(&L, dtypes, n_cols, col_ptrs, &bps);
    const StagedProgram S = narrow_int_leaves(P);
    const size_t smem = HEADER + (size_t)L.n_stages * L.stage_bytes;
    const long long n_tiles = (R + L.tile_rows - 1) / L.tile_rows;
    const long long cap = (long long)sms * bps;
    const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
    cudaStream_t s = (cudaStream_t)stream;
    err = stack_depth(P) <= 8
              ? launch_staged<1>(S, L, R, words, blocks, smem, s)
              : launch_staged<PP_MAX_DEPTH / 8>(S, L, R, words, blocks, smem, s);
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
