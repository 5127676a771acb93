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
// Design: the tiles are staged through shared memory (staging.cuh, shared
// with fused_scan_agg.cu). A persistent grid of up to three blocks per SM
// walks tiles of tile_rows consecutive rows. Each block keeps a ring of 2
// to 4 stages in dynamic shared memory; a stage holds the block's next
// tile of every distinct program column. One producer warp fills the
// stages: lane 0 starts one 1-D bulk copy (TMA, cp.async.bulk) per column
// for the tile's 16-byte-aligned interior, and the lanes load the
// unaligned head and tail rows (a partition view may start on any row)
// with ordinary loads. Completion is counted on the stage's "full"
// mbarrier (32 producer arrivals plus the copies' bytes).
// Eight consumer warps interpret the program over the ready stage, reading
// leaves from shared memory, while the next stages load, then arrive on the
// stage's "empty" mbarrier. Every column is thus read from device memory
// exactly once per row, however many leaves read it, and the loads overlap
// the interpretation. With the loads out of the way the interpretation's
// instruction throughput is what is left, so the consumers run
// program.cuh::eval_staged: a stack of row masks (an AND or OR costs a few
// instructions for all of a lane's rows, not a few per row), no row bounds
// on full sub-tiles, 32-bit row numbers, and 32-bit compares for columns
// that fit int32 whose constants fit too (narrow_int_leaves); each column is
// read from the stage at its stored width, 1 to 8 bytes (load_tile, one
// switch on its dtype a leaf). Each consumer warp's
// 32 x TILE_K rows give TILE_K words by __ballot_sync, exactly the
// little-endian words of the first design, bit for bit.
#include "staging.cuh"

#define MAX_BLOCKS_PER_SM 3  // 3 x 288 threads at 56 registers fit an SM

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
  if (threadIdx.x == 0) init_ring(full, empty, L.n_stages);
  __syncthreads();
  const long long T = L.tile_rows;
  const long long n_tiles = (R + T - 1) / T;
  if (warp == CONSUMER_WARPS) {
    produce(S.p, L, stages, full, empty, R, blockIdx.x, n_tiles, gridDim.x,
            lane);
    return;
  }
  int s = 0;
  unsigned phase = 0u;
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
    const long long* pool, int n_pool,
    long long R, int sms, void* words, void* stream) {
  PredProgram P;
  int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts, col_ptrs,
                         dtypes, n_cols, pool, n_pool);
  if (err) return err;
  if (n_cols < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    StageLayout L;
    int bps = 1;
    plan_stages(&L, dtypes, n_cols, col_ptrs, 0, MAX_BLOCKS_PER_SM, &bps);
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
