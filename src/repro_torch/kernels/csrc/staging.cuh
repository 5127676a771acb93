// Staging of predicate-column tiles in shared memory, shared by the kernels
// that interpret a program with program.cuh::eval_staged
// (predicate_bitmap.cu, fused_scan_agg.cu).
//
// A block of CONSUMER_WARPS + 1 warps keeps a ring of 2 to MAX_STAGES
// stages in dynamic shared memory, after a HEADER that holds the ring's
// mbarriers; a stage holds one tile of tile_rows consecutive rows of every
// distinct program column. The last warp is the producer (produce): for
// each tile it waits for its stage's "empty" barrier, then lane 0 starts
// one 1-D bulk copy (TMA, cp.async.bulk) per column for the tile's
// 16-byte-aligned interior while the lanes load the unaligned head and
// tail rows (a partition view may start on any row) with ordinary loads
// (fill_stage). The stage's "full" barrier completes after 32 producer
// arrivals and the copies' bytes. The consumer warps wait on "full", read
// the tile from shared memory, and arrive on "empty" (CONSUMER_WARPS
// arrivals) once they are done with it.
#pragma once

#include "program.cuh"

#define CONSUMER_WARPS 8
#define THREADS (32 * (CONSUMER_WARPS + 1))
#define SUB_ROWS (32 * TILE_K)  // one consumer warp's eval_staged
#define MAX_STAGES 4
#define HEADER 128              // mbarriers, ahead of the stages

// The per-SM shared memory of sm_90 and what the runtime keeps per block.
#define SMEM_PER_SM (228 * 1024)
#define SMEM_RESERVED (1024)

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

// Thread 0: make the ring's barriers (the caller syncs the block after).
__device__ __forceinline__ void init_ring(unsigned long long* full,
                                          unsigned long long* empty,
                                          int n_stages) {
  for (int s = 0; s < n_stages; ++s) {
    mbar_init(&full[s], 32);
    mbar_init(&empty[s], CONSUMER_WARPS);
  }
  mbar_fence_init();
}

// The producer warp's loop: stage tiles first, first + step, ... below end,
// one stage after another round the ring.
__device__ __forceinline__ void produce(const PredProgram& P,
                                        const StageLayout& L,
                                        unsigned char* stages,
                                        unsigned long long* full,
                                        unsigned long long* empty,
                                        long long R, long long first,
                                        long long end, long long step,
                                        int lane) {
  const long long T = L.tile_rows;
  int s = 0;
  unsigned phase = 0u;
  for (long long t = first; t < end; t += step) {
    mbar_wait(&empty[s], phase ^ 1u);  // the first pass finds it free
    const long long r0 = t * T;
    fill_stage(P, L, stages + (size_t)s * L.stage_bytes, &full[s], r0,
               min(T, R - r0), lane);
    if (++s == L.n_stages) { s = 0; phase ^= 1u; }
  }
}

// Pick the tile, the ring depth and the blocks per SM, with `extra` bytes
// of each block's shared memory kept for the kernel's own use: as many
// blocks per SM (up to max_bps) as hold two stages each, then up to
// MAX_STAGES stages a block; the tile halves (down to one sub-tile per
// consumer warp's share) until two stages fit in one block. More blocks
// mean more consumer warps an SM; on a 600,000-row partition most blocks
// get one tile, so these, not the ring, carry the time. Q19 with three
// blocks of two stages against two of three: 0.0138 -> 0.0121 ms on one
// partition, 0.3756 -> 0.3477 ms on 60M rows (NVIDIA H100 80GB HBM3,
// 700.00 W; profile_kernels.py, PERF.md). Returns whether two stages and
// `extra` fit (a program of no column needs no stage).
static bool plan_stages(StageLayout* L, const int* dtypes, int n_cols,
                        const long long* col_ptrs, long long extra,
                        int max_bps, int* blocks_per_sm) {
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
    int bps = max_bps;
    long long room = 0;
    for (;; --bps) {
      room = SMEM_PER_SM / bps - SMEM_RESERVED - HEADER - extra;
      if (bps == 1 || 2LL * bytes <= room) break;
    }
    if (2LL * bytes <= room || T == SUB_ROWS) {
      *blocks_per_sm = bps;
      const long long fit = bytes ? room / bytes : 0;
      L->n_stages = (int)(fit < MAX_STAGES ? fit : MAX_STAGES);
      return 2LL * bytes <= room;
    }
  }
}

// The deepest boolean stack the program builds (eval_staged's W).
static int stack_depth(const PredProgram& P) {
  int d = 0, most = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const int kind = P.ops[i].x & 15;
    d += kind == K_AND || kind == K_OR ? -1 : 1;
    most = d > most ? d : most;
  }
  return most;
}
