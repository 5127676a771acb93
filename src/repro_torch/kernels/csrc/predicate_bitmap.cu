// predicate_bitmap: evaluate a postfix predicate program per row and pack
// 32 rows per uint32 word, least-significant bit first.
//
// Replaces the TPU kernel repro/kernels/predicate_bitmap.py
// (predicate_bitmap -> pl.pallas_call). Bound: bytes — the predicate
// columns are read once and R/8 bytes are written, against 3.35 TB/s.
// Design: each warp takes tiles of 32 * TILE_K consecutive rows
// (program.cuh::eval_tile decodes each op once per tile). For each of the
// tile's TILE_K row groups the warp's __ballot_sync of `keep && row < R` is
// exactly the little-endian word, so the TPU wrapper's padding and tail
// masking are not needed; lane k keeps word k and the lanes store the
// tile's words together.
#include "program.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
predicate_bitmap_kernel(const __grid_constant__ PredProgram P, long long R,
                        unsigned* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long n_words = (R + 31) >> 5;
  for (long long base = warp * 32 * TILE_K; base < R;
       base += n_warps * 32 * TILE_K) {
    const unsigned keep = eval_tile(P, base + lane, R);
    unsigned mine = 0u;
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const unsigned w = __ballot_sync(0xffffffffu, (keep >> k) & 1u);
      if (lane == k) mine = w;
    }
    const long long wi = (base >> 5) + lane;
    if (lane < TILE_K && wi < n_words) words[wi] = mine;
  }
}

extern "C" int predicate_bitmap_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    long long R, void* words, int max_blocks, void* stream) {
  PredProgram P;
  const int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts,
                               col_ptrs, dtypes, n_cols);
  if (err) return err;
  if (R > 0) {
    const long long rows_per_block = (long long)THREADS * TILE_K;
    long long blocks = (R + rows_per_block - 1) / rows_per_block;
    if (blocks > max_blocks) blocks = max_blocks;
    predicate_bitmap_kernel<<<(unsigned)blocks, THREADS, 0,
                              (cudaStream_t)stream>>>(
        P, R, static_cast<unsigned*>(words));
  }
  return (int)cudaGetLastError();
}
