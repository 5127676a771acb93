// bitmap_apply: apply a packed selection bitmap to a column. Late
// materialisation: the column keeps its shape, dropped rows become zero,
// and the number of selected rows is counted.
//
// Replaces the TPU kernel repro/kernels/bitmap_apply.py
// (bitmap_apply -> pl.pallas_call), which unpacked the words with a
// broadcast variable shift and wrote a popcount per block for its wrapper
// to sum. Bound: bytes — R/8 bytes of words read, the column read once and
// written once, against 3.35 TB/s.
// Design: a warp takes 32 consecutive words (1024 rows) at a time. Lane l
// loads word l (one coalesced load), masks off the bits past R and
// popcounts it; then for each of the 32 words the warp broadcasts the word
// with __shfl_sync and lane l keeps or zeroes row l of it, so every load
// and store covers 32 consecutive elements. The block adds its lanes'
// popcounts and makes one global atomic. Values move as raw 4- or 8-byte
// words, so one kernel serves int32, int64, f32 and f64 and a kept value
// keeps every bit (-0.0, NaN); a dropped row gets all-zero bits, which is 0
// or +0.0.
#include <cuda_runtime.h>

#define THREADS 256
#define FULL 0xffffffffu

template <typename T>
__global__ void __launch_bounds__(THREADS)
bitmap_apply_kernel(const unsigned* __restrict__ words,
                    const T* __restrict__ col, long long R,
                    T* __restrict__ out,
                    unsigned long long* __restrict__ count) {
  __shared__ unsigned long long s_cnt[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long n_words = (R + 31) >> 5;
  unsigned long long cnt = 0ull;
  for (long long w0 = warp * 32; w0 < n_words; w0 += n_warps * 32) {
    const long long wi = w0 + lane;
    unsigned mine = 0u;
    if (wi < n_words) {
      mine = words[wi];
      const long long left = R - (wi << 5);  // rows this word covers, >= 1
      if (left < 32) mine &= (1u << left) - 1u;
    }
    cnt += __popc(mine);
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const unsigned w = __shfl_sync(FULL, mine, k);
      const long long r = ((w0 + k) << 5) + lane;
      if (r < R) out[r] = (w >> lane) & 1u ? col[r] : (T)0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL, cnt, off);
  if (lane == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0ull;
    for (int w = 0; w < THREADS / 32; ++w) total += s_cnt[w];
    atomicAdd(count, total);
  }
}

// elem_bytes: 4 or 8. count: one u64, zeroed by the caller.
extern "C" int bitmap_apply_launch(const void* words, const void* col,
                                   int elem_bytes, long long R, void* out,
                                   void* count, int max_blocks,
                                   void* stream) {
  if (elem_bytes != 4 && elem_bytes != 8) return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const long long words_per_block = (THREADS / 32) * 32;
    long long blocks = (((R + 31) >> 5) + words_per_block - 1) / words_per_block;
    if (blocks > max_blocks) blocks = max_blocks;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned* w = static_cast<const unsigned*>(words);
    unsigned long long* c = static_cast<unsigned long long*>(count);
    if (elem_bytes == 4)
      bitmap_apply_kernel<unsigned><<<(unsigned)blocks, THREADS, 0, s>>>(
          w, static_cast<const unsigned*>(col), R,
          static_cast<unsigned*>(out), c);
    else
      bitmap_apply_kernel<unsigned long long>
          <<<(unsigned)blocks, THREADS, 0, s>>>(
              w, static_cast<const unsigned long long*>(col), R,
              static_cast<unsigned long long*>(out), c);
  }
  return (int)cudaGetLastError();
}
