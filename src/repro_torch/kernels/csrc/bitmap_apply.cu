// bitmap_apply: apply packed selection bitmaps to columns, many
// (words, column) segments in one launch. Late materialisation: each
// column keeps its shape, dropped rows become zero, and the selected rows
// of each partition are counted.
//
// Replaces the TPU kernel repro/kernels/bitmap_apply.py
// (bitmap_apply -> pl.pallas_call), which unpacked the words with a
// broadcast variable shift and wrote a popcount per block for its wrapper
// to sum. Bound: bytes — the words read once, the kept rows' values read,
// and every row written, against 3.35 TB/s.
//
// What held the first design back: the Fig-3 compute side launched it once
// per partition and cached column (300 launches for Q19's apply), each over
// 600,000 rows: 74 blocks on 132 SMs, one pass of 32 words a warp, so each
// launch was a launch and one round trip to device memory (0.0132 ms
// against a 0.0008-0.0015 ms bound), and the host spent 11.67 ms issuing
// them (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Design: one launch takes a table of segments (words, column, output, R,
// element size, count slot), built on the host and copied once. The rows
// of each segment are cut into chunks of CHUNK_ROWS, a multiple of 32, so
// a chunk never crosses a segment or a word. A grid of as many blocks as
// are resident at once (BLOCKS_PER_SM an SM) walks the chunks of all
// segments, block b taking chunks b, b + grid, ... (each finds its segment
// by a binary search of the chunks' prefix table), so the grid fills the
// card whatever the partitions' sizes and neighbouring blocks write
// neighbouring rows. For a chunk, the block stages its words (and the
// word after it) in shared memory, masks the bits past R, and adds their
// popcount to the segment's count slot with one atomic; only a
// partition's first segment has a slot, so each partition is counted once.
// The next chunk's words are loaded while this one is stored, so their
// round trip to device memory is hidden. Each thread then moves 16 bytes
// at a time (4 rows of 4 bytes or 2 of 8): a funnel shift of two staged
// words gives the vector's bits, a vector none of whose rows is kept is
// not loaded and stores zeros, and the others store their kept values and
// zeros. The output of a segment starts at the same offset within 16
// bytes as its column (the wrapper places it so), so both sides of a
// vector are aligned; the rows before the column's first 16-byte boundary
// and after its last full vector go one at a time. Values move as raw 4-
// or 8-byte words, so one kernel serves int32, int64, f32 and f64 and a
// kept value keeps every bit (-0.0, NaN); a dropped row gets all-zero
// bits, which is 0 or +0.0.
//
// Measured (profile_kernels.py bitmap_apply; NVIDIA H100 80GB HBM3,
// 700.00 W): chunks of 4,096 or 8,192 rows, 4 to 8 blocks an SM, 2 to 8
// vectors in flight a thread, stores that evict first, and runs of
// consecutive chunks a block all land within 6% of one another. What
// keeps it near 60% of the bound is most likely the kept rows' reads: they
// move whole 32-byte sectors, which by count is about a third of the bytes
// written for Q19, and they interleave with the writes.
#include <cuda_runtime.h>

#define THREADS 256
#define BLOCKS_PER_SM 8  // 8 x 256 threads at up to 32 registers: all resident
#define CHUNK_WORDS 128  // words a chunk (at most THREADS: one a thread)
#define CHUNK_ROWS (32 * CHUNK_WORDS)
#define UNROLL 2         // vectors a thread has in flight
#define SEG_FIELDS 6     // words, column, output, R, element size, slot
#define FULL 0xffffffffu

// The segment of chunk c: the last one that starts at or before it (an
// empty segment has no chunk, so it starts where the next one does).
__device__ __forceinline__ int segment_of(const long long* first_chunk,
                                          int n_seg, long long c) {
  int s = 0, hi = n_seg;
  while (hi - s > 1) {
    const int mid = (s + hi) >> 1;
    if (first_chunk[mid] <= c) s = mid; else hi = mid;
  }
  while (first_chunk[s + 1] <= c) ++s;
  return s;
}

// The chunk's word of this thread (and, for thread 0, the word after the
// chunk), as loaded: the loads are issued a chunk ahead of their use.
struct ChunkWords {
  unsigned w, after;
};

__device__ __forceinline__ ChunkWords load_words(const long long* f,
                                                 long long lc) {
  const unsigned* words = reinterpret_cast<const unsigned*>(f[0]);
  const long long n_words = (f[3] + 31) >> 5;
  const long long wi = lc * CHUNK_WORDS + threadIdx.x;
  ChunkWords cw;
  cw.w = threadIdx.x < CHUNK_WORDS && wi < n_words ? words[wi] : 0u;
  cw.after = threadIdx.x == 0 && wi + CHUNK_WORDS < n_words
                 ? words[wi + CHUNK_WORDS] : 0u;
  return cw;
}

// Bits of rows at or past R cleared from word wi.
__device__ __forceinline__ unsigned mask_past(unsigned w, long long wi,
                                              long long R) {
  const long long left = R - (wi << 5);  // rows this word covers
  return left >= 32 ? w : left <= 0 ? 0u : w & ((1u << left) - 1u);
}

__device__ __forceinline__ uint4 keep_lanes(uint4 y, unsigned m, int vec) {
  if (vec == 4) {
    y.x = m & 1u ? y.x : 0u;
    y.y = m & 2u ? y.y : 0u;
    y.z = m & 4u ? y.z : 0u;
    y.w = m & 8u ? y.w : 0u;
  } else {
    y.x = m & 1u ? y.x : 0u;
    y.y = m & 1u ? y.y : 0u;
    y.z = m & 2u ? y.z : 0u;
    y.w = m & 2u ? y.w : 0u;
  }
  return y;
}

// Store UNROLL vectors of a thread, `stride` apart from vector i (below
// i1): a vector with a kept row loads its values first, a vector with none
// stores zeros. All the loads are issued before the first store, and every
// store instruction covers the warp's 32 vectors (a warp whose zero vectors
// were stored apart from its kept ones measured 1.40x slower).
template <typename T>
__device__ __forceinline__ void apply_vectors(const unsigned* s_words,
                                              const T* __restrict__ col,
                                              T* __restrict__ out, int h,
                                              long long row0, long long i,
                                              long long i1) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 x[UNROLL];
  unsigned m[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long iv = i + u * THREADS;
    m[u] = 0u;
    x[u] = make_uint4(0u, 0u, 0u, 0u);
    if (iv < i1) {
      const int local = (int)(h + VEC * iv - row0);  // in [0, CHUNK_ROWS)
      const unsigned long long pair =
          ((unsigned long long)s_words[(local >> 5) + 1] << 32) |
          s_words[local >> 5];
      m[u] = (unsigned)(pair >> (local & 31)) & ((1u << VEC) - 1u);
      if (m[u])
        x[u] = __ldg(reinterpret_cast<const uint4*>(col + h + VEC * iv));
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long iv = i + u * THREADS;
    if (iv < i1)
      *reinterpret_cast<uint4*>(out + h + VEC * iv) =
          keep_lanes(x[u], m[u], VEC);
  }
}

// Apply the chunk's staged words to rows [row0, row0 + n) of one segment
// of R rows; T is the element's raw type.
template <typename T>
__device__ __forceinline__ void apply_chunk(const unsigned* s_words,
                                            const unsigned* __restrict__ words,
                                            const T* __restrict__ col,
                                            T* __restrict__ out, long long R,
                                            long long row0, long long n,
                                            bool first, bool last) {
  constexpr int VEC = 16 / sizeof(T);
  const int h = (int)(((16 - ((size_t)col & 15)) & 15) / sizeof(T));
  const long long n_vec = R > h ? (R - h) / VEC : 0;
  const long long tail = h + VEC * n_vec;  // rows from here go one by one
  if (first && threadIdx.x < h && threadIdx.x < R) {
    const int r = threadIdx.x;  // rows before the first 16-byte boundary
    out[r] = (s_words[0] >> r) & 1u ? col[r] : (T)0;
  }
  if (last && threadIdx.x < R - tail) {
    const long long r = tail + threadIdx.x;
    out[r] = (words[r >> 5] >> (r & 31)) & 1u ? col[r] : (T)0;
  }
  // the vectors that start in this chunk
  const long long i0 = row0 <= h ? 0 : (row0 - h + VEC - 1) / VEC;
  long long i1 = (row0 + n - h + VEC - 1) / VEC;
  if (i1 > n_vec) i1 = n_vec;
  for (long long i = i0 + threadIdx.x; i < i1; i += THREADS * UNROLL)
    apply_vectors<T>(s_words, col, out, h, row0, i, i1);
}

// first_chunk: (n_seg + 1,) the first chunk of each segment and the total;
// segs: (n_seg, SEG_FIELDS) as bitmap_apply_launch describes.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
bitmap_apply_kernel(const long long* __restrict__ first_chunk,
                    const long long* __restrict__ segs, int n_seg,
                    unsigned long long* __restrict__ counts) {
  __shared__ unsigned s_words[CHUNK_WORDS + 1];
  __shared__ unsigned s_cnt[THREADS / 32];
  const long long n_chunks = first_chunk[n_seg];
  const long long step = gridDim.x;
  if (blockIdx.x >= n_chunks) return;
  int s = segment_of(first_chunk, n_seg, blockIdx.x);
  ChunkWords cw = load_words(segs + (size_t)s * SEG_FIELDS,
                             blockIdx.x - first_chunk[s]);
  for (long long c = blockIdx.x; c < n_chunks; c += step) {
    const long long* f = segs + (size_t)s * SEG_FIELDS;
    const long long R = f[3], slot = f[5];
    const long long lc = c - first_chunk[s];
    const long long row0 = lc * CHUNK_ROWS;
    const long long w0 = lc * CHUNK_WORDS;
    const unsigned w = mask_past(cw.w, w0 + threadIdx.x, R);
    if (threadIdx.x < CHUNK_WORDS) s_words[threadIdx.x] = w;
    if (threadIdx.x == 0)
      s_words[CHUNK_WORDS] = mask_past(cw.after, w0 + CHUNK_WORDS, R);
    const unsigned cnt = __reduce_add_sync(FULL, (unsigned)__popc(w));
    if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x == 0 && slot >= 0) {
      unsigned long long total = 0ull;
      for (int i = 0; i < THREADS / 32; ++i) total += s_cnt[i];
      if (total) atomicAdd(&counts[slot], total);
    }
    // the next chunk's words load while this chunk is stored
    int s_next = s;
    if (c + step < n_chunks) {
      s_next = segment_of(first_chunk, n_seg, c + step);
      cw = load_words(segs + (size_t)s_next * SEG_FIELDS,
                      c + step - first_chunk[s_next]);
    }
    const long long n = R - row0 < CHUNK_ROWS ? R - row0 : CHUNK_ROWS;
    const bool last = row0 + CHUNK_ROWS >= R;
    const unsigned* words = reinterpret_cast<const unsigned*>(f[0]);
    if (f[4] == 4)
      apply_chunk<unsigned>(s_words, words,
                            reinterpret_cast<const unsigned*>(f[1]),
                            reinterpret_cast<unsigned*>(f[2]), R, row0, n,
                            lc == 0, last);
    else
      apply_chunk<unsigned long long>(
          s_words, words, reinterpret_cast<const unsigned long long*>(f[1]),
          reinterpret_cast<unsigned long long*>(f[2]), R, row0, n, lc == 0,
          last);
    __syncthreads();  // s_words and s_cnt are the next chunk's
    s = s_next;
  }
}

// table: int64 on the card, (n_seg + 1) first chunks (ceil(R / CHUNK_ROWS)
// chunks a segment, prefix-summed), then n_seg rows of (words, column,
// output, R, element size 4 or 8, count slot or -1). Each output must start
// at the same offset within 16 bytes as its column. counts: u64 slots,
// zeroed by the caller.
extern "C" int bitmap_apply_launch(const void* table, int n_seg,
                                   long long n_chunks, void* counts,
                                   int sms, void* stream) {
  if (n_seg < 0 || n_chunks < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const long long cap = (long long)sms * BLOCKS_PER_SM;
    const unsigned blocks = (unsigned)(n_chunks < cap ? n_chunks : cap);
    const long long* t = static_cast<const long long*>(table);
    bitmap_apply_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        t, t + n_seg + 1, n_seg, static_cast<unsigned long long*>(counts));
  }
  return (int)cudaGetLastError();
}

// The rows of a chunk, for the wrapper's table.
extern "C" int bitmap_apply_chunk_rows() { return CHUNK_ROWS; }
