// hash_partition and fused_scan_shuffle: the storage side of the §4.2
// distributed shuffle.
//
// hash_partition replaces the TPU kernel repro/kernels/hash_partition.py
// (hash_partition -> pl.pallas_call): every row's target
// ((low32(key) * 2654435761 mod 2^32) >> 16) mod P and the rows per target.
// Bound: bytes — the keys read once and 4R bytes of pids written. A warp
// takes tiles of 32 * TILE_K consecutive rows (lane l holds rows
// base + 32 * k + l), loads its TILE_K keys at once and hashes them in
// uint32 arithmetic, which wraps as the hash needs. The TPU's one-hot MXU
// histogram becomes counters in shared memory: for each row group the
// lanes that count a row find their peers with the same target
// (__match_any_sync) and the lowest of them adds the group's size, so the
// shared atomics per 32 rows are at most the number of distinct targets
// among them. At the end each block adds its non-zero counters to the
// global u64 histogram.
//
// fused_scan_shuffle replaces the TPU kernel
// repro/kernels/fused_scan_shuffle.py (fused_scan_shuffle ->
// pl.pallas_call): the predicate's packed words, every row's target, and
// the rows per target among the rows the predicate keeps, in one pass.
// Bound: bytes — the predicate columns and the keys read once, R/8 bytes of
// words and 4R bytes of pids written.
//
// What held the first design back: it ran the program with hash_partition's
// warp tiles, leaf after leaf, and each leaf loaded its own column from
// device memory and waited for it before the next leaf started, so every
// distinct column cost one serialised round trip per tile and a column read
// by several leaves (Q19's l_quantity, by six) was loaded again for each; a
// pooled IN binary-searched its list in device memory, ceil(log2 n) + 1
// dependent warp-wide gathers a row; and every group of 32 rows paid a
// ballot, a __match_any_sync and shared atomics for the histogram. Q19
// took 0.7255 ms against a 0.4321 ms bound, a 512-value pooled IN 1.1978
// against 0.2172 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).
//
// Design: predicate_bitmap.cu's (staging.cuh). A persistent grid of up to
// three blocks an SM walks tiles of tile_rows consecutive rows; one
// producer warp stages each tile of every distinct program column and of
// the keys (the slot after the program's columns) into a ring of
// shared-memory stages by 1-D bulk copies (TMA) for the 16-byte-aligned
// interior and ordinary loads for a view's unaligned head and tail rows.
// Eight consumer warps each take a sub-tile of 32 x TILE_K rows of the
// ready stage: eval_staged gives the keep bits (narrow_int_leaves'
// 32-bit compares), the staged keys' low 32 bits give the targets (a key
// of any integer width or bool, a signed one sign-extended, as numpy's
// astype(np.uint64) does; 1- and 2-byte keys run in kernels of their own,
// so those of 4- and 8-byte keys keep their registers), and the warp
// releases the stage before it writes anything. Words come from one
// __ballot_sync per row group, exactly as predicate_bitmap.cu's; lane l
// writes the pids of rows base + 32k + l, so each store of the warp is 128
// contiguous bytes. At P <= REG_TARGETS each lane counts its kept rows per
// target in registers (4-bit fields a sub-tile, added into one counter per
// target), and the warp adds them with __reduce_add_sync and one shared
// atomic per target at the end; larger P keeps hash_partition's peer
// matching. Counts are integers, so the histogram is bitwise whatever the
// order. The program's pooled IN lists are copied at block start into the
// block's shared memory when they fit beside the stages and the counters,
// each as entries of its comparison type (the int64 list of a column that
// fits int32 narrowed to its values in int32 range: no other value can
// equal a row)
// laid out as a breadth-first search tree, whose first six levels sit in
// distinct banks, and the pooled leaf searches that copy (ShufflePool); a
// pool too large for shared memory is searched in device memory. Where
// one stage a block gives every tile a block of its own (one partition:
// 293 tiles of Q19 against 264 blocks of two stages), each block takes one
// tile. Rows past
// R set no bit, write no pid and count nowhere, so no padding is needed.
// Comparisons run in each column's own type (program.cuh), not the TPU
// wrapper's f32.
//
// Measured (profile_kernels.py fused_scan_shuffle, parent and this design
// in one call; NVIDIA H100 80GB HBM3, 700.00 W): Q19 at 60M rows 0.7214 ->
// 0.5077 ms (bound 0.4321), Q3 0.3328 -> 0.2621 (bound 0.2172), the
// 512-value pooled IN 1.1919 -> 0.3476 (bound 0.2172; 0.5057 in an
// earlier call with the shared copy in sorted order), Q19 with int64 keys 0.7345 -> 0.5862
// (bound 0.5037). Peer matching at P = 9 cost Q19 under 2% against the
// register counters at P = 4 (it keeps 4% of its rows). One partition
// from row 1 (600,000 rows) 0.0174 -> 0.0185 ms, 0.0203 before a block
// took one tile.
#include <algorithm>

#include "staging.cuh"

#define HASH_THREADS 256  // hash_partition's blocks
#define FULL 0xffffffffu
#define MAX_TARGETS 8192  // u32 shared counters: 32 KB
#define REG_TARGETS 8     // at most this many targets count in registers
#define SHUFFLE_BLOCKS_PER_SM 3
#define POOL_OFF_SHIFT 12  // op.x >> 12: a staged list's byte offset

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
__global__ void __launch_bounds__(HASH_THREADS)
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

// ---- fused_scan_shuffle -----------------------------------------------------
struct ShuffleArgs {
  long long R;
  unsigned n_targets;
  int key_shift;  // 4- and 8-byte keys: the low 32 bits of row r's key are
                  // staged 32-bit word r << key_shift (little-endian)
  int key_dt;     // 1- and 2-byte keys: their dtype (program.cuh)
  int hist_off;   // byte offset of the shared counters
  int pool_off;   // byte offset of the shared pool; -1: not staged
  unsigned* words;
  int* pids;
  unsigned long long* hist;
};

// A pooled list of n values in shared memory is a complete binary search
// tree of levels(n) levels in breadth-first order (Eytzinger): node t's
// children are 2t and 2t + 1, node 0 is unused, and the nodes past the
// list's end repeat its greatest value (the list stays sorted in order).
// A search's first six steps then read from at most 32 consecutive
// entries, so a warp's loads of one step fall in distinct banks (4-byte
// entries); in sorted order the candidates of those steps lie a power of
// two of 32 or more entries apart, all in one bank.
__host__ __device__ __forceinline__ int levels(int n) {
  int d = 0;
  while ((1ll << d) - 1 < n) ++d;
  return d;
}

// The bytes of a pooled list's entry: its comparison type's.
static inline int pool_entry_bytes(int mode) {
  return mode == MODE_I32 || mode == MODE_F32 ? 4 : 8;
}

// The shuffle's pooled IN: its tree in the block's shared copy, op.x >>
// POOL_OFF_SHIFT bytes in, as entries of the comparison type T, when the
// launch staged the pool; else the program's sorted list in device memory.
// Bit k: does the list hold x[k]? Each lane takes levels(n) steps down the
// tree (the same in every lane, TILE_K independent loads a step) to the
// leaf below x[k]'s lower bound; stripping the trailing right turns and one
// left turn from its index gives the lower bound's node (0: none). NaN goes
// left at every node and equals nothing.
struct ShufflePool {
  const long long* global;
  const unsigned char* shared;  // nullptr: not staged
  template <typename T>
  __device__ __forceinline__ unsigned in(int4 op, const T (&x)[TILE_K]) const {
    if (shared == nullptr) return pool_in<T>(global, op.z, op.w, x);
    const T* tree = reinterpret_cast<const T*>(shared + (op.x >> POOL_OFF_SHIFT));
    unsigned t[TILE_K];
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) t[k] = 1u;
    for (int d = levels(op.w); d > 0; --d) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k)
        t[k] = 2u * t[k] + (tree[t[k]] < x[k] ? 1u : 0u);
    }
    unsigned m = 0u;
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const unsigned j = t[k] >> __ffs(~t[k]);
      m |= j != 0u && tree[j] == x[k] ? 1u << k : 0u;
    }
    return m;
  }
};

// Every thread of the block: copy each pooled list into the shared pool as
// the tree of entries of its comparison type.
__device__ __forceinline__ void stage_pool(const PredProgram& P,
                                           unsigned char* pool) {
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    if ((op.x & 15) != K_IN_POOL || op.w == 0) continue;
    const int mode = (op.x >> 8) & 7, d = levels(op.w);
    unsigned char* dst = pool + (op.x >> POOL_OFF_SHIFT);
    for (int j = threadIdx.x + 1; j < 1 << d; j += blockDim.x) {
      // node j on level l holds the in-order rank (2 (j - 2^l) + 1) 2^(d-l-1) - 1
      const int l = 31 - __clz(j);
      const int rank = ((2 * (j - (1 << l)) + 1) << (d - l - 1)) - 1;
      const long long v = P.pool[op.z + min(rank, op.w - 1)];
      if (mode == MODE_I32)
        reinterpret_cast<int*>(dst)[j] = (int)v;
      else if (mode == MODE_F32)
        reinterpret_cast<float*>(dst)[j] = (float)__longlong_as_double(v);
      else
        reinterpret_cast<long long*>(dst)[j] = v;  // int64 values, f64 bits
    }
  }
}

// The low 32 bits of the staged keys of the lane's rows r0 + 32 * k, read
// as K (a signed key sign-extended, as numpy's astype(np.uint64) does);
// an 8-byte key's low word is the 32-bit word 2r (little-endian).
template <typename K, int SHIFT, bool WHOLE>
__device__ __forceinline__ void staged_keys(const unsigned char* p, int r0,
                                            int n, unsigned (&key)[TILE_K]) {
  const K* kp = reinterpret_cast<const K*>(p);
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const int r = r0 + 32 * k;
    key[k] = WHOLE || r < n ? (unsigned)kp[r << SHIFT] : 0u;
  }
}

// The staged 1- or 2-byte keys of dtype dt (bool, uint8, int8, int16 or
// uint16), one switch outside the row loop.
template <bool WHOLE>
__device__ __forceinline__ void narrow_keys(int dt, const unsigned char* p,
                                            int r0, int n,
                                            unsigned (&key)[TILE_K]) {
  switch (dt) {
    case DT_BOOL:
    case DT_U8: staged_keys<unsigned char, 0, WHOLE>(p, r0, n, key); return;
    case DT_I8: staged_keys<signed char, 0, WHOLE>(p, r0, n, key); return;
    case DT_I16: staged_keys<short, 0, WHOLE>(p, r0, n, key); return;
    default: staged_keys<unsigned short, 0, WHOLE>(p, r0, n, key); return;
  }
}

// A consumer warp's sub-tile of the staged tile (lane l: rows r0 + 32 * k,
// r0 = the sub-tile's base + l): the keep bits, every row's target in pid.
// NARROW: 1- or 2-byte keys (another instantiation, so the kernels of 4-
// and 8-byte keys keep the registers they had).
template <int W, bool WHOLE, bool NARROW>
__device__ __forceinline__ unsigned read_sub_tile(
    const StagedProgram& S, const StageLayout& L, const unsigned char* st,
    const ShufflePool& pool, const ShuffleArgs& A, int r0, int n,
    unsigned (&pid)[TILE_K]) {
  unsigned in = 0u;
  if constexpr (NARROW) {
    unsigned key[TILE_K];
    narrow_keys<WHOLE>(A.key_dt, st + L.off[L.n_cols - 1], r0, n, key);
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      pid[k] = knuth_target(key[k], A.n_targets);
      in |= WHOLE || r0 + 32 * k < n ? 1u << k : 0u;
    }
  } else {
    const unsigned* key =
        reinterpret_cast<const unsigned*>(st + L.off[L.n_cols - 1]);
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) {
      const int r = r0 + 32 * k;
      const bool ok = WHOLE || r < n;
      pid[k] = knuth_target(ok ? key[r << A.key_shift] : 0u, A.n_targets);
      in |= ok ? 1u << k : 0u;
    }
  }
  return S.p.n_ops ? eval_staged<W, WHOLE>(S, st, L.off, r0, n, pool) : in;
}

template <int W, bool REG, bool NARROW>
__global__ void __launch_bounds__(THREADS, SHUFFLE_BLOCKS_PER_SM)
fused_scan_shuffle_kernel(const __grid_constant__ StagedProgram S,
                          const __grid_constant__ StageLayout L,
                          const __grid_constant__ ShuffleArgs A) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + MAX_STAGES;
  unsigned char* stages = smem + HEADER;
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem + A.hist_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (unsigned t = threadIdx.x; t < A.n_targets; t += blockDim.x)
    s_hist[t] = 0u;
  if (A.pool_off >= 0) stage_pool(S.p, smem + A.pool_off);
  if (threadIdx.x == 0) init_ring(full, empty, L.n_stages);
  __syncthreads();
  const long long T = L.tile_rows, R = A.R;
  const long long n_tiles = (R + T - 1) / T;
  if (warp == CONSUMER_WARPS) {
    produce(S.p, L, stages, full, empty, R, blockIdx.x, n_tiles, gridDim.x,
            lane);
  } else {
    const ShufflePool pool{S.p.pool,
                           A.pool_off >= 0 ? smem + A.pool_off : nullptr};
    // a tile holds at most one sub-tile for each consumer warp
    const int base = warp * SUB_ROWS, rb = base + lane;
    const long long n_words = (R + 31) >> 5;
    unsigned cnt[REG ? REG_TARGETS : 1];
#pragma unroll
    for (int j = 0; j < (REG ? REG_TARGETS : 1); ++j) cnt[j] = 0u;
    int s = 0;
    unsigned phase = 0u;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const long long r0 = t * T;
      const int n = (int)min(T, R - r0);
      const bool whole = base + SUB_ROWS <= n;
      mbar_wait(&full[s], phase);
      const unsigned char* st = stages + (size_t)s * L.stage_bytes;
      unsigned keep = 0u, pid[TILE_K];
      if (base < n)
        keep = whole
                   ? read_sub_tile<W, true, NARROW>(S, L, st, pool, A, rb,
                                                    n, pid)
                   : read_sub_tile<W, false, NARROW>(S, L, st, pool, A, rb,
                                                     n, pid);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
      if (++s == L.n_stages) { s = 0; phase ^= 1u; }
      if (base >= n) continue;
      unsigned mine = 0u;
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
        const unsigned w = __ballot_sync(FULL, (keep >> k) & 1u);
        if (lane == k) mine = w;
      }
      const long long wi = ((r0 + base) >> 5) + lane;
      if (lane < TILE_K && wi < n_words) A.words[wi] = mine;
      int* out = A.pids + r0 + rb;
#pragma unroll
      for (int k = 0; k < TILE_K; ++k)
        if (whole || rb + 32 * k < n) out[32 * k] = (int)pid[k];
      if (REG) {
        // 4-bit fields: a lane keeps at most TILE_K (8) rows a sub-tile
        unsigned packed = 0u;
#pragma unroll
        for (int k = 0; k < TILE_K; ++k)
          packed += ((keep >> k) & 1u) << (4 * pid[k]);
#pragma unroll
        for (int j = 0; j < (REG ? REG_TARGETS : 1); ++j)
          cnt[j] += (packed >> (4 * j)) & 15u;
      } else {
        count_targets(s_hist, pid, keep, lane);
      }
    }
    if (REG) {
#pragma unroll
      for (int j = 0; j < (REG ? REG_TARGETS : 1); ++j) {
        const unsigned c = __reduce_add_sync(FULL, cnt[j]);
        if (lane == 0 && c) atomicAdd(&s_hist[j], c);
      }
    }
  }
  flush_targets(s_hist, A.n_targets, A.hist);
}

static long long grid_for(long long R, int max_blocks) {
  const long long rows_per_block = (long long)HASH_THREADS * TILE_K;
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  return blocks > max_blocks ? max_blocks : blocks;
}

// Whether a dtype code is a key's: a bool or an integer.
static bool key_dtype(int dt) {
  return dt == DT_BOOL || dt == DT_U8 || dt == DT_I8 || dt == DT_I16 ||
         dt == DT_U16 || dt == DT_I32 || dt == DT_U32 || dt == DT_I64 ||
         dt == DT_U64;
}

template <typename K>
static void launch_hash(const void* keys, long long R, int P, int* pids,
                        unsigned long long* hist, unsigned blocks,
                        cudaStream_t s) {
  const size_t smem = (size_t)P * sizeof(unsigned);
  hash_partition_kernel<K><<<blocks, HASH_THREADS, smem, s>>>(
      static_cast<const K*>(keys), R, (unsigned)P, pids, hist);
}

// key_dt: a bool or integer dtype (program.cuh), read at its stored width,
// one instantiation a width and signedness (the hash needs the key's low 32
// bits, a signed key sign-extended). pids (R,) int32; hist (P,) u64,
// zeroed by the caller. 1 <= P <= MAX_TARGETS.
extern "C" int hash_partition_launch(const void* keys, int key_dt,
                                     long long R, int P, void* pids,
                                     void* hist, int max_blocks,
                                     void* stream) {
  if (P < 1 || P > MAX_TARGETS || !key_dtype(key_dt))
    return (int)cudaErrorInvalidValue;
  if (R > 0) {
    const unsigned blocks = (unsigned)grid_for(R, max_blocks);
    cudaStream_t s = (cudaStream_t)stream;
    int* pd = static_cast<int*>(pids);
    unsigned long long* h = static_cast<unsigned long long*>(hist);
    switch (key_dt) {
      case DT_BOOL:
      case DT_U8:
        launch_hash<unsigned char>(keys, R, P, pd, h, blocks, s); break;
      case DT_I8:
        launch_hash<signed char>(keys, R, P, pd, h, blocks, s); break;
      case DT_I16: launch_hash<short>(keys, R, P, pd, h, blocks, s); break;
      case DT_U16:
        launch_hash<unsigned short>(keys, R, P, pd, h, blocks, s); break;
      case DT_I32:
      case DT_U32: launch_hash<unsigned>(keys, R, P, pd, h, blocks, s); break;
      default: launch_hash<unsigned long long>(keys, R, P, pd, h, blocks, s);
    }
  }
  return (int)cudaGetLastError();
}

// Host side: the pooled IN of a column that fits int32 (program.cuh's
// fits_i32) that compares in int64 compares in int32 over the part of its
// sorted list within int32's range (host_pool: the pool's host copy); no
// value outside it can equal a row.
static void narrow_pool_leaves(PredProgram* P, const long long* host_pool) {
  for (int i = 0; i < P->n_ops; ++i) {
    const int4 op = P->ops[i];
    if ((op.x & 15) != K_IN_POOL || ((op.x >> 8) & 7) != MODE_I64 ||
        !fits_i32(P->dtypes[op.y]))
      continue;
    const long long* a = host_pool + op.z;
    const int lo = (int)(std::lower_bound(a, a + op.w, -2147483648ll) - a);
    const int hi = (int)(std::upper_bound(a, a + op.w, 2147483647ll) - a);
    P->ops[i] = make_int4((op.x & ~(7 << 8)) | (MODE_I32 << 8), op.y,
                          op.z + lo, hi - lo);
  }
}

// Host side: the bytes of the shared pool (each list's tree 8-byte
// aligned); with `place`, each pooled op also records its tree's offset in
// op.x.
static long long place_pool(PredProgram* P, bool place) {
  long long at = 0;
  for (int i = 0; i < P->n_ops; ++i) {
    const int4 op = P->ops[i];
    if ((op.x & 15) != K_IN_POOL || op.w == 0) continue;
    if (place) P->ops[i].x |= (int)(at << POOL_OFF_SHIFT);
    at += (1ll << levels(op.w)) * pool_entry_bytes((op.x >> 8) & 7);
  }
  return at;
}

template <int W, bool REG, bool NARROW>
static int launch_shuffle(const StagedProgram& S, const StageLayout& L,
                          const ShuffleArgs& A, unsigned blocks, size_t smem,
                          cudaStream_t stream) {
  static const int opted = (int)cudaFuncSetAttribute(
      fused_scan_shuffle_kernel<W, REG, NARROW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_PER_SM - SMEM_RESERVED);  // above 48 KB only after opting in
  if (opted) return opted;
  fused_scan_shuffle_kernel<W, REG, NARROW>
      <<<blocks, THREADS, smem, stream>>>(S, L, A);
  return 0;
}

template <int W>
static int launch_w(bool reg, bool narrow, const StagedProgram& S,
                    const StageLayout& L, const ShuffleArgs& A,
                    unsigned blocks, size_t smem, cudaStream_t stream) {
  if (narrow)
    return reg ? launch_shuffle<W, true, true>(S, L, A, blocks, smem, stream)
               : launch_shuffle<W, false, true>(S, L, A, blocks, smem, stream);
  return reg ? launch_shuffle<W, true, false>(S, L, A, blocks, smem, stream)
             : launch_shuffle<W, false, false>(S, L, A, blocks, smem, stream);
}

// The program arguments as predicate_bitmap_launch takes them, then the
// pool's host copy; n_ops == 0 keeps every row. words (ceil(R/32),) u32.
// info, when not null, gets (blocks, blocks per SM, stages, tile rows,
// shared bytes a block, whether the pool was staged) of the launch.
extern "C" int fused_scan_shuffle_launch(
    const int* ops, int n_ops, const double* fconst, const long long* iconst,
    int n_consts, const long long* col_ptrs, const int* dtypes, int n_cols,
    const long long* pool, int n_pool, const long long* host_pool,
    const void* keys, int key_dt, long long R, int n_targets, void* words,
    void* pids, void* hist, int sms, void* stream, int* info) {
  if (n_targets < 1 || n_targets > MAX_TARGETS || !key_dtype(key_dt) ||
      sms < 1 ||
      (n_pool > 0 && host_pool == nullptr))
    return (int)cudaErrorInvalidValue;
  PredProgram P;
  int err = fill_program(&P, ops, n_ops, fconst, iconst, n_consts, col_ptrs,
                         dtypes, n_cols, pool, n_pool);
  if (err) return err;
  if (R <= 0) return (int)cudaGetLastError();
  // the keys take the stage slot after the program's columns
  long long ptrs[PP_MAX_COLS + 1];
  int dts[PP_MAX_COLS + 1];
  for (int c = 0; c < n_cols; ++c) {
    ptrs[c] = col_ptrs[c];
    dts[c] = dtypes[c];
  }
  ptrs[n_cols] = reinterpret_cast<long long>(keys);
  dts[n_cols] = key_dt;
  P.cols[n_cols] = keys;
  P.dtypes[n_cols] = key_dt;
  StagedProgram S = narrow_int_leaves(P);
  narrow_pool_leaves(&S.p, host_pool);
  const long long hist_bytes = ((long long)n_targets * 4 + 15) & ~15ll;
  const long long pool_bytes = place_pool(&S.p, false);
  StageLayout L;
  int bps = 1;
  const bool staged =
      pool_bytes > 0 && plan_stages(&L, dts, n_cols + 1, ptrs,
                                    hist_bytes + pool_bytes,
                                    SHUFFLE_BLOCKS_PER_SM, &bps);
  if (staged)
    place_pool(&S.p, true);
  else
    plan_stages(&L, dts, n_cols + 1, ptrs, hist_bytes, SHUFFLE_BLOCKS_PER_SM,
                &bps);
  // where the tiles outnumber the planned blocks but not the blocks that
  // fit at one stage each (one partition's rows), every block takes one
  // tile: a block's second tile would cost the launch a tile's latency
  const long long extra = hist_bytes + (staged ? pool_bytes : 0);
  const long long n_tiles = (R + L.tile_rows - 1) / L.tile_rows;
  if (n_tiles > (long long)sms * bps &&
      n_tiles <= (long long)sms * SHUFFLE_BLOCKS_PER_SM &&
      SMEM_PER_SM / SHUFFLE_BLOCKS_PER_SM - SMEM_RESERVED - HEADER - extra >=
          L.stage_bytes) {
    bps = SHUFFLE_BLOCKS_PER_SM;
    L.n_stages = 1;
  }
  ShuffleArgs A;
  A.R = R;
  A.n_targets = (unsigned)n_targets;
  A.key_shift = dtype_size(key_dt) == 8 ? 1 : 0;
  A.key_dt = key_dt;
  A.hist_off = HEADER + L.n_stages * L.stage_bytes;
  A.pool_off = staged ? A.hist_off + (int)hist_bytes : -1;
  A.words = static_cast<unsigned*>(words);
  A.pids = static_cast<int*>(pids);
  A.hist = static_cast<unsigned long long*>(hist);
  const size_t smem = A.hist_off + extra;
  const long long cap = (long long)sms * bps;
  const unsigned blocks = (unsigned)(n_tiles < cap ? n_tiles : cap);
  cudaStream_t s = (cudaStream_t)stream;
  const bool reg = n_targets <= REG_TARGETS;
  const bool narrow = dtype_size(key_dt) < 4;
  err = stack_depth(S.p) <= 8
            ? launch_w<1>(reg, narrow, S, L, A, blocks, smem, s)
            : launch_w<PP_MAX_DEPTH / 8>(reg, narrow, S, L, A, blocks, smem,
                                         s);
  if (err) return err;
  if (info) {
    const int plan[6] = {(int)blocks, bps, L.n_stages, L.tile_rows,
                         (int)smem, staged ? 1 : 0};
    memcpy(info, plan, sizeof(plan));
  }
  return (int)cudaGetLastError();
}
