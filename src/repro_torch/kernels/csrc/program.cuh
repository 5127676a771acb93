// Postfix predicate program, interpreted by every kernel that filters
// (predicate_bitmap, fused_scan_agg, fused_scan_shuffle). The encoding is
// written by repro_torch/kernels/program.py; see its docstring for the op
// layout.
//
// The whole program travels by value in the kernel's parameter block
// (__grid_constant__, about 2 KB): every lane of a warp reads the same op
// at the same time, so the reads are uniform constant-bank loads and the
// interpretation never diverges.
//
// An IN list longer than the inline constants take (K_IN_POOL) lives in a
// device array the program holds by pointer: every pooled list of the
// program, each sorted and deduplicated, one after the other, as int64
// values or as the bits of f64 values (f32 comparisons: values already
// rounded to f32). A leaf binary-searches its list with a fixed number of
// steps, so the lanes never diverge. predicate_bitmap and fused_scan_agg
// search it in device memory (GlobalPool); fused_scan_shuffle copies it
// into each block's shared memory when it fits (shuffle.cu).
//
// A column may hold any dtype of DT_* (bool, the integers of 1 to 8 bytes,
// f16, f32, f64); a leaf reads it at its stored width and converts it to
// its mode's type (MODE_*, chosen on the host by numpy's rules), one
// switch on the dtype for a lane's TILE_K rows (load_tile).
//
// eval_staged runs the program over a tile that a kernel has staged in
// shared memory (staging.cuh); the mbarrier and bulk-copy helpers at the
// end serve that staging.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <string.h>

#include <type_traits>

#define PP_MAX_OPS 64
#define PP_MAX_CONSTS 64
#define PP_MAX_COLS 8
#define PP_MAX_DEPTH 32  // the stack of a row is one 32-bit register
#define TILE_K 8

enum { K_CMP = 0, K_CMP_COL = 1, K_IN = 2, K_AND = 3, K_OR = 4,
       K_IN_POOL = 5 };
// Column dtypes (kernels/program.py::DTYPE_CODES); a bool is one byte,
// 0 or 1.
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3, DT_BOOL = 4,
       DT_U8 = 5, DT_I8 = 6, DT_I16 = 7, DT_U16 = 8, DT_U32 = 9,
       DT_U64 = 10, DT_F16 = 11 };
// Comparison modes, the 3-bit field (op.x >> 8) & 7 (program.py's
// MODE_CODES; MODE_I32 = 3 below): exact int64, float32, float64, exact
// unsigned 64-bit, and a uint64 column against a signed one (CMP_COL).
enum { MODE_I64 = 0, MODE_F32 = 1, MODE_F64 = 2, MODE_U64 = 4,
       MODE_MIX = 5 };

// The bytes of a value of a column dtype.
__host__ __device__ __forceinline__ int dtype_size(int dt) {
  switch (dt) {
    case DT_BOOL: case DT_U8: case DT_I8: return 1;
    case DT_I16: case DT_U16: case DT_F16: return 2;
    case DT_I64: case DT_U64: case DT_F64: return 8;
    default: return 4;
  }
}

// Whether every value of a column dtype fits int32.
__host__ __device__ __forceinline__ bool fits_i32(int dt) {
  return dt == DT_I32 || dt == DT_BOOL || dt == DT_U8 || dt == DT_I8 ||
         dt == DT_I16 || dt == DT_U16;
}

// A stored value as the type T: a float16 through float (exact), the rest
// by C conversion (exact wherever a mode puts them).
template <typename T, typename C>
__device__ __forceinline__ T to_num(C c) {
  if constexpr (std::is_same<C, __half>::value)
    return (T)__half2float(c);
  else
    return (T)c;
}

// Row r of a value column of dtype dt as f64, as numpy's astype(float64)
// gives it (the aggregating kernels sum in f64 whatever the stored width):
// one switch on the dtype, uniform across a warp.
__device__ __forceinline__ double load_f64(int dt, const void* p,
                                           long long r) {
  switch (dt) {
    case DT_F64: return static_cast<const double*>(p)[r];
    case DT_F32: return static_cast<const float*>(p)[r];
    case DT_BOOL:
    case DT_U8: return static_cast<const unsigned char*>(p)[r];
    case DT_I8: return static_cast<const signed char*>(p)[r];
    case DT_I16: return static_cast<const short*>(p)[r];
    case DT_U16: return static_cast<const unsigned short*>(p)[r];
    case DT_I32: return static_cast<const int*>(p)[r];
    case DT_U32: return static_cast<const unsigned*>(p)[r];
    case DT_I64: return (double)static_cast<const long long*>(p)[r];
    case DT_U64:
      return (double)static_cast<const unsigned long long*>(p)[r];
    default: return __half2float(static_cast<const __half*>(p)[r]);
  }
}

struct PredProgram {
  int4 ops[PP_MAX_OPS];          // (code, col, x, y)
  double fconst[PP_MAX_CONSTS];  // constants of f32/f64 comparisons
  long long iconst[PP_MAX_CONSTS];  // constants of int64 comparisons
  // cols[n_cols] may hold one more column that the kernel stages beside
  // the program's and no op reads (fused_scan_shuffle's keys)
  const void* cols[PP_MAX_COLS + 1];
  int dtypes[PP_MAX_COLS + 1];
  int n_ops;
  const long long* pool;  // the K_IN_POOL lists (device memory)
  int n_pool;
};

// Host side: copy the Python-encoded arrays into the by-value block.
static inline int fill_program(PredProgram* p, const int* ops, int n_ops,
                               const double* fconst, const long long* iconst,
                               int n_consts, const long long* col_ptrs,
                               const int* dtypes, int n_cols,
                               const long long* pool, int n_pool) {
  if (n_ops < 0 || n_ops > PP_MAX_OPS || n_consts < 0 ||
      n_consts > PP_MAX_CONSTS || n_cols < 0 || n_cols > PP_MAX_COLS ||
      n_pool < 0 || (n_pool > 0 && pool == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_ops; ++k) {  // a pooled list lies inside the pool
    const int kind = ops[4 * k] & 15, x = ops[4 * k + 2], y = ops[4 * k + 3];
    if (kind == K_IN_POOL && (x < 0 || y < 0 || x > n_pool - y))
      return (int)cudaErrorInvalidValue;
  }
  memset(p, 0, sizeof(*p));
  for (int k = 0; k < n_ops; ++k)
    p->ops[k] = make_int4(ops[4 * k], ops[4 * k + 1], ops[4 * k + 2],
                          ops[4 * k + 3]);
  for (int k = 0; k < n_consts; ++k) {
    p->fconst[k] = fconst[k];
    p->iconst[k] = iconst[k];
  }
  for (int k = 0; k < n_cols; ++k) {
    p->cols[k] = reinterpret_cast<const void*>(col_ptrs[k]);
    p->dtypes[k] = dtypes[k];
  }
  p->n_ops = n_ops;
  p->pool = pool;
  p->n_pool = n_pool;
  return 0;
}

template <typename T>
__device__ __forceinline__ T const_as(const PredProgram& P, int k);
template <>
__device__ __forceinline__ long long const_as<long long>(const PredProgram& P,
                                                         int k) {
  return P.iconst[k];
}
template <>
__device__ __forceinline__ float const_as<float>(const PredProgram& P, int k) {
  return (float)P.fconst[k];  // stored already rounded to f32
}
template <>
__device__ __forceinline__ double const_as<double>(const PredProgram& P,
                                                   int k) {
  return P.fconst[k];
}
template <>
__device__ __forceinline__ unsigned long long const_as<unsigned long long>(
    const PredProgram& P, int k) {
  return (unsigned long long)P.iconst[k];  // a uint64 constant's bits
}

// Entry i of the pool in the comparison type T.
template <typename T>
__device__ __forceinline__ T pool_at(const long long* pool, int i);
template <>
__device__ __forceinline__ long long pool_at<long long>(const long long* pool,
                                                        int i) {
  return __ldg(pool + i);
}
template <>
__device__ __forceinline__ unsigned long long pool_at<unsigned long long>(
    const long long* pool, int i) {
  return (unsigned long long)__ldg(pool + i);  // in unsigned order
}
template <>
__device__ __forceinline__ int pool_at<int>(const long long* pool, int i) {
  return (int)__ldg(pool + i);  // a list narrowed to int32 values
}
template <>
__device__ __forceinline__ double pool_at<double>(const long long* pool,
                                                  int i) {
  return __longlong_as_double(__ldg(pool + i));
}
template <>
__device__ __forceinline__ float pool_at<float>(const long long* pool, int i) {
  return (float)__longlong_as_double(__ldg(pool + i));  // exact: f32 values
}

// Bit k: does the sorted list pool[off, off + n) hold x[k]? pos[k] counts
// the list's values below x[k], found by halving steps from the largest
// power of two <= n: the same steps in every lane, and each step's TILE_K
// loads are independent. NaN is below nothing and equals nothing.
template <typename T>
__device__ __forceinline__ unsigned pool_in(const long long* pool, int off,
                                            int n, const T (&x)[TILE_K]) {
  int pos[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) pos[k] = 0;
  for (int step = n > 0 ? 1 << (31 - __clz(n)) : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k)
      if (pos[k] + step <= n &&
          pool_at<T>(pool, off + pos[k] + step - 1) < x[k])
        pos[k] += step;
  }
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < TILE_K; ++k)
    m |= pos[k] < n && pool_at<T>(pool, off + pos[k]) == x[k] ? 1u << k : 0u;
  return m;
}

// How eval_staged's pooled leaf searches its list (op.z, op.w): in the
// program's pool in device memory. fused_scan_shuffle has its own
// (shuffle.cu::ShufflePool).
struct GlobalPool {
  const long long* pool;
  template <typename T>
  __device__ __forceinline__ unsigned in(int4 op, const T (&x)[TILE_K]) const {
    return pool_in<T>(pool, op.z, op.w, x);
  }
};

template <typename T>
__device__ __forceinline__ bool cmp_op(int op, T a, T b) {
  switch (op) {
    case 0: return a <= b;
    case 1: return a < b;
    case 2: return a >= b;
    case 3: return a > b;
    default: return a == b;
  }
}

// ---- staged evaluation --------------------------------------------------
// The program over a tile staged in shared memory: column c's rows start at
// base + off[c], rows are 32-bit numbers from the tile's start, and lane l
// holds rows r0 + 32 * k for k < TILE_K (r0 = the sub-tile's base + l).
// Each op is decoded once per TILE_K rows of a lane, and each leaf has
// TILE_K independent loads in flight.
// - the stack is transposed: an entry is the TILE_K-bit mask of the lane's
//   rows, and W 64-bit words hold 8 * W entries (the top in the low byte),
//   so an AND or OR is a few instructions for all the lane's rows;
// - a full sub-tile (FULL) loads and compares with no row bound;
// - MODE_I32, which the launch sets on the leaf of a column whose values
//   all fit int32 (fits_i32) when its constants do too, compares in 32
//   bits (the int64 comparison of two int32 values gives the same answer).
#define MODE_I32 3  // a value of the mode field program.py never writes

// A program after narrow_int_leaves, the type eval_staged takes: a launch
// cannot hand it a program it has not narrowed.
struct StagedProgram {
  PredProgram p;
};

// Host side: the CMP or IN leaf of a column that fits int32 (int32 and
// every narrower integer and bool) that compares in int64 compares in
// int32 instead when every constant fits in int32: the same answer, fewer
// instructions.
static inline StagedProgram narrow_int_leaves(const PredProgram& P) {
  StagedProgram S;
  S.p = P;
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    const int kind = op.x & 15, mode = (op.x >> 8) & 7;
    if ((kind != K_CMP && kind != K_IN) || mode != MODE_I64 ||
        !fits_i32(P.dtypes[op.y]))
      continue;
    bool fits = true;
    for (int j = 0; j < (kind == K_IN ? op.w : 1); ++j) {
      const long long v = P.iconst[op.z + j];
      fits = fits && v >= -2147483648ll && v <= 2147483647ll;
    }
    if (fits) S.p.ops[i].x = (op.x & ~(7 << 8)) | (MODE_I32 << 8);
  }
  return S;
}

template <>
__device__ __forceinline__ int const_as<int>(const PredProgram& P, int k) {
  return (int)P.iconst[k];
}

template <int W>
struct MaskStack {
  unsigned long long w[W];
  __device__ __forceinline__ void push(unsigned m) {
#pragma unroll
    for (int j = W - 1; j > 0; --j) w[j] = (w[j] << 8) | (w[j - 1] >> 56);
    w[0] = (w[0] << 8) | m;
  }
  __device__ __forceinline__ unsigned pop() {
    const unsigned top = (unsigned)(w[0] & 0xFFull);
#pragma unroll
    for (int j = 0; j < W - 1; ++j) w[j] = (w[j] >> 8) | (w[j + 1] << 56);
    w[W - 1] >>= 8;
    return top;
  }
};

// The lane's rows r0 + 32 * k of a staged column of stored type C, as T.
template <typename C, typename T, bool FULL>
__device__ __forceinline__ void load_rows(const void* col_ptr, int r0, int n,
                                          T (&x)[TILE_K]) {
  const C* col = static_cast<const C*>(col_ptr);
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const int r = r0 + 32 * k;
    x[k] = (FULL || r < n) ? to_num<T>(col[r]) : (T)0;
  }
}

// The lane's rows of a staged column of dtype dt as the mode's type T: one
// switch on the dtype (uniform across the warp) outside the row loop, over
// the dtypes the mode can meet (compare_dtype): MODE_I32 those that fit
// int32, MODE_I64 every integer (uint64 as its bits, for MODE_MIX),
// MODE_U64 the unsigned ones, MODE_F32 those float32 orders exactly,
// MODE_F64 all.
template <typename T, bool FULL>
__device__ __forceinline__ void load_tile(int dt, const void* c, int r0,
                                          int n, T (&x)[TILE_K]) {
  constexpr bool I32 = std::is_same<T, int>::value;
  constexpr bool I64 = std::is_same<T, long long>::value;
  constexpr bool U64 = std::is_same<T, unsigned long long>::value;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr bool INT = I32 || I64 || U64;
  constexpr int NATIVE = I32 ? DT_I32 : I64 ? DT_I64 : U64 ? DT_U64
                         : F32 ? DT_F32 : DT_F64;
  if (dt == NATIVE) {  // a column of the mode's own type: no conversion
    load_rows<T, T, FULL>(c, r0, n, x);
    return;
  }
  switch (dt) {
    case DT_BOOL:
    case DT_U8: load_rows<unsigned char, T, FULL>(c, r0, n, x); return;
    case DT_U16: load_rows<unsigned short, T, FULL>(c, r0, n, x); return;
    case DT_I8:
      if constexpr (!U64) load_rows<signed char, T, FULL>(c, r0, n, x);
      return;
    case DT_I16:
      if constexpr (!U64) load_rows<short, T, FULL>(c, r0, n, x);
      return;
    case DT_I32:
      if constexpr (!U64 && !F32) load_rows<int, T, FULL>(c, r0, n, x);
      return;
    case DT_U32:
      if constexpr (!I32 && !F32) load_rows<unsigned, T, FULL>(c, r0, n, x);
      return;
    case DT_I64:
      if constexpr (I64 || !(INT || F32))
        load_rows<long long, T, FULL>(c, r0, n, x);
      return;
    case DT_U64:  // as int64 bits in MODE_MIX
      if constexpr (!(I32 || F32))
        load_rows<unsigned long long, T, FULL>(c, r0, n, x);
      return;
    case DT_F16:
      if constexpr (!INT) load_rows<__half, T, FULL>(c, r0, n, x);
      return;
    case DT_F32:
      if constexpr (!INT) load_rows<float, T, FULL>(c, r0, n, x);
      return;
    default:
      if constexpr (!INT && !F32) load_rows<double, T, FULL>(c, r0, n, x);
      return;
  }
}

// The mask of the lane's rows against a constant or a constant list (IN,
// inline or pooled, the pooled one searched through `pool`);
// bits of rows past n are undefined (eval_staged clears them).
template <typename T, bool FULL, typename Pool>
__device__ __forceinline__ unsigned staged_leaf(const PredProgram& P,
                                                const Pool& pool, int dt,
                                                const void* col_ptr, int4 op,
                                                int kind, int cmp, int r0,
                                                int n) {
  static_assert(TILE_K == 8, "a stack entry is one byte");
  T x[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) x[k] = (T)0;
  load_tile<T, FULL>(dt, col_ptr, r0, n, x);
  if (kind == K_IN_POOL) return pool.template in<T>(op, x);
  unsigned m = 0u;
  if (kind == K_IN) {
    for (int j = 0; j < op.w; ++j) {
      const T c = const_as<T>(P, op.z + j);
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) m |= x[k] == c ? 1u << k : 0u;
    }
    return m;
  }
  const T c = const_as<T>(P, op.z);
  if (cmp == 0) {  // expressions.CMP_OPS order
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] <= c ? 1u << k : 0u;
  } else if (cmp == 1) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] < c ? 1u << k : 0u;
  } else if (cmp == 2) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] >= c ? 1u << k : 0u;
  } else if (cmp == 3) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] > c ? 1u << k : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] == c ? 1u << k : 0u;
  }
  return m;
}

// Bit k: row k's compare of x[k] with y[k], the compare decoded once.
template <typename T>
__device__ __forceinline__ unsigned cmp_rows(int cmp, const T (&x)[TILE_K],
                                             const T (&y)[TILE_K]) {
  unsigned m = 0u;
  if (cmp == 0) {  // expressions.CMP_OPS order
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] <= y[k] ? 1u << k : 0u;
  } else if (cmp == 1) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] < y[k] ? 1u << k : 0u;
  } else if (cmp == 2) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] >= y[k] ? 1u << k : 0u;
  } else if (cmp == 3) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] > y[k] ? 1u << k : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) m |= x[k] == y[k] ? 1u << k : 0u;
  }
  return m;
}

// A column-column leaf in the mode's type T, each column's tile loaded
// by one switch on its dtype (bits of rows past n are undefined).
template <typename T, bool FULL>
__device__ __forceinline__ unsigned staged_leaf_cols(
    const PredProgram& P, const unsigned char* base, const int* off, int4 op,
    int cmp, int r0, int n) {
  T x[TILE_K], y[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) x[k] = y[k] = (T)0;
  load_tile<T, FULL>(P.dtypes[op.y], base + off[op.y], r0, n, x);
  load_tile<T, FULL>(P.dtypes[op.z], base + off[op.z], r0, n, y);
  return cmp_rows<T>(cmp, x, y);
}

// A uint64 column against a signed one (MODE_MIX), exactly: a uint64 value
// at or past 2^63 (negative as int64 bits) exceeds every signed value; the
// others compare as int64.
template <bool FULL>
__device__ __forceinline__ unsigned staged_leaf_mixed(
    const PredProgram& P, const unsigned char* base, const int* off, int4 op,
    int cmp, int r0, int n) {
  const int da = P.dtypes[op.y], db = P.dtypes[op.z];
  long long x[TILE_K], y[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) x[k] = y[k] = 0;
  load_tile<long long, FULL>(da, base + off[op.y], r0, n, x);
  load_tile<long long, FULL>(db, base + off[op.z], r0, n, y);
  const unsigned above = cmp_op<int>(cmp, 1, 0) ? ~0u : 0u;
  const unsigned below = cmp_op<int>(cmp, 0, 1) ? ~0u : 0u;
  unsigned hx = 0u, hy = 0u;
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    hx |= da == DT_U64 && x[k] < 0 ? 1u << k : 0u;
    hy |= db == DT_U64 && y[k] < 0 ? 1u << k : 0u;
  }
  return (cmp_rows<long long>(cmp, x, y) & ~(hx | hy)) | (above & hx) |
         (below & hy & ~hx);
}

// Bit k of the result is the predicate of row r0 + 32 * k; rows at or past
// n give 0. W 64-bit stack words hold a program of depth up to 8 * W.
// Pooled leaves search their lists through `pool`. Every instantiation
// keeps the pooled leaf: the branch moved the staged kernels by under 2% on
// programs without one (Q1's four sums 1.0686 -> 1.0862 ms, Q19's words
// 0.3511 -> 0.3478 ms; NVIDIA H100 80GB HBM3, 700.00 W), and a POOL
// parameter would double fused_scan_agg.cu's kernels, the longest build of
// chip_smoke.py.
template <int W, bool FULL, typename Pool>
__device__ __forceinline__ unsigned eval_staged(const StagedProgram& S,
                                                const unsigned char* base,
                                                const int* off, int r0,
                                                int n, const Pool& pool) {
  const PredProgram& P = S.p;
  MaskStack<W> st;
#pragma unroll
  for (int j = 0; j < W; ++j) st.w[j] = 0ull;
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    const int kind = op.x & 15, cmp = (op.x >> 4) & 7, mode = (op.x >> 8) & 7;
    if (kind == K_AND) {
      const unsigned top = st.pop();
      st.w[0] &= (unsigned long long)top | ~0xFFull;
    } else if (kind == K_OR) {
      st.w[0] |= st.pop();
    } else if (kind == K_CMP_COL) {
      st.push(mode == MODE_I64 ? staged_leaf_cols<long long, FULL>(P, base, off, op, cmp, r0, n)
              : mode == MODE_U64 ? staged_leaf_cols<unsigned long long, FULL>(P, base, off, op, cmp, r0, n)
              : mode == MODE_MIX ? staged_leaf_mixed<FULL>(P, base, off, op, cmp, r0, n)
              : mode == MODE_F32 ? staged_leaf_cols<float, FULL>(P, base, off, op, cmp, r0, n)
              : staged_leaf_cols<double, FULL>(P, base, off, op, cmp, r0, n));
    } else {
      const void* c = base + off[op.y];
      const int dt = P.dtypes[op.y];
      unsigned m = 0u;  // a mode compare_dtype never makes selects no row
      switch (mode) {
        case MODE_I32:
          m = staged_leaf<int, FULL>(P, pool, dt, c, op, kind, cmp, r0, n); break;
        case MODE_I64:
          m = staged_leaf<long long, FULL>(P, pool, dt, c, op, kind, cmp, r0, n); break;
        case MODE_U64:
          m = staged_leaf<unsigned long long, FULL>(P, pool, dt, c, op, kind, cmp, r0, n); break;
        case MODE_F32:
          m = staged_leaf<float, FULL>(P, pool, dt, c, op, kind, cmp, r0, n); break;
        case MODE_F64:
          m = staged_leaf<double, FULL>(P, pool, dt, c, op, kind, cmp, r0, n); break;
      }
      st.push(m);
    }
  }
  unsigned keep = (unsigned)(st.w[0] & 0xFFull);
  if (!FULL) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k)
      keep &= r0 + 32 * k < n ? ~0u : ~(1u << k);
  }
  return keep;
}

// eval_staged with the pooled lists searched in device memory
// (predicate_bitmap.cu, fused_scan_agg.cu).
template <int W, bool FULL>
__device__ __forceinline__ unsigned eval_staged(const StagedProgram& S,
                                                const unsigned char* base,
                                                const int* off, int r0,
                                                int n) {
  return eval_staged<W, FULL>(S, base, off, r0, n, GlobalPool{S.p.pool});
}

// ---- staging helpers (sm_90): mbarriers and 1-D bulk copies (TMA) --------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of bulk copies to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completion counts against `bar`'s transactions.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
