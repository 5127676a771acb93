// Postfix predicate program, interpreted by every kernel that filters
// (predicate_bitmap, fused_scan_agg). The encoding is written by
// repro_torch/kernels/program.py; see its docstring for the op layout.
//
// The whole program travels by value in the kernel's parameter block
// (__grid_constant__, about 2 KB): every lane of a warp reads the same op
// at the same time, so the reads are uniform constant-bank loads and the
// interpretation never diverges.
//
// A warp evaluates a tile of 32 * TILE_K consecutive rows: lane l holds
// rows base + 32 * k + l for k < TILE_K. Each op is decoded once per tile
// and applied to the lane's TILE_K rows, so the decode is paid once per
// TILE_K rows and each leaf has TILE_K independent loads in flight. Each
// row's boolean stack is one 32-bit register.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#define PP_MAX_OPS 64
#define PP_MAX_CONSTS 64
#define PP_MAX_COLS 8
#define TILE_K 8

enum { K_CMP = 0, K_CMP_COL = 1, K_IN = 2, K_AND = 3, K_OR = 4 };
enum { DT_I32 = 0, DT_I64 = 1, DT_F32 = 2, DT_F64 = 3 };
enum { MODE_I64 = 0, MODE_F32 = 1, MODE_F64 = 2 };

struct PredProgram {
  int4 ops[PP_MAX_OPS];          // (code, col, x, y)
  double fconst[PP_MAX_CONSTS];  // constants of f32/f64 comparisons
  long long iconst[PP_MAX_CONSTS];  // constants of int64 comparisons
  const void* cols[PP_MAX_COLS];
  int dtypes[PP_MAX_COLS];
  int n_ops;
};

// Host side: copy the Python-encoded arrays into the by-value block.
static inline int fill_program(PredProgram* p, const int* ops, int n_ops,
                               const double* fconst, const long long* iconst,
                               int n_consts, const long long* col_ptrs,
                               const int* dtypes, int n_cols) {
  if (n_ops < 0 || n_ops > PP_MAX_OPS || n_consts < 0 ||
      n_consts > PP_MAX_CONSTS || n_cols < 0 || n_cols > PP_MAX_COLS)
    return (int)cudaErrorInvalidValue;
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

// Column c's value at row r, converted to the comparison type T.
template <typename T>
__device__ __forceinline__ T load_as(const PredProgram& P, int c, long long r) {
  const void* p = P.cols[c];
  switch (P.dtypes[c]) {
    case DT_I32: return (T) static_cast<const int*>(p)[r];
    case DT_I64: return (T) static_cast<const long long*>(p)[r];
    case DT_F32: return (T) static_cast<const float*>(p)[r];
    default: return (T) static_cast<const double*>(p)[r];
  }
}

// Push the comparison of the tile's rows against a constant or a constant
// list (IN). C is the column's storage type, T the comparison type. Rows
// past R read nothing; the caller masks them.
template <typename C, typename T>
__device__ __forceinline__ void leaf_const(const PredProgram& P, int4 op,
                                           int kind, int cmp, long long r0,
                                           long long R,
                                           unsigned (&st)[TILE_K]) {
  const C* col = static_cast<const C*>(P.cols[op.y]);
  T x[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const long long r = r0 + 32 * k;
    x[k] = r < R ? (T)col[r] : (T)0;
  }
  bool b[TILE_K];
  if (kind == K_IN) {
#pragma unroll
    for (int k = 0; k < TILE_K; ++k) b[k] = false;
    for (int j = 0; j < op.w; ++j) {
      const T c = const_as<T>(P, op.z + j);
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] |= x[k] == c;
    }
  } else {
    // one uniform branch per op, then a straight loop over the rows
    const T c = const_as<T>(P, op.z);
    if (cmp == 0) {  // expressions.CMP_OPS order
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] = x[k] <= c;
    } else if (cmp == 1) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] = x[k] < c;
    } else if (cmp == 2) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] = x[k] >= c;
    } else if (cmp == 3) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] = x[k] > c;
    } else {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) b[k] = x[k] == c;
    }
  }
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) st[k] = (st[k] << 1) | (b[k] ? 1u : 0u);
}

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

// Column-column comparison in type T (rare: no typed fast path).
template <typename T>
__device__ __forceinline__ void leaf_cols(const PredProgram& P, int4 op,
                                          int cmp, long long r0, long long R,
                                          unsigned (&st)[TILE_K]) {
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const long long r = r0 + 32 * k;
    const bool b = r < R && cmp_op<T>(cmp, load_as<T>(P, op.y, r),
                                      load_as<T>(P, op.z, r));
    st[k] = (st[k] << 1) | (b ? 1u : 0u);
  }
}

// Bit k of the result is the predicate of row r0 + 32 * k (r0 = the tile's
// base + lane); rows at or past R give 0. The types a leaf may pair are
// the ones expressions.compare_dtype produces.
__device__ __forceinline__ unsigned eval_tile(const PredProgram& P,
                                              long long r0, long long R) {
  unsigned st[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) st[k] = 0u;
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    const int kind = op.x & 15, cmp = (op.x >> 4) & 7, mode = (op.x >> 8) & 3;
    if (kind == K_AND || kind == K_OR) {
#pragma unroll
      for (int k = 0; k < TILE_K; ++k) {
        const unsigned top = st[k] & 1u;
        st[k] >>= 1;
        st[k] = kind == K_AND ? (st[k] & (~1u | top)) : (st[k] | top);
      }
    } else if (kind == K_CMP_COL) {
      if (mode == MODE_I64) leaf_cols<long long>(P, op, cmp, r0, R, st);
      else if (mode == MODE_F32) leaf_cols<float>(P, op, cmp, r0, R, st);
      else leaf_cols<double>(P, op, cmp, r0, R, st);
    } else {
      switch (P.dtypes[op.y] * 3 + mode) {
        case DT_I32 * 3 + MODE_I64:
          leaf_const<int, long long>(P, op, kind, cmp, r0, R, st); break;
        case DT_I32 * 3 + MODE_F64:
          leaf_const<int, double>(P, op, kind, cmp, r0, R, st); break;
        case DT_I64 * 3 + MODE_I64:
          leaf_const<long long, long long>(P, op, kind, cmp, r0, R, st); break;
        case DT_I64 * 3 + MODE_F64:
          leaf_const<long long, double>(P, op, kind, cmp, r0, R, st); break;
        case DT_F32 * 3 + MODE_F32:
          leaf_const<float, float>(P, op, kind, cmp, r0, R, st); break;
        case DT_F32 * 3 + MODE_F64:
          leaf_const<float, double>(P, op, kind, cmp, r0, R, st); break;
        case DT_F64 * 3 + MODE_F64:
          leaf_const<double, double>(P, op, kind, cmp, r0, R, st); break;
        default:  // a pairing compare_dtype never makes: select no row
#pragma unroll
          for (int k = 0; k < TILE_K; ++k) st[k] <<= 1;
      }
    }
  }
  unsigned keep = 0u;
#pragma unroll
  for (int k = 0; k < TILE_K; ++k)
    keep |= ((st[k] & 1u) && r0 + 32 * k < R) ? (1u << k) : 0u;
  return keep;
}
