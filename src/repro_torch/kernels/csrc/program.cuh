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
// A warp evaluates a tile of 32 * TILE_K consecutive rows: lane l holds
// rows base + 32 * k + l for k < TILE_K. Each op is decoded once per tile
// and applied to the lane's TILE_K rows, so the decode is paid once per
// TILE_K rows and each leaf has TILE_K independent loads in flight. Each
// row's boolean stack is one 32-bit register.
//
// eval_staged (after eval_tile) runs the same program over a tile that
// predicate_bitmap.cu or fused_scan_agg.cu has staged in shared memory
// (staging.cuh), with a cheaper stack; the mbarrier and bulk-copy helpers
// at the end serve that staging. eval_tile now serves fused_scan_shuffle
// alone.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#define PP_MAX_OPS 64
#define PP_MAX_CONSTS 64
#define PP_MAX_COLS 8
#define PP_MAX_DEPTH 32  // the stack of a row is one 32-bit register
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
// the ones expressions.compare_dtype produces. P holds no MODE_I32 leaf
// (that would decode here as DT_I64 * 3 + MODE_I64): narrowed programs are
// StagedPrograms, which only eval_staged takes.
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

// ---- staged evaluation (predicate_bitmap.cu, fused_scan_agg.cu) -----------
// The program over a tile staged in shared memory: column c's rows start at
// base + off[c], rows are 32-bit numbers from the tile's start, and lane l
// holds rows r0 + 32 * k (r0 = the sub-tile's base + l). It costs fewer
// instructions per row than eval_tile:
// - the stack is transposed: an entry is the TILE_K-bit mask of the lane's
//   rows, and W 64-bit words hold 8 * W entries (the top in the low byte),
//   so an AND or OR is a few instructions for all the lane's rows;
// - a full sub-tile (FULL) loads and compares with no row bound;
// - MODE_I32, which the launch sets on an int32 column's leaf whose
//   constants all fit in int32, compares in 32 bits (the int64 comparison
//   of two int32 values gives the same answer).
// It is kept apart from eval_tile: routing eval_tile's callers through a
// template shared with it cost fused_scan_shuffle 26% (0.7228 -> 0.9123 ms
// on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md).
#define MODE_I32 3  // the free value of the 2-bit mode field

// A program after narrow_int_leaves. It is a type of its own so that it
// cannot reach eval_tile, whose dtype * 3 + mode decode would read a
// MODE_I32 leaf of an int32 column as an int64 one.
struct StagedProgram {
  PredProgram p;
};

// Host side: an int32 column's CMP or IN leaf that compares in int64
// compares in int32 instead when every constant fits in int32: the same
// answer, fewer instructions.
static inline StagedProgram narrow_int_leaves(const PredProgram& P) {
  StagedProgram S;
  S.p = P;
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    const int kind = op.x & 15, mode = (op.x >> 8) & 3;
    if ((kind != K_CMP && kind != K_IN) || mode != MODE_I64 ||
        P.dtypes[op.y] != DT_I32)
      continue;
    bool fits = true;
    for (int j = 0; j < (kind == K_IN ? op.w : 1); ++j) {
      const long long v = P.iconst[op.z + j];
      fits = fits && v >= -2147483648ll && v <= 2147483647ll;
    }
    if (fits) S.p.ops[i].x = (op.x & ~(3 << 8)) | (MODE_I32 << 8);
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

template <typename T>
__device__ __forceinline__ T staged_as(int dtype, const void* p, int r) {
  switch (dtype) {
    case DT_I32: return (T) static_cast<const int*>(p)[r];
    case DT_I64: return (T) static_cast<const long long*>(p)[r];
    case DT_F32: return (T) static_cast<const float*>(p)[r];
    default: return (T) static_cast<const double*>(p)[r];
  }
}

// The mask of the lane's rows against a constant or a constant list (IN);
// bits of rows past n are undefined (eval_staged clears them).
template <typename C, typename T, bool FULL>
__device__ __forceinline__ unsigned staged_leaf(const PredProgram& P,
                                                const void* col_ptr, int4 op,
                                                int kind, int cmp, int r0,
                                                int n) {
  static_assert(TILE_K == 8, "a stack entry is one byte");
  const C* col = static_cast<const C*>(col_ptr);
  T x[TILE_K];
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const int r = r0 + 32 * k;
    x[k] = (FULL || r < n) ? (T)col[r] : (T)0;
  }
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

template <typename T, bool FULL>
__device__ __forceinline__ unsigned staged_leaf_cols(
    const PredProgram& P, const unsigned char* base, const int* off, int4 op,
    int cmp, int r0, int n) {
  const void* a = base + off[op.y];
  const void* b = base + off[op.z];
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < TILE_K; ++k) {
    const int r = r0 + 32 * k;
    if (FULL || r < n)
      m |= cmp_op<T>(cmp, staged_as<T>(P.dtypes[op.y], a, r),
                     staged_as<T>(P.dtypes[op.z], b, r)) ? 1u << k : 0u;
  }
  return m;
}

// Bit k of the result is the predicate of row r0 + 32 * k; rows at or past
// n give 0. W 64-bit stack words hold a program of depth up to 8 * W.
template <int W, bool FULL>
__device__ __forceinline__ unsigned eval_staged(const StagedProgram& S,
                                                const unsigned char* base,
                                                const int* off, int r0,
                                                int n) {
  const PredProgram& P = S.p;
  MaskStack<W> st;
#pragma unroll
  for (int j = 0; j < W; ++j) st.w[j] = 0ull;
  for (int i = 0; i < P.n_ops; ++i) {
    const int4 op = P.ops[i];
    const int kind = op.x & 15, cmp = (op.x >> 4) & 7, mode = (op.x >> 8) & 3;
    if (kind == K_AND) {
      const unsigned top = st.pop();
      st.w[0] &= (unsigned long long)top | ~0xFFull;
    } else if (kind == K_OR) {
      st.w[0] |= st.pop();
    } else if (kind == K_CMP_COL) {
      st.push(mode == MODE_I64 ? staged_leaf_cols<long long, FULL>(P, base, off, op, cmp, r0, n)
              : mode == MODE_F32 ? staged_leaf_cols<float, FULL>(P, base, off, op, cmp, r0, n)
              : staged_leaf_cols<double, FULL>(P, base, off, op, cmp, r0, n));
    } else {
      const void* c = base + off[op.y];
      unsigned m = 0u;  // a pairing compare_dtype never makes selects no row
      switch (P.dtypes[op.y] * 4 + mode) {
        case DT_I32 * 4 + MODE_I32:
          m = staged_leaf<int, int, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_I32 * 4 + MODE_I64:
          m = staged_leaf<int, long long, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_I32 * 4 + MODE_F64:
          m = staged_leaf<int, double, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_I64 * 4 + MODE_I64:
          m = staged_leaf<long long, long long, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_I64 * 4 + MODE_F64:
          m = staged_leaf<long long, double, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_F32 * 4 + MODE_F32:
          m = staged_leaf<float, float, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_F32 * 4 + MODE_F64:
          m = staged_leaf<float, double, FULL>(P, c, op, kind, cmp, r0, n); break;
        case DT_F64 * 4 + MODE_F64:
          m = staged_leaf<double, double, FULL>(P, c, op, kind, cmp, r0, n); break;
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
