// The per-atom product of K3 (dbdd.cu) and K14 (ace_b_dbdd.cu) on the FP64
// tensor cores, and the two PTX helpers it shares with K7
// (normal_contrib.cu):
//   out[r, k, c] = sum_i L[r, i] * R[c, k, i]
// for one atom.  L (rows x inner) is in shared memory; R is the atom's
// slice of J or Jp in its (3, N, K, inner) layout, so that column (c, k)
// of the product is one contiguous row of R: the column-major B operand of
// mma.sync ...row.col.f64.
//
// Design: each element of R meets one warp only, so R goes from global
// memory straight into the warps' B fragments, with no shared staging and
// no barrier in the loop.  The columns are swept in groups of AG_NCOLS
// (192: 64 neighbors x 3 directions); warp w owns n-tiles w, w + 8 and
// w + 16 of the sweep over all 16 IW rows.  Each lane streams its columns'
// rows of R by k-steps of 8 (a warp's load reads 8 rows x 32 contiguous
// bytes, whole sectors), AG_DEPTH k-steps ahead in registers, so that the
// loads of the next k-steps are in flight while the current one is
// multiplied; its B fragments are reused over the IW row tiles, each A
// fragment (from shared memory) over its three n-tiles, and the
// accumulators stay in registers.  A row tile whose L rows are zero over a
// k-step (the caller's flags) skips it.  Every output is one fixed chain
// of mma k-steps in inner order: no atomics, the result repeats bit for
// bit.  The epilogue passes each warp's 16 x 8 accumulator tiles through
// the warp's own stage in shared memory (AG_STAGE doubles a block), so that
// a warp store writes 4 rows x 8 consecutive columns, whole 32-byte sectors
// where those columns are consecutive in `out`, in place of 8 rows x 4
// columns at a stride of 2; rows past `rows` and columns past `ncols` are
// masked.  L's row stride of 4 mod 16 doubles (ag_ldl) puts the A
// fragment loads of a half-warp on 16 different double-wide bank groups.
// The callers keep IW <= 2 (128 registers a thread) and their shared
// memory small, so that two blocks share an SM and one block's L build
// overlaps the other's stream.
//
// At float32 (K3's float32 instantiation) the product runs on the CUDA
// cores instead, in plain float32 FMAs: no tensor-core type keeps
// float32's 24-bit mantissa (TF32 keeps 11), and the port keeps TF32 off.
// The operands, the zero flags and the outputs are the same; the layout of
// the work is not (`ag_run` of `AtomGemmT<float>` below).
#pragma once

#include "common.cuh"

constexpr int AG_THREADS = 256;                  // 8 warps
constexpr int AG_JW = 3;                         // n-tiles of a warp
constexpr int AG_NCOLS = 8 * AG_JW * 8;          // columns of a sweep
constexpr int AG_DEPTH = 3;                      // k-steps loaded ahead
constexpr int AG_STAGE = AG_THREADS / 32 * 128;  // epilogue stage, doubles

// Row stride (doubles) of an L operand with `inner` columns: whole k-steps
// of 16, plus 4.
__host__ __device__ inline int ag_ldl(int inner) {
  return (inner + 15) / 16 * 16 + 4;
}

// D += A B on the FP64 tensor cores, A 16 x 8 (row), B 8 x 8 (col).  With
// g = lane / 4 and t = lane % 4: a[2h + s] = A[g + 8 s][t + 4 h], b[h] =
// B[t + 4 h][g], c[2 s + i] = D[g + 8 s][2 t + i].
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <typename T>
struct AtomGemmT {
  const T* L;          // shared (16 IW rows, ldl), zero past inner and rows
  int ldl, rows;
  const unsigned char* nz;  // shared (IW, ldl / 8) or null: 0 where the 16
                            // rows of a row tile are zero over a k-step
  const T* R;          // global: column (c, k) at R + c cstride + k inner
  long long cstride;
  int inner;
  const int* slot;     // shared: neighbor of column n is slot[n / 3]; null:
                       // n / 3
  int ncols;           // columns: 3 x neighbors
  T* out;              // global: out[r ldo + 3 k + c]
  long long ldo;
  T* stage;            // shared (AG_STAGE), 16-byte aligned (float64 only)
};
using AtomGemm = AtomGemmT<double>;

template <typename T>
__device__ __forceinline__ int ag_neighbor(const AtomGemmT<T>& g, int n) {
  return g.slot ? g.slot[n / 3] : n / 3;
}

// The B fragments of k-step ks of the lane's n-tiles (zeros past inner and
// for columns that are not there).
__device__ __forceinline__ void ag_fetch(const double* const (&src)[AG_JW],
                                         int inner, int t4, int ks,
                                         double (&b)[AG_JW][2]) {
#pragma unroll
  for (int j = 0; j < AG_JW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ks * 8 + t4 + 4 * h;
      b[j][h] = src[j] && i < inner ? __ldg(src[j] + i) : 0.0;
    }
}

// Ask L2 for the whole 16-byte units of [src, src + bytes) in bulk
// requests, so that a block's later reads of them wait on L2, not HBM.
__device__ __forceinline__ void ag_prefetch(const void* src, long long bytes) {
  const unsigned long long b = reinterpret_cast<unsigned long long>(src);
  const unsigned long long lo = (b + 15) & ~15ull;
  const unsigned long long hi = (b + bytes) & ~15ull;
  for (unsigned long long p = lo; p < hi; p += 1 << 20) {
    const unsigned n = static_cast<unsigned>(min(hi - p, 1ull << 20));
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
                 "r"(n)
                 : "memory");
  }
}

// The product; L must be complete in shared memory (the first
// __syncthreads here orders the caller's writes).  Ends with a
// __syncthreads: L and slot are free again.
template <int IW>
__device__ void ag_run(const AtomGemm& g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int nks = (g.inner + 7) / 8;
  __syncthreads();
  for (int n0 = 0; n0 < g.ncols; n0 += AG_NCOLS) {
    const int ntl = (min(AG_NCOLS, g.ncols - n0) + 7) / 8;
    if (warp >= ntl) continue;
    const double* src[AG_JW];
#pragma unroll
    for (int j = 0; j < AG_JW; ++j) {
      const int n = n0 + (warp + 8 * j) * 8 + g8;
      src[j] = nullptr;
      if (warp + 8 * j < ntl && n < g.ncols)
        src[j] = g.R + (n % 3) * g.cstride +
                 static_cast<long long>(ag_neighbor(g, n)) * g.inner;
    }
    double acc[IW][AG_JW][4];
#pragma unroll
    for (int i = 0; i < IW; ++i)
#pragma unroll
      for (int j = 0; j < AG_JW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    double buf[AG_DEPTH][AG_JW][2];
#pragma unroll
    for (int d = 0; d < AG_DEPTH; ++d) ag_fetch(src, g.inner, t4, d, buf[d]);

    for (int ks0 = 0; ks0 < nks; ks0 += AG_DEPTH) {
#pragma unroll
      for (int d = 0; d < AG_DEPTH; ++d) {
        const int ks = ks0 + d;
        if (ks >= nks) break;
        const double* ls = g.L + ks * 8;
#pragma unroll
        for (int i = 0; i < IW; ++i) {
          if (g.nz && !g.nz[i * (g.ldl / 8) + ks]) continue;
          const double* ap = ls + (16 * i + g8) * g.ldl + t4;
          const double a[4] = {ap[0], ap[8 * g.ldl], ap[4],
                               ap[8 * g.ldl + 4]};
#pragma unroll
          for (int j = 0; j < AG_JW; ++j)
            if (warp + 8 * j < ntl) mma_f64(acc[i][j], a, buf[d][j]);
        }
        ag_fetch(src, g.inner, t4, ks + AG_DEPTH, buf[d]);
      }
    }

    double* st = g.stage + warp * 128;
#pragma unroll
    for (int j = 0; j < AG_JW; ++j) {
      const int tile = warp + 8 * j;
      if (tile >= ntl) continue;
      const int n = n0 + tile * 8 + (lane & 7);
      const int o = n < g.ncols ? 3 * ag_neighbor(g, n) + n % 3 : -1;
#pragma unroll
      for (int i = 0; i < IW; ++i) {
        __syncwarp();
        reinterpret_cast<double2*>(st)[g8 * 4 + t4] =
            make_double2(acc[i][j][0], acc[i][j][1]);
        reinterpret_cast<double2*>(st)[(g8 + 8) * 4 + t4] =
            make_double2(acc[i][j][2], acc[i][j][3]);
        __syncwarp();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = 16 * i + 4 * m + (lane >> 3);
          if (o >= 0 && r < g.rows) g.out[r * g.ldo + o] = st[32 * m + lane];
        }
      }
    }
  }
  __syncthreads();
}

// The float32 product: one thread a column n (neighbor, direction), its
// 16 IW outputs in registers, the column's row of R read by k-steps of 8
// (one 32-byte sector a thread, through L1) and each L row's 8 values of
// the k-step a shared-memory broadcast (every thread reads the same
// address); a row tile whose rows are zero over a k-step skips it.  Each
// output is one fixed chain of FMAs in inner order: the result repeats
// bit for bit.  Bound on the H100 by the FP32 FMA rate over y's nonzero
// blocks.  L must be complete (the first __syncthreads orders it); ends
// with a __syncthreads.
template <int IW>
__device__ void ag_run(const AtomGemmT<float>& g) {
  constexpr int MR = 16 * IW;
  const int nks = (g.inner + 7) / 8;
  __syncthreads();
  for (int n = threadIdx.x; n < g.ncols; n += AG_THREADS) {
    const float* src = g.R + (n % 3) * g.cstride +
                       static_cast<long long>(ag_neighbor(g, n)) * g.inner;
    float acc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r] = 0.0f;
    for (int ks = 0; ks < nks; ++ks) {
      float b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = ks * 8 + e;
        b[e] = i < g.inner ? __ldg(src + i) : 0.0f;
      }
#pragma unroll
      for (int it = 0; it < IW; ++it) {
        if (g.nz && !g.nz[it * (g.ldl / 8) + ks]) continue;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4* lr = reinterpret_cast<const float4*>(
              g.L + (16 * it + r) * g.ldl + ks * 8);
          const float4 l0 = lr[0], l1 = lr[1];
          float a = acc[16 * it + r];
          a = fmaf(l0.x, b[0], a);
          a = fmaf(l0.y, b[1], a);
          a = fmaf(l0.z, b[2], a);
          a = fmaf(l0.w, b[3], a);
          a = fmaf(l1.x, b[4], a);
          a = fmaf(l1.y, b[5], a);
          a = fmaf(l1.z, b[6], a);
          a = fmaf(l1.w, b[7], a);
          acc[16 * it + r] = a;
        }
      }
    }
    const int o = 3 * ag_neighbor(g, n) + n % 3;
#pragma unroll
    for (int r = 0; r < MR; ++r)
      if (r < g.rows) g.out[r * g.ldo + o] = acc[r];
  }
  __syncthreads();
}

// The product with L built a slab at a time: `build(i0, i1)` (called by
// every thread, between barriers) writes L's columns [i0, i1) at L's
// columns [0, i1 - i0) and their zero flags, and the slabs of `slab`
// columns (a multiple of 8 AG_DEPTH, L's row stride g.ldl covering it)
// follow in inner order, once for each sweep of the columns.  The
// accumulators run on across the slabs, so that every output is the same
// chain of mma k-steps in inner order as ag_run's: the result equals
// ag_run's over whole rows, bit for bit.  Ends with a __syncthreads.
template <int IW, class Build>
__device__ void ag_run_slabs(const AtomGemm& g, int slab, Build build) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int nks = (g.inner + 7) / 8;
  const int sks = slab / 8;                  // k-steps of a slab
  for (int n0 = 0; n0 < g.ncols; n0 += AG_NCOLS) {
    const int ntl = (min(AG_NCOLS, g.ncols - n0) + 7) / 8;
    const bool active = warp < ntl;
    const double* src[AG_JW];
#pragma unroll
    for (int j = 0; j < AG_JW; ++j) {
      const int n = n0 + (warp + 8 * j) * 8 + g8;
      src[j] = nullptr;
      if (warp + 8 * j < ntl && n < g.ncols)
        src[j] = g.R + (n % 3) * g.cstride +
                 static_cast<long long>(ag_neighbor(g, n)) * g.inner;
    }
    double acc[IW][AG_JW][4];
#pragma unroll
    for (int i = 0; i < IW; ++i)
#pragma unroll
      for (int j = 0; j < AG_JW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    double buf[AG_DEPTH][AG_JW][2];
#pragma unroll
    for (int d = 0; d < AG_DEPTH; ++d) ag_fetch(src, g.inner, t4, d, buf[d]);

    for (int s0 = 0; s0 < nks; s0 += sks) {
      const int s1 = min(s0 + sks, nks);
      __syncthreads();                       // the last slab's reads of L
      build(s0 * 8, min(s1 * 8, g.inner));
      __syncthreads();
      if (!active) continue;
      for (int ks0 = s0; ks0 < s1; ks0 += AG_DEPTH) {
#pragma unroll
        for (int d = 0; d < AG_DEPTH; ++d) {
          const int ks = ks0 + d;
          if (ks >= s1) break;
          const double* ls = g.L + (ks - s0) * 8;
#pragma unroll
          for (int i = 0; i < IW; ++i) {
            if (g.nz && !g.nz[i * (g.ldl / 8) + ks - s0]) continue;
            const double* ap = ls + (16 * i + g8) * g.ldl + t4;
            const double a[4] = {ap[0], ap[8 * g.ldl], ap[4],
                                 ap[8 * g.ldl + 4]};
#pragma unroll
            for (int j = 0; j < AG_JW; ++j)
              if (warp + 8 * j < ntl) mma_f64(acc[i][j], a, buf[d][j]);
          }
          ag_fetch(src, g.inner, t4, ks + AG_DEPTH, buf[d]);
        }
      }
    }
    if (!active) continue;

    double* st = g.stage + warp * 128;
#pragma unroll
    for (int j = 0; j < AG_JW; ++j) {
      const int tile = warp + 8 * j;
      if (tile >= ntl) continue;
      const int n = n0 + tile * 8 + (lane & 7);
      const int o = n < g.ncols ? 3 * ag_neighbor(g, n) + n % 3 : -1;
#pragma unroll
      for (int i = 0; i < IW; ++i) {
        __syncwarp();
        reinterpret_cast<double2*>(st)[g8 * 4 + t4] =
            make_double2(acc[i][j][0], acc[i][j][1]);
        reinterpret_cast<double2*>(st)[(g8 + 8) * 4 + t4] =
            make_double2(acc[i][j][2], acc[i][j][3]);
        __syncwarp();
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = 16 * i + 4 * m + (lane >> 3);
          if (o >= 0 && r < g.rows) g.out[r * g.ldo + o] = st[32 * m + lane];
        }
      }
    }
  }
  __syncthreads();
}
