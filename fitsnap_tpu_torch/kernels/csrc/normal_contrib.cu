// K7 normal_contrib: weighted normal equations of a batch of configs.
//
// Per config c the rows are the energy row, 3 A force rows and 6 virial
// rows, read from the row tensors of the rows function:
//   energy row  a = e_cols[c] / n_c        b = (E_c - Eref_c) / n_c
//   force rows  a = force_rows[c, i, d]    b = F[c, i, d] - Fref[c, i, d]
//   virial rows a = virial_rows[c, v]      b = S6[c, v] - Vref[c, v]
// with n_c = max(natoms, 1).  With constant columns (bzeroflag 0) the row
// gains one column per type: the type's atom fraction on the energy row, 0
// elsewhere.  In the SNAP layout (const_cols 1) each type block of the raw
// row leads with its type's column; in the ACE layout (const_cols 2, one
// block of element-resolved labels) the T columns lead the row.  Row
// weights: eweight on the energy row, fweight on the force rows of real
// atoms, vweight on the virial rows, each times live = (natoms > 0) and 0
// for a row kind that the flags leave out.  Then
//   AtA += sum_rows (w a)(w a)^T,  Atb += sum_rows (w a)(w b),
//   nrows = sum_c live (fe + 3 natoms ff + 6 fs)
// and in the residual mode (coeff given) b is replaced by b - a . coeff.
//
// Replaces fitsnap_tpu/parallel/fit.py `config_normal_contrib` (the
// constant columns of both layouts at :288-313, the reference subtraction
// and the accumulation at :315-364).
//
// Bound on the H100: operations at the widths of ACE, chemflag and
// quadratic SNAP (2 W^2 f64 flops per row over the FP64 tensor cores'
// 67 T/s, against W doubles read per row), bytes at linear SNAP's 31.
//
// Design: the Gram matrix of the augmented weighted row [w a | w b] (width
// W + 1), computed as a tiled symmetric product on the FP64 tensor cores.
//   1. rows: one thread per entry writes the augmented weighted rows Aw
//      (rows padded to the slab plan, columns to whole tiles, zeros in the
//      padding): the layout's leading columns, 1/n on the energy row, the
//      weight, w b; one thread counts nrows.  In the residual mode a warp
//      per row then subtracts (w a) . coeff from w b, a warp-shuffle dot in
//      a fixed order;
//   2. gram: one block per (upper output tile of TB x TB, slab of rows).
//      Chunks of KC rows of the tile's two column ranges stream from Aw
//      into a ring of STAGES shared-memory buffers by cp.async, so that
//      the next chunks arrive while four warps multiply the current one
//      with mma.sync m16n8k8 f64 (accumulators in registers).  The slabs
//      split the rows so that the card fills; shared memory depends on TB
//      and KC only, so no width is refused.  With one slab the block
//      writes its tile, the mirror and Atb itself;
//   3. reduce (more than one slab): one block per (tile, strip of SR rows)
//      sums the slabs' partials in slab order and writes the same.
// Without AtA (the residual pass) only the tiles of the last column run.
// No atomics: the output repeats bit for bit from run to run.
//
// Float32 rows (`normal_contrib_f32`, the JAX package's accelerator
// regime, fitsnap_tpu/parallel/fit.py:323-363): pass 1 reads float32 row
// tensors, truths and weights and forms each entry at float32 in the JAX
// order (a / n and (E - Eref) / n and the weight at float32), then widens
// it: Aw holds float64 and the Gram runs on the FP64 tensor cores as
// above, so AtA and Atb come out float64.  In the residual mode the JAX
// pass runs at the rows' type: r = b - a . coeff is formed at float64
// (float32 rows, float64 coeff) and rounded to float32, then weighted;
// so pass 1 writes the unweighted rows and each row's weight, the residual
// kernel rounds r and applies the weight, and Atb (A^T r) is written as
// float32 (summed at float64 on the way, then rounded once).
#include "atom_gemm.cuh"  // mma_f64, cp_async16

namespace {

constexpr int TB = 64;           // edge of an output tile
constexpr int KC = 16;           // rows of a staged chunk
constexpr int LD = TB + 4;       // row stride of a staged chunk (doubles)
constexpr int STAGES = 3;        // chunks in flight
constexpr int GRAM_THREADS = 128;
constexpr int RESID_WARPS = 8;   // rows of a residual block
constexpr int ROW_THREADS = 256;
constexpr int SR = 8;            // tile rows of one reduce block
constexpr int RED_THREADS = 256;

template <typename F>
struct RowArgs {
  const F* e_cols;               // (C, Wr)
  const F* force_rows;           // (C, A, 3, Wr)
  const F* virial_rows;          // (C, 6, Wr)
  const F* ref_e;                // (C,)
  const F* ref_f;                // (C, A, 3)
  const F* ref_v;                // (C, 6)
  const F* energy;               // (C,)
  const F* forces;               // (C, A, 3)
  const F* stress6;              // (C, 6)
  const F* ew;                   // (C,)
  const F* fw;
  const F* vw;
  const int* natoms;             // (C,)
  const int* types;              // (C, A)
  int C, A, T, Wr, W, const_cols, fe, ff, fs;
  // const_cols: 0 none, 1 SNAP layout, 2 ACE layout
};

// What column col of the augmented row holds.
enum ColKind { RAW, LEAD, RHS, PAD };

struct ColMap {
  int raw;                       // RAW: column of the row tensors
  int type;                      // LEAD: the constant column's type
  ColKind kind;
};

template <typename F>
__device__ __forceinline__ ColMap col_map(const RowArgs<F>& p, int col) {
  if (col == p.W) return ColMap{0, 0, RHS};
  if (col > p.W) return ColMap{0, 0, PAD};
  ColMap m{col, 0, RAW};
  if (p.const_cols == 1) {
    const int nco = p.Wr / p.T;  // raw columns per type
    m.type = col / (nco + 1);
    if (col % (nco + 1) == 0) m.kind = LEAD;
    m.raw = m.type * nco + col % (nco + 1) - 1;
  } else if (p.const_cols == 2) {
    m.type = col;
    if (col < p.T) m.kind = LEAD;
    m.raw = col - p.T;
  }
  return m;
}

// The raw row r of config c (r = 0 energy, 1..3A force, then virial).
template <typename F>
__device__ __forceinline__ const F* raw_row(const RowArgs<F>& p, int c,
                                            int r) {
  const int A = p.A;
  if (r == 0) return p.e_cols + static_cast<long long>(c) * p.Wr;
  if (r <= 3 * A)
    return p.force_rows +
           (static_cast<long long>(c) * 3 * A + r - 1) * p.Wr;
  return p.virial_rows +
         (static_cast<long long>(c) * 6 + r - 1 - 3 * A) * p.Wr;
}

// Pass 1: Aw (rows, ldw), one thread per entry; zeros in the
// padding (rows of g >= C (7 + 3A), columns past W); and nrows.  Each
// entry at T, then widened.  With `rw` (the float32 residual mode) the
// entries are unweighted and the column-0 thread of each row writes its
// weight to rw[g].
template <typename F>
__global__ void contrib_rows_kernel(RowArgs<F> p, long long rows, int ldw,
                                    double* __restrict__ aw,
                                    double* __restrict__ nrows,
                                    F* __restrict__ rw) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int A = p.A;
  const int nrow = 1 + 3 * A + 6;
  if (e == 0) {
    double n = 0.0;
    for (int c = 0; c < p.C; ++c) {
      if (p.natoms[c] > 0) n += p.fe + 3.0 * p.natoms[c] * p.ff + 6.0 * p.fs;
    }
    *nrows = n;
  }
  if (e >= rows * ldw) return;
  // rows * ldw < 2^31 (checked at the launch): 32-bit index arithmetic
  const int g = static_cast<int>(e) / ldw;
  const int col = static_cast<int>(e) - g * ldw;
  const ColMap m = col_map(p, col);
  double v = 0.0;
  if (g < p.C * nrow && m.kind != PAD) {
    const int c = g / nrow;
    const int r = g - c * nrow;
    const int na = p.natoms[c];
    const F live = na > 0 ? F(1) : F(0);
    const F nat = static_cast<F>(na > 1 ? na : 1);
    F w;
    if (r == 0) {
      w = p.fe ? p.ew[c] * live : F(0);
    } else if (r <= 3 * A) {
      w = (p.ff && (r - 1) / 3 < na) ? p.fw[c] * live : F(0);
    } else {
      w = p.fs ? p.vw[c] * live : F(0);
    }
    if (rw != nullptr && col == 0) rw[g] = w;
    const double wd = rw != nullptr ? 1.0 : static_cast<double>(w);
    if (m.kind == RHS) {
      F b;
      if (r == 0) {
        b = (p.energy[c] - p.ref_e[c]) / nat;
      } else if (r <= 3 * A) {
        const long long q = static_cast<long long>(c) * 3 * A + r - 1;
        b = p.forces[q] - p.ref_f[q];
      } else {
        const long long q = static_cast<long long>(c) * 6 + r - 1 - 3 * A;
        b = p.stress6[q] - p.ref_v[q];
      }
      v = wd * static_cast<double>(b);
    } else if (m.kind == LEAD) {
      // the type's fraction on the energy row (an exact count), else 0
      if (r == 0) {
        int n = 0;
        for (int i = 0; i < na; ++i) n += p.types[c * A + i] == m.type;
        v = static_cast<double>(static_cast<F>(n) / nat) * wd;
      }
    } else {
      const F x = raw_row(p, c, r)[m.raw];
      v = static_cast<double>(r == 0 ? x / nat : x) * wd;
    }
  }
  aw[e] = v;
}

// The residual mode: w b - (w a) . coeff in Aw's last column, one warp
// per row, lanes strided over the columns, then a fixed butterfly.  With
// `rw` (float32 rows, unweighted in Aw): r = b - a . coeff rounded to
// float32, then the row's weight rw[g] applied to a and to r.
template <typename F>
__global__ void contrib_resid_kernel(const double* __restrict__ coeff,
                                     long long rows, int ldw, int W,
                                     double* __restrict__ aw,
                                     const F* __restrict__ rw) {
  const int lane = threadIdx.x & 31;
  const long long g =
      static_cast<long long>(blockIdx.x) * RESID_WARPS + (threadIdx.x >> 5);
  if (g >= rows) return;
  double* row = aw + g * ldw;
  double dot = 0.0;
  for (int col = lane; col < W; col += 32) dot += row[col] * coeff[col];
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (rw == nullptr) {
    if (lane == 0) row[W] -= dot;
    return;
  }
  const double w = static_cast<double>(rw[g]);
  const F r = static_cast<F>(row[W] - dot);
  __syncwarp();
  for (int col = lane; col < W; col += 32) row[col] *= w;
  if (lane == 0) row[W] = w * static_cast<double>(r);
}

// The (ti, tj) of output tile u: the upper triangle in row order, or with
// only_last the tiles (u, nT - 1) of the last column.
__device__ __forceinline__ void tile_of(int u, int nT, bool only_last,
                                        int& ti, int& tj) {
  if (only_last) {
    ti = u;
    tj = nT - 1;
    return;
  }
  ti = 0;
  while (u >= nT - ti) {
    u -= nT - ti;
    ++ti;
  }
  tj = ti + u;
}

// Entry (row, cl) of tile (ti, tj) into AtA (and its mirror) or Atb (of
// type BT: float in the float32 residual mode, else double).
template <typename BT>
__device__ __forceinline__ void put(int W, int with_ata, int ti, int tj,
                                    int row, int cl, double v,
                                    double* __restrict__ ata,
                                    BT* __restrict__ atb) {
  const int pr = ti * TB + row;
  const int qc = tj * TB + cl;
  if (pr >= W) return;
  if (qc == W) {
    atb[pr] = static_cast<BT>(v);
  } else if (qc < W && with_ata) {
    ata[static_cast<long long>(pr) * W + qc] = v;
    if (ti != tj) ata[static_cast<long long>(qc) * W + pr] = v;
  }
}

// Pass 2: one (upper tile, slab) per block, blockIdx.x = tile * nslab +
// slab, over the slab's per rows of Aw.  With one slab the tile goes to
// ata / atb, else its partial (TB, TB) to partial[blockIdx.x].
template <typename BT>
__global__ void __launch_bounds__(GRAM_THREADS)
    contrib_gram_kernel(const double* __restrict__ aw, int ldw, int per,
                        int nslab, int W, int with_ata,
                        double* __restrict__ partial,
                        double* __restrict__ ata, BT* __restrict__ atb) {
  extern __shared__ double ring[];      // [STAGES][2][KC][LD]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nT = (W + 1 + TB - 1) / TB;
  const int u = blockIdx.x / nslab;
  const int slab = blockIdx.x % nslab;
  int ti, tj;
  tile_of(u, nT, !with_ata, ti, tj);
  const bool diag = ti == tj;           // one column range serves both
  const double* src0 = aw + static_cast<long long>(slab) * per * ldw;
  const int nchunk = per / KC;

  // chunk ch into stage st: KC rows x TB columns of each range, 16 bytes
  // per copy
  auto load = [&](int ch, int st) {
    constexpr int PER_HALF = KC * TB / 2;
    for (int idx = tid; idx < (diag ? 1 : 2) * PER_HALF;
         idx += GRAM_THREADS) {
      const int half = idx / PER_HALF;
      const int k = (idx % PER_HALF) / (TB / 2);
      const int c2 = idx % (TB / 2);
      cp_async16(ring + ((st * 2 + half) * KC + k) * LD + 2 * c2,
                 src0 + static_cast<long long>(ch * KC + k) * ldw +
                     (half ? tj : ti) * TB + 2 * c2);
    }
  };

  // warp (wm, wn) owns a 32 x 32 quarter: 2 x 4 products of 16 x 8
  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int t4 = lane & 3;
  const int g8 = lane >> 2;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nchunk) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int ch = 0; ch < nchunk; ++ch) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    // the stage read in the previous step is free for chunk ch + STAGES - 1
    if (ch + STAGES - 1 < nchunk)
      load(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n" ::);
    const double* xs = ring + (ch % STAGES) * 2 * KC * LD;
    const double* ys = diag ? xs : xs + KC * LD;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (kk + t4 + 4 * h) * LD;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2)
            a[i][2 * h + s2] = xs[row + wm + 16 * i + g8 + 8 * s2];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = ys[row + wn + 8 * j + g8];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], a[i], b[j]);
    }
  }

  double* out = partial + static_cast<long long>(blockIdx.x) * TB * TB;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm + 16 * i + g8 + 8 * (e >> 1);
        const int cl = wn + 8 * j + 2 * t4 + (e & 1);
        if (nslab == 1) {
          put(W, with_ata, ti, tj, row, cl, acc[i][j][e], ata, atb);
        } else {
          out[row * TB + cl] = acc[i][j][e];
        }
      }
}

// Pass 3 (more than one slab): slabs summed in order for SR rows of one
// tile, then written as the one-slab gram does.  blockIdx.x = tile *
// (TB / SR) + strip.
template <typename BT>
__global__ void __launch_bounds__(RED_THREADS)
    contrib_reduce_kernel(const double* __restrict__ partial, int nslab,
                          int W, int with_ata, double* __restrict__ ata,
                          BT* __restrict__ atb) {
  constexpr int PER = SR * TB / RED_THREADS;   // entries per thread
  const int nT = (W + 1 + TB - 1) / TB;
  const int u = blockIdx.x / (TB / SR);
  const int r0 = (blockIdx.x % (TB / SR)) * SR;
  int ti, tj;
  tile_of(u, nT, !with_ata, ti, tj);
  if (ti * TB + r0 >= W) return;
  const double* src = partial + static_cast<long long>(u) * nslab * TB * TB;
  int off[PER];
  bool live[PER];
  double acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = threadIdx.x + e * RED_THREADS;
    off[e] = (r0 + idx / TB) * TB + idx % TB;
    live[e] = tj * TB + idx % TB <= W;
    acc[e] = 0.0;
  }
#pragma unroll 8
  for (int s = 0; s < nslab; ++s) {
#pragma unroll
    for (int e = 0; e < PER; ++e)
      if (live[e]) acc[e] += src[static_cast<long long>(s) * TB * TB + off[e]];
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = threadIdx.x + e * RED_THREADS;
    if (live[e])
      put(W, with_ata, ti, tj, r0 + idx / TB, idx % TB, acc[e], ata, atb);
  }
}

template <typename F, typename BT>
int contrib_launch(const RowArgs<F>& p, const double* coeff, int with_ata,
                   int tile, int ntiles, int nslab, int slab_rows, double* aw,
                   double* partial, double* ata, BT* atb, double* nrows,
                   F* rw, cudaStream_t st) {
  const int C = p.C, A = p.A, W = p.W;
  const int nT = (W + 1 + TB - 1) / TB;
  const long long rows = static_cast<long long>(nslab) * slab_rows;
  if (tile != TB || nslab < 1 || slab_rows % KC != 0 ||
      rows < static_cast<long long>(C) * (7 + 3 * A) ||
      ntiles != (with_ata ? nT * (nT + 1) / 2 : nT))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldw = nT * TB;
  if (rows * ldw >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows * ldw + ROW_THREADS - 1) / ROW_THREADS;
  contrib_rows_kernel<F><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                           ROW_THREADS, 0, st>>>(p, rows, ldw, aw, nrows, rw);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long real = static_cast<long long>(C) * (7 + 3 * A);
  if (coeff != nullptr && real > 0) {
    contrib_resid_kernel<F><<<static_cast<unsigned>(
                                  (real + RESID_WARPS - 1) / RESID_WARPS),
                              RESID_WARPS * 32, 0, st>>>(coeff, real, ldw, W,
                                                         aw, rw);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const size_t smem = sizeof(double) * STAGES * 2 * KC * LD;
  err = fs_allow_smem(contrib_gram_kernel<BT>, smem);
  if (err) return err;
  contrib_gram_kernel<BT><<<static_cast<unsigned>(ntiles) * nslab,
                            GRAM_THREADS, smem, st>>>(
      aw, ldw, slab_rows, nslab, W, with_ata, partial, ata, atb);
  err = static_cast<int>(cudaGetLastError());
  if (err || nslab == 1) return err;
  contrib_reduce_kernel<BT><<<static_cast<unsigned>(ntiles) * (TB / SR),
                              RED_THREADS, 0, st>>>(partial, nslab, W,
                                                    with_ata, ata, atb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row tensors of the rows function, truths, weights and atom counts as in
// RowArgs; coeff (W,) f64 or null for the direct mode.  The tile plan:
// tile = TB (64), ntiles output tiles (the upper triangle of the
// nT = ceil((W + 1) / TB) tile grid with with_ata, else its last column),
// nslab slabs of slab_rows rows (a multiple of KC; nslab * slab_rows >=
// C (7 + 3 A)).  Scratch: aw (nslab * slab_rows, nT * TB) f64, partial
// (ntiles * nslab, TB, TB) f64 (unused with one slab).  Writes ata (W, W)
// (left untouched without with_ata), atb (W,) and nrows ().
extern "C" int normal_contrib(
    const double* e_cols, const double* force_rows, const double* virial_rows,
    const double* ref_e, const double* ref_f, const double* ref_v,
    const double* energy, const double* forces, const double* stress6,
    const double* ew, const double* fw, const double* vw, const int* natoms,
    const int* types, const double* coeff, int C, int A, int T, int Wr,
    int W, int const_cols, int fe, int ff, int fs, int with_ata, int tile,
    int ntiles, int nslab, int slab_rows, double* aw, double* partial,
    double* ata, double* atb, double* nrows, void* stream) {
  const RowArgs<double> p{e_cols, force_rows, virial_rows, ref_e, ref_f,
                          ref_v, energy, forces, stress6, ew, fw, vw,
                          natoms, types, C, A, T, Wr, W, const_cols, fe, ff,
                          fs};
  return contrib_launch<double, double>(
      p, coeff, with_ata, tile, ntiles, nslab, slab_rows, aw, partial, ata,
      atb, nrows, nullptr, static_cast<cudaStream_t>(stream));
}

// Float32 rows: `normal_contrib`'s arguments with the twelve row, truth and
// weight arrays f32 (coeff stays f64).  The direct mode writes ata and atb
// as f64; the residual mode (coeff given) writes atb as f32 and needs the
// scratch rw (nslab * slab_rows,) f32, each row's weight.
extern "C" int normal_contrib_f32(
    const float* e_cols, const float* force_rows, const float* virial_rows,
    const float* ref_e, const float* ref_f, const float* ref_v,
    const float* energy, const float* forces, const float* stress6,
    const float* ew, const float* fw, const float* vw, const int* natoms,
    const int* types, const double* coeff, int C, int A, int T, int Wr,
    int W, int const_cols, int fe, int ff, int fs, int with_ata, int tile,
    int ntiles, int nslab, int slab_rows, double* aw, double* partial,
    double* ata, void* atb, double* nrows, float* rw, void* stream) {
  const RowArgs<float> p{e_cols, force_rows, virial_rows, ref_e, ref_f,
                         ref_v, energy, forces, stress6, ew, fw, vw, natoms,
                         types, C, A, T, Wr, W, const_cols, fe, ff, fs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coeff == nullptr) {
    return contrib_launch<float, double>(
        p, coeff, with_ata, tile, ntiles, nslab, slab_rows, aw, partial, ata,
        static_cast<double*>(atb), nrows, nullptr, st);
  }
  if (rw == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return contrib_launch<float, float>(
      p, coeff, with_ata, tile, ntiles, nslab, slab_rows, aw, partial, ata,
      static_cast<float*>(atb), nrows, rw, st);
}
