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
// block of element-resolved labels) the T columns lead the row.  Row weights: eweight on the energy row, fweight
// on the force rows of real atoms, vweight on the virial rows, each times
// live = (natoms > 0) and 0 for a row kind that the flags leave out.  Then
//   AtA += sum_rows (w a)(w a)^T,  Atb += sum_rows (w a)(w b),
//   nrows = sum_c live (fe + 3 natoms ff + 6 fs)
// and in the residual mode (coeff given) b is replaced by b - a . coeff.
//
// Replaces fitsnap_tpu/parallel/fit.py `config_normal_contrib` (the
// constant columns of both layouts at :288-313, the reference subtraction
// and the accumulation at :315-364).
//
// Bound on the H100: bytes.  Every row (W doubles) is read once; the
// 2 W^2 flops per row are well under the FP64 rate for that traffic at the
// widths of linear SNAP.
//
// Design: pass 1 runs one block per tile of TR rows of one config.  The
// block builds its weighted rows and right-hand sides in shared memory
// (reading each row contiguously), and each thread forms whole entries of
// the tile's partial AtA and Atb in row order.  Pass 2 sums the partials
// of all tiles in a fixed order, one thread per entry, and counts nrows.
// No atomics: AtA repeats bit for bit from run to run.
#include "common.cuh"

namespace {

constexpr int TR = 64;           // rows per tile
constexpr int NC_THREADS = 256;

struct RowArgs {
  const double* e_cols;          // (C, Wr)
  const double* force_rows;      // (C, A, 3, Wr)
  const double* virial_rows;     // (C, 6, Wr)
  const double* ref_e;           // (C,)
  const double* ref_f;           // (C, A, 3)
  const double* ref_v;           // (C, 6)
  const double* energy;          // (C,)
  const double* forces;          // (C, A, 3)
  const double* stress6;         // (C, 6)
  const double* ew;              // (C,)
  const double* fw;
  const double* vw;
  const int* natoms;             // (C,)
  const int* types;              // (C, A)
  const double* coeff;           // (W,) or null
  int C, A, T, Wr, W, const_cols, fe, ff, fs, with_ata, ntiles;
  // const_cols: 0 none, 1 SNAP layout, 2 ACE layout
};

__global__ void contrib_tile_kernel(RowArgs p, double* __restrict__ partial) {
  extern __shared__ double sm[];
  const int W = p.W;
  double* sa = sm;               // [TR][W] rows, then weighted rows
  double* sb = sa + TR * W;      // [TR] right-hand sides, then weighted
  double* sw = sb + TR;          // [TR] row weights
  double* scount = sw + TR;      // [T] atom fraction of each type
  const int c = blockIdx.x / p.ntiles;
  const int r0 = (blockIdx.x % p.ntiles) * TR;
  const int A = p.A;
  const int nrow = 1 + 3 * A + 6;
  const int na = p.natoms[c];
  const double live = na > 0 ? 1.0 : 0.0;
  const double nat = static_cast<double>(na > 1 ? na : 1);
  const int tid = threadIdx.x;
  const int nco = p.const_cols == 1 ? p.Wr / p.T : 0;  // raw cols per type

  if (p.const_cols && r0 == 0) {
    for (int t = tid; t < p.T; t += NC_THREADS) {
      int count = 0;
      for (int i = 0; i < na; ++i) count += p.types[c * A + i] == t;
      scount[t] = count / nat;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TR * W; idx += NC_THREADS) {
    const int r = r0 + idx / W;
    const int col = idx % W;
    double v = 0.0;
    if (r < nrow) {
      int raw = col;
      int type = 0;                 // the type of a leading column
      bool lead = false;
      if (p.const_cols == 1) {
        type = col / (nco + 1);
        lead = col % (nco + 1) == 0;
        raw = type * nco + col % (nco + 1) - 1;
      } else if (p.const_cols == 2) {
        type = col;
        lead = col < p.T;
        raw = col - p.T;
      }
      if (r == 0) {
        v = lead ? scount[type]
                 : p.e_cols[static_cast<long long>(c) * p.Wr + raw] / nat;
      } else if (!lead && r <= 3 * A) {
        v = p.force_rows[(static_cast<long long>(c) * 3 * A + r - 1) * p.Wr +
                         raw];
      } else if (!lead) {
        v = p.virial_rows[(static_cast<long long>(c) * 6 + r - 1 - 3 * A) *
                              p.Wr + raw];
      }
    }
    sa[idx] = v;
  }
  for (int rl = tid; rl < TR; rl += NC_THREADS) {
    const int r = r0 + rl;
    double b = 0.0, w = 0.0;
    if (r == 0) {
      b = (p.energy[c] - p.ref_e[c]) / nat;
      w = p.fe ? p.ew[c] * live : 0.0;
    } else if (r <= 3 * A) {
      const long long q = static_cast<long long>(c) * 3 * A + r - 1;
      b = p.forces[q] - p.ref_f[q];
      w = (p.ff && (r - 1) / 3 < na) ? p.fw[c] * live : 0.0;
    } else if (r < nrow) {
      const long long q = static_cast<long long>(c) * 6 + r - 1 - 3 * A;
      b = p.stress6[q] - p.ref_v[q];
      w = p.fs ? p.vw[c] * live : 0.0;
    }
    sb[rl] = b;
    sw[rl] = w;
  }
  __syncthreads();
  if (p.coeff != nullptr) {
    for (int rl = tid; rl < TR; rl += NC_THREADS) {
      double dot = 0.0;
      for (int col = 0; col < W; ++col) dot += sa[rl * W + col] * p.coeff[col];
      sb[rl] -= dot;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < TR * W; idx += NC_THREADS) sa[idx] *= sw[idx / W];
  for (int rl = tid; rl < TR; rl += NC_THREADS) sb[rl] *= sw[rl];
  __syncthreads();

  const int nout = W * W + W;
  double* out = partial + static_cast<long long>(blockIdx.x) * nout;
  for (int e = tid; e < nout; e += NC_THREADS) {
    double acc = 0.0;
    if (e < W * W) {
      if (p.with_ata) {
        const int a = e / W;
        const int b = e % W;
        for (int rl = 0; rl < TR; ++rl) acc += sa[rl * W + a] * sa[rl * W + b];
      }
    } else {
      const int a = e - W * W;
      for (int rl = 0; rl < TR; ++rl) acc += sa[rl * W + a] * sb[rl];
    }
    out[e] = acc;
  }
}

__global__ void contrib_reduce_kernel(const double* __restrict__ partial,
                                      int nblocks, int W,
                                      const int* __restrict__ natoms, int C,
                                      int fe, int ff, int fs,
                                      double* __restrict__ ata,
                                      double* __restrict__ atb,
                                      double* __restrict__ nrows) {
  const int nout = W * W + W;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < nout) {
    double acc = 0.0;
    for (int b = 0; b < nblocks; ++b)
      acc += partial[static_cast<long long>(b) * nout + e];
    if (e < W * W) {
      ata[e] = acc;
    } else {
      atb[e - W * W] = acc;
    }
  } else if (e == nout) {
    double n = 0.0;
    for (int c = 0; c < C; ++c) {
      if (natoms[c] > 0) n += fe + 3.0 * natoms[c] * ff + 6.0 * fs;
    }
    *nrows = n;
  }
}

}  // namespace

// Row tensors of the rows function, truths, weights and atom counts as in
// RowArgs; coeff (W,) f64 or null for the direct mode; partial
// (C * ntiles, W * W + W) f64 scratch with ntiles = ceil((7 + 3 A) / TR).
// Writes ata (W, W), atb (W,) and nrows ().
extern "C" int normal_contrib(
    const double* e_cols, const double* force_rows, const double* virial_rows,
    const double* ref_e, const double* ref_f, const double* ref_v,
    const double* energy, const double* forces, const double* stress6,
    const double* ew, const double* fw, const double* vw, const int* natoms,
    const int* types, const double* coeff, int C, int A, int T, int Wr,
    int W, int const_cols, int fe, int ff, int fs, int with_ata,
    double* partial, double* ata, double* atb, double* nrows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (7 + 3 * A + TR - 1) / TR;
  const RowArgs p{e_cols, force_rows, virial_rows, ref_e, ref_f, ref_v,
                  energy, forces, stress6, ew, fw, vw, natoms, types, coeff,
                  C, A, T, Wr, W, const_cols, fe, ff, fs, with_ata, ntiles};
  const size_t smem = sizeof(double) * (static_cast<size_t>(TR) * W +
                                        2 * TR + T);
  int err = fs_allow_smem(contrib_tile_kernel, smem);
  if (err) return err;
  const long long nblocks = static_cast<long long>(C) * ntiles;
  if (nblocks > 0) {
    contrib_tile_kernel<<<static_cast<unsigned>(nblocks), NC_THREADS, smem,
                          st>>>(p, partial);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  const int nout = W * W + W + 1;
  contrib_reduce_kernel<<<(nout + 255) / 256, 256, 0, st>>>(
      partial, static_cast<int>(nblocks), W, natoms, C, fe, ff, fs, ata, atb,
      nrows);
  return static_cast<int>(cudaGetLastError());
}
