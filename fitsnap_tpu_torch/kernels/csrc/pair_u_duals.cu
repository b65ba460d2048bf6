// K1 pair_u_duals: the Wigner-U expansion of every neighbor pair, its three
// displacement tangents weighted into the pair jacobian
//   J[c, a, k, u] = d(w U[u]) / d disp[a, k, c],
// and the neighbor sum utot.  In the chemflag mode (nc > 1 element channels)
// each neighbor is summed into the channel of its element, and the self term
// goes into every channel under wselfallflag, else into the atom's own
// (fitsnap_tpu/ops/snap.py:769-787).
//
// Replaces fitsnap_tpu/ops/snap.py `_ck_prologue` + `_pair_wu_duals` +
// `_utot_from_wu` (the TPU form: jax.jvp of the prologue, an unrolled
// monomial product chain, and a dense (n_mono, 2U) change-of-basis GEMM).
// The weighted expansion wu itself is not an output: no caller reads it.
//
// Bound on the H100: bytes.  Per pair the kernel writes the 3 x 2U doubles
// of J (6.7 KB at twojmax 6), against about 13 kflop of FP64 work.
//
// Design.  U = L M, M the monomials ar^p ai^q br^r bi^s of degree <= twojmax
// (ops/mono.py), and L is block-diagonal by degree: a column of level j reads
// degree-j monomials only.  The tangents go through the partials
//   dU/dv = L_v M,   L_v[m, u] = (e_v(m) + 1) L[m + e_v, u],
// which read the degree j - 1 monomials, so that the four prologue variables'
// tangents are applied per column (Ut_c = sum_v dv/dx_c dU/dv) and the
// monomials are values only.  utot is L applied once to the weighted
// monomial sum W[m] = sum_k w_k M_k[m], summed over the neighbors in
// neighbor order.  The host lists each column's nonzeros of L and of the
// four L_v (`snap_kernels.pair_u_tables`).
//   * A block is (atom, split).  A split is a range of column chunks (at
//     most 4 columns, starting at an even column where it can) in level
//     order, the host's cut of the columns into equal shares of entries
//     where the chunk of atoms is small, so that the grid fills the card;
//     the split's window holds the monomials its columns read.
//   * The atom's live slots are listed by ballot, in slot order; the block
//     walks them in tiles of 32 pairs, one pair a lane.  Warp 0 evaluates
//     the tile's prologue (forward-mode duals, prologue.cuh) and the powers
//     of ar, ai, br, bi a pair a lane into shared memory; every warp then
//     forms a share of the window's monomials (products of 4 powers),
//     [monomial][pair], and the block adds the tile's pairs into W, a
//     thread a monomial, pair by pair.  W's channels are the window rows'
//     last columns (row stride (32 + nc) | 1: odd, so that a warp reads a
//     row or a column without bank conflicts).
//   * The warps take the split's chunks in turn, in column order (warp w
//     the chunks 8 r + w), so that they sweep the J rows together.  The
//     host lays a chunk's entries out by column and accumulator as steps
//     of 4 entries (the last padded with zero coefficients), each entry of
//     a step in its own slot, so that a step is 4 independent FMA chains,
//     behind a header (the chunk's columns and the runs' ends); a step is
//     40 bytes (4 coefficients, 4 16-bit window offsets).  A warp
//     prefetches its next chunk with cp.async into the other half of its
//     double buffer while it works on the current one; each step goes to
//     every lane as five 8-byte broadcasts (4 coefficients, the offsets),
//     and each lane applies it to its pair: 4 conflict-free shared loads
//     and 4 FMAs.  An accumulator is its slots' sums, (s0 + s1) + (s2 +
//     s3).  Each lane forms J for its pair and the chunk's columns in
//     registers and stores its row segments directly, 16 bytes a store
//     where the columns are aligned (a chunk starts at an even column where
//     it can).  A chunk holds a bounded number of entries (the host's cap),
//     so that it fits a buffer half.
//   * Masked slots get J = 0 rows (zero stores over the split's column
//     runs, a warp a slot).  utot = the U entries of each column applied to
//     W (a lane a channel), plus the self term.
// The host raises the split count until a window fits a block's shared
// memory.  Each split repeats its pairs' prologue and monomials, so the
// host takes this shape only where a window fits within 16 splits (to
// twojmax 10); past it, and where no window fits (twojmax 13 and up: a
// level's columns read more monomials than a window of 32 pairs can hold),
// the table shape (`pair_u_table`) runs instead:
//   * every monomial ar^p ai^q br^r bi^s is the product of two table
//     entries, X[p, q] = ar^p ai^q and Y[r, s] = br^r bi^s, over the
//     (twojmax + 1)(twojmax + 2) / 2 exponent pairs of degree <= twojmax
//     (153 at twojmax 16): the block keeps the two tables of the tile's
//     pairs, [pair row][pair] (80 KB at twojmax 16), in place of a window;
//     all warps form them from warp 0's powers;
//   * a step's offsets double holds each slot's X row and Y row as 8-bit
//     indices; a slot's term is c X[row] Y[row'];
//   * utot is no longer L applied to W: each chunk column's U value of a
//     lane's pair, weighted, is summed over the tile's pairs by a fixed xor
//     butterfly (a channel at a time in the chemflag mode) and added into
//     the block's own copy of the atom's utot in shared memory (set to the
//     self term first), tile by tile in neighbor order; the split's columns
//     of it are stored at the end.
// Any twojmax up to 16 and the chemflag modes run in one shape or the
// other.  No atomics: the output repeats bit for bit.
// Working types: the window shape also has a float32 instantiation
// (`pair_u_duals_f32`, the streamed linear SNAP fit at float32), whose
// plan holds float32 coefficients, each rounded once from the float64
// change of basis (a step is then 24 bytes: 4 floats, the offsets), and
// which computes the prologue, the monomials, W, J and utot in float32.
// The table shape runs at float64 only.
#include <math.h>

#include "common.cuh"
#include "prologue.cuh"

namespace {

constexpr int NW = 8;         // warps of a block
constexpr int TP = 32;        // pairs of a tile, one a lane
constexpr int CW = 4;         // most columns of a chunk
constexpr int NPRO = 20;      // prologue values a pair (see below)
constexpr int STEP = 5;       // doubles of a table-shape step (see there)

// The window shape's step and header in units of the working type T: a
// step is 4 coefficients and the 4 uint16 window offsets (8 bytes: one
// double, two floats), a header 96 bytes.
template <typename T>
__host__ __device__ constexpr int step_units() {
  return 4 + 8 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int hdr_units() {
  return 96 / static_cast<int>(sizeof(T));
}

// Host tables of one split plan (`snap_kernels.pair_u_tables`).
template <typename T>
struct Plan {
  const T* blob;        // chunks: a header of 24 ints (first column,
                        // columns, two unused, then the step ends of the
                        // 4 x 5 (column, accumulator) runs, accumulators
                        // U, dU/dar, dU/dai, dU/dbr, dU/dbi), then steps
                        // (coefficients c[4] at T, then the window offsets,
                        // slot * row stride, as 4 uint16), padded to 16
                        // bytes
  const int2* loc;      // (nchunks,): first unit and units of a chunk,
                        // by (split, warp)
  const int* cw_ptr;    // (S * NW + 1,): chunks of (split, warp)
  const int* win_ptr;   // (S + 1,): window slots of each split
  const int* win_exp;   // exponents p | q << 8 | r << 16 | s << 24
  const int* zr_ptr;    // (S + 1,): column runs of each split
  const int2* zruns;    // [u0, u1)
  int max_win, max_wch, bufd;  // sizes of the shared buffers (bufd in T)
};

// Row stride of the window: the tile's pairs, W's channels, odd.
__host__ __device__ __forceinline__ int row_stride(int nc) {
  return (TP + nc) | 1;
}

// Values of the window, a multiple of 16 bytes so that the buffers after
// it are 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ long long window_size(int max_win,
                                                         int nc) {
  constexpr long long q = 16 / sizeof(T);
  return (static_cast<long long>(max_win) * row_stride(nc) + q - 1) &
         ~(q - 1);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sum of steps [st, st1) applied to the window column x (the lane's pair,
// or a channel of W): 4 chains, (s0 + s1) + (s2 + s3).
template <typename T>
__device__ __forceinline__ T run_sum(const T* b, int st, int st1,
                                     const T* x) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll 2
  for (; st < st1; ++st) {
    const T* r = b + st * step_units<T>();
    const unsigned long long o =
        *reinterpret_cast<const unsigned long long*>(r + 4);
    s0 += r[0] * x[o & 0xffff];
    s1 += r[1] * x[(o >> 16) & 0xffff];
    s2 += r[2] * x[(o >> 32) & 0xffff];
    s3 += r[3] * x[o >> 48];
  }
  return (s0 + s1) + (s2 + s3);
}

// Two consecutive values of a J row, one 8- (float) or 16-byte (double)
// store; the caller keeps the first at an even column.
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(NW * 32, 2) pair_u_duals_kernel(
    const T* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const T* __restrict__ elem, Scalars s, long long natoms, int K,
    Plan<T> pl, int twojmax, int two_u, int nc, int wselfall,
    const T* __restrict__ selfvec, T* __restrict__ J, T* __restrict__ ut) {
  extern __shared__ __align__(16) unsigned char smem_w[];
  constexpr int HU = hdr_units<T>();
  const int ms = row_stride(nc);
  // [max_win][ms]: the tile's pairs' monomials, then W's channels
  T* M = reinterpret_cast<T*>(smem_w);
  T* W = M + TP;
  // [NPRO][TP]: ar, ai, br, bi; w; dw/dx_c (3); dv/dx_c (v * 3 + c, 12)
  T* pro = M + window_size<T>(pl.max_win, nc);
  T* pw = pro + NPRO * TP;          // [4][twojmax + 1][TP]: the powers
  T* sbuf = pw + 4 * (twojmax + 1) * TP;             // [NW][2][bufd]
  int2* sloc = reinterpret_cast<int2*>(sbuf + 2 * NW * pl.bufd);
  int* swin = reinterpret_cast<int*>(sloc + NW * pl.max_wch);  // [max_win]
  int* slots = swin + pl.max_win;                    // [K]
  int* tch = slots + K;                              // [TP] pair channels
  int* cnt = tch + TP;                               // live slots

  const long long a = blockIdx.x;
  const int sp = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ie = ielem[a];
  const long long rows = natoms * K;  // J rows of one direction

  // live slots first in slot order, masked ones from the end
  if (warp == 0) {
    int nl = 0, nm = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool live = k < K && mask[a * K + k] != 0;
      const bool dead = k < K && !live;
      const unsigned bl = __ballot_sync(0xffffffffu, live);
      const unsigned bd = __ballot_sync(0xffffffffu, dead);
      const unsigned below = (1u << lane) - 1u;
      if (live) slots[nl + __popc(bl & below)] = k;
      if (dead) slots[K - 1 - (nm + __popc(bd & below))] = k;
      nl += __popc(bl);
      nm += __popc(bd);
    }
    if (lane == 0) cnt[0] = nl;
  }
  const int w0 = pl.win_ptr[sp];
  const int nwin = pl.win_ptr[sp + 1] - w0;
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    swin[i] = pl.win_exp[w0 + i];
    for (int e = 0; e < nc; ++e) W[i * ms + e] = T(0);
  }
  const int c0 = pl.cw_ptr[sp * NW + warp];
  const int nch = pl.cw_ptr[sp * NW + warp + 1] - c0;
  int2* loc = sloc + warp * pl.max_wch;
  for (int i = lane; i < nch; i += 32) loc[i] = pl.loc[c0 + i];
  __syncthreads();
  const int nlive = cnt[0];

  // masked slots: zero rows over the split's columns
  for (int r = pl.zr_ptr[sp]; r < pl.zr_ptr[sp + 1]; ++r) {
    const int2 run = pl.zruns[r];
    for (int mi = warp; mi < K - nlive; mi += NW) {
      const long long base = a * K + slots[K - 1 - mi];
      for (int u = run.x + lane; u < run.y; u += 32)
        for (int c = 0; c < 3; ++c) J[(c * rows + base) * two_u + u] = T(0);
    }
  }

  T* buf = sbuf + warp * 2 * pl.bufd;
  constexpr int V16 = 16 / sizeof(T);    // values of a 16-byte copy
  // chunk k of the warp into buffer half k & 1
  auto fetch = [&](int k) {
    const int2 l = loc[k];
    const T* src = pl.blob + l.x;
    T* dst = buf + (k & 1) * pl.bufd;
    for (int i = lane; i < l.y / V16; i += 32)
      cp16(dst + V16 * i, src + V16 * i);
    cp_commit();
  };
  const T* Ml = M + lane;
  for (int t0 = 0; t0 < nlive; t0 += TP) {
    const int np = min(TP, nlive - t0);
    if (warp == 0) {
      DualT<T> out[5];
      int chn = -1;
      if (lane < np) {
        const long long pk = a * K + slots[t0 + lane];
        chn = jelem[pk];
        prologue(disp[pk * 3], disp[pk * 3 + 1], disp[pk * 3 + 2], true, ie,
                 chn, elem, s, out);
      } else {
        prologue(T(1), T(0), T(0), false, ie, 0, elem, s, out);
      }
      for (int v = 0; v < 4; ++v) {
        pro[v * TP + lane] = out[v].v;
        for (int c = 0; c < 3; ++c)
          pro[(8 + v * 3 + c) * TP + lane] = out[v].d[c];
      }
      pro[4 * TP + lane] = out[4].v;
      for (int c = 0; c < 3; ++c) pro[(5 + c) * TP + lane] = out[4].d[c];
      tch[lane] = nc == 1 ? 0 : chn;
      for (int v = 0; v < 4; ++v) {
        T x = T(1);
        for (int e = 0; e <= twojmax; ++e) {
          pw[(v * (twojmax + 1) + e) * TP + lane] = x;
          x *= out[v].v;
        }
      }
    }
    __syncthreads();
    const T w = pro[4 * TP + lane];
    T wt[3], dv[4][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wt[c] = pro[(5 + c) * TP + lane];
#pragma unroll
      for (int v = 0; v < 4; ++v) dv[v][c] = pro[(8 + v * 3 + c) * TP + lane];
    }
    {
      const T* pl0 = pw + lane;
      const T* pl1 = pl0 + (twojmax + 1) * TP;
      const T* pl2 = pl1 + (twojmax + 1) * TP;
      const T* pl3 = pl2 + (twojmax + 1) * TP;
      for (int i = warp; i < nwin; i += NW) {
        const int e = swin[i];
        M[i * ms + lane] = pl0[(e & 255) * TP] * pl1[((e >> 8) & 255) * TP] *
                           pl2[((e >> 16) & 255) * TP] * pl3[(e >> 24) * TP];
      }
    }
    __syncthreads();
    // W += the tile's pairs, in neighbor order, a thread a monomial
    for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
      const T* mi = M + i * ms;
      T* wi = W + i * ms;
      if (nc == 1) {
        T v = wi[0];
        for (int p = 0; p < np; ++p) v += pro[4 * TP + p] * mi[p];
        wi[0] = v;
      } else {
        for (int p = 0; p < np; ++p) {
          const int e = tch[p];
          if (e >= 0 && e < nc) wi[e] += pro[4 * TP + p] * mi[p];
        }
      }
    }

    if (nch > 0) fetch(0);
    for (int k = 0; k < nch; ++k) {
      if (k + 1 < nch) {
        fetch(k + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncwarp();
      const T* hb = buf + (k & 1) * pl.bufd;
      const int* m = reinterpret_cast<const int*>(hb);
      const T* b = hb + HU;
      const int col0 = m[0], ncols = m[1];
      T jv[3][CW];
      int st = 0;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        if (cc >= ncols) break;
        T col[5];
#pragma unroll
        for (int g = 0; g < 5; ++g) {
          const int st1 = m[4 + cc * 5 + g];
          col[g] = run_sum(b, st, st1, Ml);
          st = st1;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T tan = dv[0][c] * col[1] + dv[1][c] * col[2] +
                        dv[2][c] * col[3] + dv[3][c] * col[4];
          jv[c][cc] = w * tan + wt[c] * col[0];
        }
      }
      // the lane's row segments, two values a store where aligned
      if (lane < np) {
        const long long kk = a * K + slots[t0 + lane];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          T* row = J + (c * rows + kk) * two_u + col0;
          if ((col0 & 1) == 0) {
#pragma unroll
            for (int cc = 0; cc < CW; cc += 2) {
              if (cc + 1 < ncols)
                store2(row + cc, jv[c][cc], jv[c][cc + 1]);
              else if (cc < ncols)
                row[cc] = jv[c][cc];
            }
          } else {
            row[0] = jv[c][0];
#pragma unroll
            for (int cc = 1; cc < CW; cc += 2) {
              if (cc + 1 < ncols)
                store2(row + cc, jv[c][cc], jv[c][cc + 1]);
              else if (cc < ncols)
                row[cc] = jv[c][cc];
            }
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // utot: each column's U entries applied to W, a lane a channel
  for (int k = 0; k < nch; ++k) {
    fetch(k);
    cp_wait<0>();
    __syncwarp();
    const T* hb = buf + (k & 1) * pl.bufd;
    const int* m = reinterpret_cast<const int*>(hb);
    for (int cc = 0; cc < m[1]; ++cc) {
      const int u = m[0] + cc;
      const int st = cc == 0 ? 0 : m[4 + cc * 5 - 1];
      for (int e = lane; e < nc; e += 32) {
        const bool self = nc == 1 || wselfall || e == ie;
        ut[(a * nc + e) * two_u + u] =
            run_sum(hb + HU, st, m[4 + cc * 5], W + e) +
            (self ? selfvec[u] : T(0));
      }
    }
    __syncwarp();
  }
}

// Shared memory of one block: the window, the tile's prologue and powers,
// the warps' double buffers, the warps' chunk locations, the window's
// exponents, the slot lists (`snap_kernels.pair_u_smem`).
template <typename T>
long long pair_u_duals_smem(const Plan<T>& pl, int twojmax, int nc, int K) {
  return static_cast<long long>(sizeof(T)) *
             (window_size<T>(pl.max_win, nc) + NPRO * TP +
              4LL * (twojmax + 1) * TP + 2LL * NW * pl.bufd) +
         static_cast<long long>(sizeof(int)) *
             (2 * NW * pl.max_wch + pl.max_win + K + TP + 1);
}

template <typename T>
int pair_u_duals_launch(const T* disp, const int* jelem,
                        const unsigned char* mask, const int* ielem,
                        const T* elem, double rcutfac, double rfac0,
                        double rmin0, int switchflag, int switchinnerflag,
                        long long natoms, int K, const T* blob, const int* loc,
                        const int* cw_ptr, const int* win_ptr,
                        const int* win_exp, const int* zr_ptr,
                        const int* zruns, int nsplit, int max_win,
                        int max_wch, int bufd, int twojmax, int two_u, int nc,
                        int wselfall, const T* selfvec, T* J, T* ut,
                        void* stream) {
  const Scalars s{rcutfac, rfac0, rmin0, switchflag, switchinnerflag};
  const Plan<T> pl{blob,    reinterpret_cast<const int2*>(loc),
                   cw_ptr,  win_ptr,
                   win_exp, zr_ptr,
                   reinterpret_cast<const int2*>(zruns),
                   max_win, max_wch,
                   bufd};
  const long long smem = pair_u_duals_smem(pl, twojmax, nc, K);
  if (nsplit < 1 || nsplit > 65535 || (bufd * sizeof(T)) % 16 ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = fs_allow_smem(pair_u_duals_kernel<T>, smem);
  if (err) return err;
  if (natoms > 0) {
    const dim3 grid(static_cast<unsigned>(natoms),
                    static_cast<unsigned>(nsplit));
    pair_u_duals_kernel<T><<<grid, NW * 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        disp, jelem, mask, ielem, elem, s, natoms, K, pl, twojmax, two_u, nc,
        wselfall, selfvec, J, ut);
  }
  return static_cast<int>(cudaGetLastError());
}

// The table shape.  Row stride of the pair tables X and Y, odd.
constexpr int TS = TP | 1;
constexpr int HREC = 3;       // steps' worth of doubles of a chunk's header
constexpr int PIECE = 64;     // steps of a piece of a warp's stream

// Exponent pairs of degree <= twojmax: the rows of X and of Y.
__host__ __device__ __forceinline__ int table_rows(int twojmax) {
  return (twojmax + 1) * (twojmax + 2) / 2;
}

// Host tables of a table-shape plan (`snap_kernels.pair_u_tables(...,
// "table")`): each (split, warp) one stream of STEP-double records, the
// warp's chunks in order, each a header of HREC records (24 ints, as the
// window shape's, then zeros) and its steps; a header that would cross a
// PIECE boundary starts at the next one (zero records between), and a
// stream holds an even number of records.
struct TablePlan {
  const double* blob;   // the streams
  const int* wrec;      // (S * NW + 1,): first record of each stream
  const int* zr_ptr;    // (S + 1,): column runs of each split
  const int2* zruns;    // [u0, u1)
};

__global__ void __launch_bounds__(NW * 32, 1) pair_u_table_kernel(
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, long long natoms, int K,
    TablePlan pl, int twojmax, int two_u, int nc, int wselfall,
    const double* __restrict__ selfvec, double* __restrict__ J,
    double* __restrict__ ut) {
  extern __shared__ double smem[];
  const int nrow = table_rows(twojmax);
  // [nrow][TS] each: X (ar^p ai^q) and Y (br^r bi^s) of the tile's pairs
  double* X = smem;
  double* Y = X + nrow * TS;
  double* pro = Y + nrow * TS;      // [NPRO][TP], as the window shape's
  double* pw = pro + NPRO * TP;     // [4][twojmax + 1][TP]: the powers
  double* us = pw + 4 * (twojmax + 1) * TP;          // [nc][two_u] utot
  double* sbuf = us + ((static_cast<long long>(nc) * two_u + 1) & ~1LL);
  int* slots = reinterpret_cast<int*>(sbuf + 2 * NW * PIECE * STEP);  // [K]
  int* tch = slots + K;                              // [TP] pair channels
  int* cnt = tch + TP;                               // live slots

  const long long a = blockIdx.x;
  const int sp = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ie = ielem[a];
  const long long rows = natoms * K;  // J rows of one direction

  // live slots first in slot order, masked ones from the end
  if (warp == 0) {
    int nl = 0, nm = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool live = k < K && mask[a * K + k] != 0;
      const bool dead = k < K && !live;
      const unsigned bl = __ballot_sync(0xffffffffu, live);
      const unsigned bd = __ballot_sync(0xffffffffu, dead);
      const unsigned below = (1u << lane) - 1u;
      if (live) slots[nl + __popc(bl & below)] = k;
      if (dead) slots[K - 1 - (nm + __popc(bd & below))] = k;
      nl += __popc(bl);
      nm += __popc(bd);
    }
    if (lane == 0) cnt[0] = nl;
  }
  // the split's columns of utot start at the self term
  for (int r = pl.zr_ptr[sp]; r < pl.zr_ptr[sp + 1]; ++r) {
    const int2 run = pl.zruns[r];
    for (int u = run.x + threadIdx.x; u < run.y; u += blockDim.x)
      for (int e = 0; e < nc; ++e)
        us[e * two_u + u] = nc == 1 || wselfall || e == ie ? selfvec[u] : 0.0;
  }
  __syncthreads();
  const int nlive = cnt[0];

  // masked slots: zero rows over the split's columns
  for (int r = pl.zr_ptr[sp]; r < pl.zr_ptr[sp + 1]; ++r) {
    const int2 run = pl.zruns[r];
    for (int mi = warp; mi < K - nlive; mi += NW) {
      const long long base = a * K + slots[K - 1 - mi];
      for (int u = run.x + lane; u < run.y; u += 32)
        for (int c = 0; c < 3; ++c) J[(c * rows + base) * two_u + u] = 0.0;
    }
  }

  // the warp's stream, read in pieces of PIECE records into the two halves
  // of its buffer: the next piece in flight while the warp works on one
  const int r0 = pl.wrec[sp * NW + warp];
  const int nrec = pl.wrec[sp * NW + warp + 1] - r0;
  const int npc = (nrec + PIECE - 1) / PIECE;
  const double* stream = pl.blob + static_cast<long long>(r0) * STEP;
  double* sb = sbuf + warp * 2 * PIECE * STEP;
  auto load = [&](int pc) {
    const double* src = stream + static_cast<long long>(pc) * PIECE * STEP;
    double* dst = sb + (pc & 1) * PIECE * STEP;
    const int n = min(PIECE, nrec - pc * PIECE) * STEP;
    for (int i = lane; i < (n + 1) / 2; i += 32)
      cp16(dst + 2 * i, src + 2 * i);
    cp_commit();
  };
  int cur = -1;
  // record ri of the stream, its piece resident
  auto at = [&](int ri) -> const double* {
    const int pc = ri / PIECE;
    if (pc != cur) {
      __syncwarp();
      cur = pc;
      if (pc + 1 < npc) {
        load(pc + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncwarp();
    }
    return sb + (pc & 1) * PIECE * STEP + (ri % PIECE) * STEP;
  };
  const double* Xl = X + lane;
  const double* Yl = Y + lane;
  for (int t0 = 0; t0 < nlive; t0 += TP) {
    const int np = min(TP, nlive - t0);
    if (warp == 0) {
      Dual out[5];
      int chn = -1;
      if (lane < np) {
        const long long pk = a * K + slots[t0 + lane];
        chn = jelem[pk];
        prologue(disp[pk * 3], disp[pk * 3 + 1], disp[pk * 3 + 2], true, ie,
                 chn, elem, s, out);
      } else {
        prologue(1.0, 0.0, 0.0, false, ie, 0, elem, s, out);
      }
      for (int v = 0; v < 4; ++v) {
        pro[v * TP + lane] = out[v].v;
        for (int c = 0; c < 3; ++c)
          pro[(8 + v * 3 + c) * TP + lane] = out[v].d[c];
      }
      pro[4 * TP + lane] = lane < np ? out[4].v : 0.0;
      for (int c = 0; c < 3; ++c) pro[(5 + c) * TP + lane] = out[4].d[c];
      tch[lane] = lane < np ? (nc == 1 ? 0 : chn) : -1;
      for (int v = 0; v < 4; ++v) {
        double x = 1.0;
        for (int e = 0; e <= twojmax; ++e) {
          pw[(v * (twojmax + 1) + e) * TP + lane] = x;
          x *= out[v].v;
        }
      }
    }
    if (npc > 0) load(0);
    cur = -1;
    __syncthreads();
    // the tables, a warp a row: X[p, q] = ar^p ai^q, Y[r, s] = br^r bi^s,
    // rows by first exponent, then second
    for (int i = warp; i < 2 * nrow; i += NW) {
      const int tab = i >= nrow;
      int e0 = 0, e1 = i - tab * nrow;
      while (e1 > twojmax - e0) {
        e1 -= twojmax + 1 - e0;
        ++e0;
      }
      const double* p0 = pw + 2 * tab * (twojmax + 1) * TP + lane;
      const double* p1 = p0 + (twojmax + 1) * TP;
      (tab ? Y : X)[(i - tab * nrow) * TS + lane] = p0[e0 * TP] * p1[e1 * TP];
    }
    const double w = pro[4 * TP + lane];
    const int my_ch = tch[lane];
    double wt[3], dv[4][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wt[c] = pro[(5 + c) * TP + lane];
#pragma unroll
      for (int v = 0; v < 4; ++v) dv[v][c] = pro[(8 + v * 3 + c) * TP + lane];
    }
    __syncthreads();

    int ri = 0;
    while (ri < nrec) {
      int ends[CW * 5];
      int col0, ncols;
      {
        const int* m = reinterpret_cast<const int*>(at(ri));
        col0 = m[0];
        ncols = m[1];
#pragma unroll
        for (int i = 0; i < CW * 5; ++i) ends[i] = m[4 + i];
      }
      if (ncols == 0) break;             // the stream's padding
      const int sr = ri + HREC;          // the chunk's first step
      double jv[3][CW];
      int st = sr;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        if (cc >= ncols) break;
        double col[5];
#pragma unroll
        for (int g = 0; g < 5; ++g) {
          const int st1 = sr + ends[cc * 5 + g];
          double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
          for (; st < st1; ++st) {
            const double* r = at(st);
            const unsigned long long o = __double_as_longlong(r[4]);
            s0 += r[0] * (Xl[(o & 255) * TS] * Yl[((o >> 8) & 255) * TS]);
            s1 += r[1] *
                  (Xl[((o >> 16) & 255) * TS] * Yl[((o >> 24) & 255) * TS]);
            s2 += r[2] *
                  (Xl[((o >> 32) & 255) * TS] * Yl[((o >> 40) & 255) * TS]);
            s3 += r[3] * (Xl[((o >> 48) & 255) * TS] * Yl[(o >> 56) * TS]);
          }
          col[g] = (s0 + s1) + (s2 + s3);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const double tan = dv[0][c] * col[1] + dv[1][c] * col[2] +
                             dv[2][c] * col[3] + dv[3][c] * col[4];
          jv[c][cc] = w * tan + wt[c] * col[0];
        }
        // utot: the tile's weighted U values of the column, by channel
        const double wu = w * col[0];
        for (int e = 0; e < nc; ++e) {
          double v = my_ch == e ? wu : 0.0;
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) us[e * two_u + col0 + cc] += v;
        }
      }
      // the lane's row segments, 16 bytes a store where aligned
      if (lane < np) {
        const long long kk = a * K + slots[t0 + lane];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          double* row = J + (c * rows + kk) * two_u + col0;
          if ((col0 & 1) == 0) {
#pragma unroll
            for (int cc = 0; cc < CW; cc += 2) {
              if (cc + 1 < ncols)
                *reinterpret_cast<double2*>(row + cc) =
                    make_double2(jv[c][cc], jv[c][cc + 1]);
              else if (cc < ncols)
                row[cc] = jv[c][cc];
            }
          } else {
            row[0] = jv[c][0];
#pragma unroll
            for (int cc = 1; cc < CW; cc += 2) {
              if (cc + 1 < ncols)
                *reinterpret_cast<double2*>(row + cc) =
                    make_double2(jv[c][cc], jv[c][cc + 1]);
              else if (cc < ncols)
                row[cc] = jv[c][cc];
            }
          }
        }
      }
      // the next header, at the next piece where it would cross one
      ri = sr + ends[CW * 5 - 1];
      if (ri % PIECE > PIECE - HREC) ri += PIECE - ri % PIECE;
    }
    cp_wait<0>();
    __syncthreads();
  }

  // the split's columns of utot
  for (int r = pl.zr_ptr[sp]; r < pl.zr_ptr[sp + 1]; ++r) {
    const int2 run = pl.zruns[r];
    for (int u = run.x + threadIdx.x; u < run.y; u += blockDim.x)
      for (int e = 0; e < nc; ++e)
        ut[(a * nc + e) * two_u + u] = us[e * two_u + u];
  }
}

// Shared memory of one block of the table shape: the two tables, the
// tile's prologue and powers, utot, the warps' stream buffers, the slot
// lists (`snap_kernels.pair_u_smem`).
long long pair_u_table_smem(int twojmax, int two_u, int nc, int K) {
  return static_cast<long long>(sizeof(double)) *
             (2LL * table_rows(twojmax) * TS + NPRO * TP +
              4LL * (twojmax + 1) * TP +
              ((static_cast<long long>(nc) * two_u + 1) & ~1LL) +
              2LL * NW * PIECE * STEP) +
         static_cast<long long>(sizeof(int)) * (K + TP + 1);
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) u8, ielem (N,) i32,
// elem (nelem, 4) f64; the split plan of `snap_kernels.pair_u_tables`
// (nsplit splits; the largest window max_win slots, max_wch chunks of a
// warp, and bufd doubles a buffer half); twojmax (the largest exponent of
// a monomial); nc element channels of utot and
// wselfallflag; selfvec (2U,).  Writes J (3, N, K, 2U) and ut (N, nc * 2U).
extern "C" int pair_u_duals(
    const double* disp, const int* jelem, const unsigned char* mask,
    const int* ielem, const double* elem, double rcutfac, double rfac0,
    double rmin0, int switchflag, int switchinnerflag, long long natoms,
    int K, const double* blob, const int* loc, const int* cw_ptr,
    const int* win_ptr, const int* win_exp, const int* zr_ptr,
    const int* zruns, int nsplit, int max_win, int max_wch, int bufd,
    int twojmax, int two_u, int nc, int wselfall, const double* selfvec,
    double* J,
    double* ut, void* stream) {
  return pair_u_duals_launch<double>(
      disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, blob, loc, cw_ptr, win_ptr, win_exp, zr_ptr,
      zruns, nsplit, max_win, max_wch, bufd, twojmax, two_u, nc, wselfall,
      selfvec, J, ut, stream);
}

// The float32 instantiation of the window shape: `pair_u_duals`' arguments
// with disp, elem, selfvec, J, ut and the plan's blob f32 (its steps 24
// bytes: 4 float coefficients, then the offsets; bufd in floats).
extern "C" int pair_u_duals_f32(
    const float* disp, const int* jelem, const unsigned char* mask,
    const int* ielem, const float* elem, double rcutfac, double rfac0,
    double rmin0, int switchflag, int switchinnerflag, long long natoms,
    int K, const float* blob, const int* loc, const int* cw_ptr,
    const int* win_ptr, const int* win_exp, const int* zr_ptr,
    const int* zruns, int nsplit, int max_win, int max_wch, int bufd,
    int twojmax, int two_u, int nc, int wselfall, const float* selfvec,
    float* J, float* ut, void* stream) {
  return pair_u_duals_launch<float>(
      disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, blob, loc, cw_ptr, win_ptr, win_exp, zr_ptr,
      zruns, nsplit, max_win, max_wch, bufd, twojmax, two_u, nc, wselfall,
      selfvec, J, ut, stream);
}

// K1's table shape: disp, jelem, mask, ielem, elem, the prologue scalars,
// natoms, K as `pair_u_duals`'; the streams of `snap_kernels.pair_u_tables
// (..., "table")` (blob, wrec (nsplit * 8 + 1,) their first records) and
// each split's column runs (zr_ptr, zruns); twojmax at most 20 (a table
// row fits 8 bits); two_u, nc, wselfall, selfvec, J, ut as `pair_u_duals`'.
extern "C" int pair_u_table(
    const double* disp, const int* jelem, const unsigned char* mask,
    const int* ielem, const double* elem, double rcutfac, double rfac0,
    double rmin0, int switchflag, int switchinnerflag, long long natoms,
    int K, const double* blob, const int* wrec, const int* zr_ptr,
    const int* zruns, int nsplit, int twojmax, int two_u, int nc,
    int wselfall, const double* selfvec, double* J, double* ut,
    void* stream) {
  const Scalars s{rcutfac, rfac0, rmin0, switchflag, switchinnerflag};
  const TablePlan pl{blob, wrec, zr_ptr,
                     reinterpret_cast<const int2*>(zruns)};
  const long long smem = pair_u_table_smem(twojmax, two_u, nc, K);
  if (nsplit < 1 || nsplit > 65535 || twojmax > 20 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = fs_allow_smem(pair_u_table_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    const dim3 grid(static_cast<unsigned>(natoms),
                    static_cast<unsigned>(nsplit));
    pair_u_table_kernel<<<grid, NW * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        disp, jelem, mask, ielem, elem, s, natoms, K, pl, twojmax, two_u, nc,
        wselfall, selfvec, J, ut);
  }
  return static_cast<int>(cudaGetLastError());
}
