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
// the recursion shape (`pair_u_recur`, below) runs instead: the pair's U
// by LAMMPS's two-term recursion, level by level, with no change of basis
// at all.  Any twojmax up to 16 and the chemflag modes run in one shape or
// the other.  No atomics: the output repeats bit for bit.
// Working types: the window shape also has a float32 instantiation
// (`pair_u_duals_f32`, the streamed linear SNAP fit at float32), whose
// plan holds float32 coefficients, each rounded once from the float64
// change of basis (a step is then 24 bytes: 4 floats, the offsets), and
// which computes the prologue, the monomials, W, J and utot in float32.
// The recursion shape runs at float64 only.
#include <math.h>

#include "common.cuh"
#include "prologue.cuh"

namespace {

constexpr int NW = 8;         // warps of a block
constexpr int TP = 32;        // pairs of a tile, one a lane
constexpr int CW = 4;         // most columns of a chunk
constexpr int NPRO = 20;      // prologue values a pair (see below)

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

// The recursion shape.  U^j from U^{j-1} by the two-term recursion of
// LAMMPS (fitsnap_tpu/ops/snap.py `compute_ulist_duals`):
//   U^j[mb, ma] = ca conj(a) U^{j-1}[mb, ma] - cb conj(b) U^{j-1}[mb, ma-1],
//   ca = sqrt((j - ma) / (j - mb)), cb = sqrt(ma / (j - mb)),
// for the half rows 2 mb <= j, the rest by symmetry,
//   U^j[mb, ma] = (-1)^(ma + mb) conj(U^j[j - mb, j - ma]);
// a pair's tangent along one displacement axis rides the same recursion by
// the product rule.
//   * A block is (atom, split); a split is a range of levels [j0, j1) (the
//     host's cut of the levels into equal shares of J's columns): it runs
//     the recursion from level 0 and writes the columns of its own levels
//     only, so that the splits of an atom share nothing.
//   * A warp takes one live pair (slot order, RW pairs a round), a lane one
//     column ma; the lane keeps its column of level j - 1's half rows in
//     registers (P[mb], the value and one tangent), the neighbour column ma
//     - 1 comes by __shfl_up_sync, and the row j / 2 of an even level, which
//     reads level j - 1's row past its half, by a shuffle from the mirrored
//     lane.  The three tangents run as three passes of the recursion (one
//     direction each: half the registers of carrying all three at once),
//     each storing its direction's J as each level is done, a lane a column,
//     the rows past the half by shuffles from the mirrored lane.
//   * utot: in the first pass, each warp stages its pair's weighted half
//     rows of the level, and after a barrier the block adds the RW warps'
//     values in warp order (the live slots' order) into its copy of the
//     atom's utot (set to the self term first; a channel each in the
//     chemflag mode); the rows past the half are completed by symmetry when
//     utot is stored.
//   * Masked slots get J = 0 over the split's columns.
// Bound on the H100: bytes (J's stores), against about 10^5 flops a pair at
// twojmax 14.  No atomics: the output repeats bit for bit, whatever the
// split count.
constexpr int RW = 4;         // warps of a recursion block, a pair each

__host__ __device__ __forceinline__ int level_offset(int j) {
  return j * (j + 1) * (2 * j + 1) / 6;
}

// Doubles of a warp's staged level (real parts, then imaginary ones): the
// largest level's half rows.
__host__ __device__ __forceinline__ int recur_stage(int twojmax) {
  return 2 * (twojmax / 2 + 1) * (twojmax + 1);
}

template <int MB>
__global__ void __launch_bounds__(RW * 32, 3) pair_u_recur_kernel(
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, long long natoms, int K,
    const double* __restrict__ rt_g, const int* __restrict__ lv, int twojmax,
    int two_u, int nc, int wselfall, const double* __restrict__ selfvec,
    double* __restrict__ J, double* __restrict__ ut) {
  extern __shared__ __align__(16) double smem[];
  const int tj = twojmax, U = two_u / 2, hs = recur_stage(tj);
  double* us = smem;                          // [nc][two_u] utot
  double* stg = us + static_cast<long long>(nc) * two_u;  // [2][RW][hs]
  double* rt = stg + 2 * RW * hs;             // [(tj + 1)^2] sqrt(p / q)
  int* slots = reinterpret_cast<int*>(rt + (tj + 1) * (tj + 1));  // [K]
  int* wch = slots + K;                       // [RW] channel of a warp's pair
  int* cnt = wch + RW;                        // live slots

  const long long a = blockIdx.x;
  const int j0 = lv[blockIdx.y], j1 = lv[blockIdx.y + 1];
  const int c0 = level_offset(j0), c1 = level_offset(j1);
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
  for (int e = 0; e < nc; ++e) {
    const bool self = nc == 1 || wselfall || e == ie;
    for (int u = c0 + threadIdx.x; u < c1; u += blockDim.x) {
      us[e * two_u + u] = self ? selfvec[u] : 0.0;
      us[e * two_u + U + u] = self ? selfvec[U + u] : 0.0;
    }
  }
  for (int i = threadIdx.x; i < (tj + 1) * (tj + 1); i += blockDim.x)
    rt[i] = rt_g[i];
  __syncthreads();
  const int nlive = cnt[0];

  // masked slots: zero rows over the split's columns
  for (int mi = warp; mi < K - nlive; mi += RW) {
    const long long base = a * K + slots[K - 1 - mi];
    for (int c = 0; c < 3; ++c) {
      double* row = J + (c * rows + base) * two_u;
      for (int u = c0 + lane; u < c1; u += 32) row[u] = row[U + u] = 0.0;
    }
  }

  for (int r0 = 0; r0 < nlive; r0 += RW) {
    __syncthreads();                    // the last round's sums are done
    const int pi = r0 + warp;
    const bool has = pi < nlive;
    Dual pro[5];
    long long kk = 0;
    int ch = -1;
    if (has) {
      kk = a * K + slots[pi];
      const int je = jelem[kk];
      ch = nc == 1 ? 0 : (je >= 0 && je < nc ? je : -1);
      prologue(disp[kk * 3], disp[kk * 3 + 1], disp[kk * 3 + 2], true, ie, je,
               elem, s, pro);
    } else {
      prologue(1.0, 0.0, 0.0, false, ie, 0, elem, s, pro);
    }
    if (lane == 0) wch[warp] = ch;
    for (int c = 0; c < 3; ++c) {
      const double ar = pro[0].v, ai = pro[1].v, br = pro[2].v, bi = pro[3].v;
      const double dar = pro[0].d[c], dai = pro[1].d[c];
      const double dbr = pro[2].d[c], dbi = pro[3].d[c];
      const double w = pro[4].v, dw = pro[4].d[c];
      double* Jc = J + (c * rows + kk) * two_u;
      // the lane's column of the level's half rows: value and tangent, real
      // and imaginary
      double P[MB][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int e = 0; e < 4; ++e) P[mb][e] = 0.0;
      if (lane == 0) P[0][0] = 1.0;
      for (int j = 0; j < j1; ++j) {
        if (j > 0) {
          // rows from the last down, so that a row's mirror source (the row
          // below it) is still level j - 1's
#pragma unroll
          for (int mb = MB - 1; mb >= 0; --mb) {
            if (2 * mb > j) continue;
            double x[4], y[4];
            if (mb > 0 && 2 * mb == j) {
              // row j / 2 of level j - 1: (-1)^(ma + mb) conj of its row
              // j / 2 - 1 at column j - 1 - ma, and at j - ma for ma - 1
              const double* src = P[mb > 0 ? mb - 1 : 0];
              const int lx = j - 1 - lane, ly = j - lane;
              double vx[4], vy[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                vx[e] = __shfl_sync(0xffffffffu, src[e], lx & 31);
                vy[e] = __shfl_sync(0xffffffffu, src[e], ly & 31);
              }
              const double sx = (lane + mb) & 1 ? -1.0 : 1.0;
              const bool okx = lx >= 0, oky = lane >= 1 && ly >= 0;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const double f = e & 1 ? -sx : sx;   // conj: imaginary -
                x[e] = okx ? f * vx[e] : 0.0;
                y[e] = oky ? -f * vy[e] : 0.0;     // ma - 1: the other sign
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                x[e] = P[mb][e];
                const double v = __shfl_up_sync(0xffffffffu, P[mb][e], 1);
                y[e] = lane >= 1 ? v : 0.0;
              }
            }
            if (lane <= j) {
              const double ca = rt[(j - lane) * (tj + 1) + j - mb];
              const double cb = rt[lane * (tj + 1) + j - mb];
              // conj(a) x and conj(b) y, with their tangents
              const double tar = ar * x[0] + ai * x[1];
              const double tai = ar * x[1] - ai * x[0];
              const double dtar = dar * x[0] + ar * x[2] + dai * x[1] +
                                  ai * x[3];
              const double dtai = dar * x[1] + ar * x[3] - dai * x[0] -
                                  ai * x[2];
              const double tbr = br * y[0] + bi * y[1];
              const double tbi = br * y[1] - bi * y[0];
              const double dtbr = dbr * y[0] + br * y[2] + dbi * y[1] +
                                  bi * y[3];
              const double dtbi = dbr * y[1] + br * y[3] - dbi * y[0] -
                                  bi * y[2];
              P[mb][0] = ca * tar - cb * tbr;
              P[mb][1] = ca * tai - cb * tbi;
              P[mb][2] = ca * dtar - cb * dtbr;
              P[mb][3] = ca * dtai - cb * dtbi;
            }
          }
        }
        if (j < j0) continue;
        // level j's columns of J: the half rows from the lane's registers,
        // row j - r from row r at the mirrored lane j - ma
        const int off = level_offset(j), n1 = j + 1;
        const bool mine = has && lane <= j;
        double* sb = stg + ((j & 1) * RW + warp) * hs;
#pragma unroll
        for (int r = 0; r < MB; ++r) {
          if (2 * r > j) continue;
          const int col = off + r * n1 + lane;
          if (mine) {
            Jc[col] = w * P[r][2] + dw * P[r][0];
            Jc[U + col] = w * P[r][3] + dw * P[r][1];
          }
          if (c == 0 && lane <= j) {
            sb[r * n1 + lane] = w * P[r][0];
            sb[hs / 2 + r * n1 + lane] = w * P[r][1];
          }
          if (2 * r < j) {
            double v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = __shfl_sync(0xffffffffu, P[r][e], (j - lane) & 31);
            if (mine) {
              const double sg = (lane + j - r) & 1 ? -1.0 : 1.0;
              const int mc = off + (j - r) * n1 + lane;
              Jc[mc] = w * (sg * v[2]) + dw * (sg * v[0]);
              Jc[U + mc] = w * (-sg * v[3]) + dw * (-sg * v[1]);
            }
          }
        }
        if (c == 0) {
          // the block adds the warps' pairs in warp (slot) order
          __syncthreads();
          const int nent = (j / 2 + 1) * n1;
          const double* sl = stg + (j & 1) * RW * hs;
          for (int e = threadIdx.x; e < 2 * nent; e += blockDim.x) {
            const int part = e >= nent;
            const int idx = e - part * nent;
            const int col = part * U + off + idx;
            for (int q = 0; q < RW; ++q) {
              const int e2 = wch[q];
              if (e2 >= 0)
                us[e2 * two_u + col] += sl[q * hs + part * hs / 2 + idx];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the split's columns of utot, the rows past the half by symmetry
  for (int e = 0; e < nc; ++e) {
    const double* ue = us + e * two_u;
    double* uo = ut + (a * nc + e) * two_u;
    for (int u = c0 + threadIdx.x; u < c1; u += blockDim.x) {
      int j = j0;
      while (level_offset(j + 1) <= u) ++j;
      const int n1 = j + 1, idx = u - level_offset(j);
      const int mb = idx / n1, ma = idx % n1;
      if (2 * mb <= j) {
        uo[u] = ue[u];
        uo[U + u] = ue[U + u];
      } else {
        const int src = level_offset(j) + (j - mb) * n1 + j - ma;
        const double sg = (ma + mb) & 1 ? -1.0 : 1.0;
        uo[u] = sg * ue[src];
        uo[U + u] = -sg * ue[U + src];
      }
    }
  }
}

// Shared memory of one block of the recursion shape: utot, the warps'
// staged levels (two buffers), the coefficient table, the slot lists
// (`snap_kernels.pair_u_recur_smem`).
long long pair_u_recur_smem(int twojmax, int two_u, int nc, int K) {
  return static_cast<long long>(sizeof(double)) *
             (static_cast<long long>(nc) * two_u +
              2LL * RW * recur_stage(twojmax) +
              (twojmax + 1) * (twojmax + 1)) +
         static_cast<long long>(sizeof(int)) * (K + RW + 1);
}

template <int MB>
int pair_u_recur_launch(const double* disp, const int* jelem,
                        const unsigned char* mask, const int* ielem,
                        const double* elem, const Scalars& s,
                        long long natoms, int K, const double* rt,
                        const int* lv, int nsplit, int twojmax, int two_u,
                        int nc, int wselfall, const double* selfvec,
                        double* J, double* ut, long long smem,
                        cudaStream_t stream) {
  const int err = fs_allow_smem(pair_u_recur_kernel<MB>, smem);
  if (err) return err;
  if (natoms > 0) {
    const dim3 grid(static_cast<unsigned>(natoms),
                    static_cast<unsigned>(nsplit));
    pair_u_recur_kernel<MB><<<grid, RW * 32, smem, stream>>>(
        disp, jelem, mask, ielem, elem, s, natoms, K, rt, lv, twojmax, two_u,
        nc, wselfall, selfvec, J, ut);
  }
  return static_cast<int>(cudaGetLastError());
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

// K1's recursion shape: disp, jelem, mask, ielem, elem, the prologue
// scalars, natoms, K as `pair_u_duals`'; rt ((twojmax + 1)^2,) f64 with
// sqrt(p / q) at p (twojmax + 1) + q (0 where p = 0 or q = 0); lv (nsplit +
// 1,) i32 each split's first level (0, ..., twojmax + 1); twojmax at most
// 16; two_u, nc, wselfall, selfvec, J, ut as `pair_u_duals`'
// (`snap_kernels.pair_u_recur_plan`).
extern "C" int pair_u_recur(
    const double* disp, const int* jelem, const unsigned char* mask,
    const int* ielem, const double* elem, double rcutfac, double rfac0,
    double rmin0, int switchflag, int switchinnerflag, long long natoms,
    int K, const double* rt, const int* lv, int nsplit, int twojmax,
    int two_u, int nc, int wselfall, const double* selfvec, double* J,
    double* ut, void* stream) {
  const Scalars s{rcutfac, rfac0, rmin0, switchflag, switchinnerflag};
  const long long smem = pair_u_recur_smem(twojmax, two_u, nc, K);
  if (nsplit < 1 || nsplit > twojmax + 1 || twojmax < 0 || twojmax > 16 ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the fewest registers of half rows that hold twojmax / 2 + 1
  const int mb = twojmax / 2 + 1;
#define FS_RECUR(M)                                                          \
  return pair_u_recur_launch<M>(disp, jelem, mask, ielem, elem, s, natoms,  \
                                K, rt, lv, nsplit, twojmax, two_u, nc,      \
                                wselfall, selfvec, J, ut, smem, st)
  if (mb <= 4) FS_RECUR(4);
  if (mb <= 6) FS_RECUR(6);
  if (mb <= 8) FS_RECUR(8);
  FS_RECUR(9);
#undef FS_RECUR
}
