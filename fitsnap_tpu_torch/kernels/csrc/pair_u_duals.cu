// K1 pair_u_duals: the weighted Wigner-U expansion of every neighbor pair,
// its three displacement tangents, and the neighbor sum utot.  In the
// chemflag mode (nc > 1 element channels) each neighbor is summed into the
// channel of its element, and the self term goes into every channel under
// wselfallflag, else into the atom's own (fitsnap_tpu/ops/snap.py:769-787).
//
// Replaces fitsnap_tpu/ops/snap.py `_ck_prologue` + `_pair_wu_duals` +
// `_utot_from_wu` (the TPU form: jax.jvp of the prologue, an unrolled
// monomial product chain, and a dense (n_mono, 2U) change-of-basis GEMM).
//
// Bound on the H100: bytes.  Per pair the kernel writes 4 x 2U doubles
// (wu and the three rows of J, 8.96 KB at twojmax 6) against about 20
// kflop of FP64 work, far below the card's flop/byte balance.
//
// Design: one block per atom, one thread per U column.  The block walks its
// neighbors in tiles of TILE pairs.  For a tile, TILE threads evaluate the
// Cayley-Klein prologue with forward-mode dual numbers (value + 3 tangents)
// into shared memory; the block then builds the monomial chain of
// ops/mono.py level by level (one degree at a time, parents always of lower
// degree) for the 4 streams in shared memory, and finally each thread applies
// its column of the change of basis L.  L is 99% zeros (1835 nonzeros of
// 210 x 280 at twojmax 6), so it is read as a column-CSR table through the
// read-only cache instead of as a dense 470 KB matrix.  Monomials never reach
// device memory; utot is summed in registers in neighbor order (one
// register per channel: the kernel is compiled for 1 to MAX_CHEM channels),
// so it is deterministic.  A block holds at most MAX_THREADS threads, one
// per U column (2U <= 640: twojmax <= 8), which keeps the kernel within
// the 96 registers a thread may have at that block size.
#include <math.h>

#include "common.cuh"
#include "prologue.cuh"

namespace {

constexpr int TILE = 4;           // neighbor pairs per block iteration
constexpr int MAX_CHEM = 4;       // utot channels of the chemflag mode
constexpr int MAX_THREADS = 640;  // threads (U columns) of a block

template <int NC>
__global__ void __launch_bounds__(MAX_THREADS) pair_u_duals_kernel(
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, long long natoms, int K,
    const int* __restrict__ parent, const int* __restrict__ var,
    const int* __restrict__ levels, int nlevels, int n_mono,
    const int* __restrict__ l_ptr, const int* __restrict__ l_row,
    const double* __restrict__ l_val, int two_u, int wselfall,
    const double* __restrict__ selfvec, double* __restrict__ wu,
    double* __restrict__ J, double* __restrict__ ut) {
  extern __shared__ double mono[];        // [TILE][4][n_mono]
  __shared__ double sv[TILE][4][4];       // (ar, ai, br, bi) x (value, tangents)
  __shared__ double sw[TILE][4];          // w x (value, tangents)
  __shared__ int sch[TILE];               // utot channel of each pair
  const long long a = blockIdx.x;
  const int tid = threadIdx.x;
  const int ie = ielem[a];
  const long long stream_stride = natoms * K * two_u;  // one row of J
  double acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0;

  for (int k0 = 0; k0 < K; k0 += TILE) {
    if (tid < TILE) {
      const int k = k0 + tid;
      Dual out[5];
      if (k < K) {
        const long long pk = a * K + k;
        prologue(disp[pk * 3], disp[pk * 3 + 1], disp[pk * 3 + 2],
                 mask[pk] != 0, ie, jelem[pk], elem, s, out);
        sch[tid] = NC > 1 ? jelem[pk] : 0;
      } else {
        prologue(1.0, 0.0, 0.0, false, ie, 0, elem, s, out);
        sch[tid] = 0;
      }
      for (int v = 0; v < 4; ++v) {
        sv[tid][v][0] = out[v].v;
        for (int c = 0; c < 3; ++c) sv[tid][v][1 + c] = out[v].d[c];
      }
      sw[tid][0] = out[4].v;
      for (int c = 0; c < 3; ++c) sw[tid][1 + c] = out[4].d[c];
      double* m = mono + tid * 4 * n_mono;
      m[0] = 1.0;
      m[n_mono] = m[2 * n_mono] = m[3 * n_mono] = 0.0;
    }
    __syncthreads();

    // monomial chain, one degree level at a time (levels[l]..levels[l+1])
    for (int l = 1; l < nlevels; ++l) {
      const int m0 = levels[l];
      const int nl = levels[l + 1] - m0;
      for (int idx = tid; idx < TILE * nl; idx += blockDim.x) {
        const int p = idx / nl;
        const int mi = m0 + idx % nl;
        const int pa = parent[mi];
        const int vi = var[mi];
        double* m = mono + p * 4 * n_mono;
        const double xv = sv[p][vi][0];
        const double mp = m[pa];
        for (int c = 0; c < 3; ++c)
          m[(1 + c) * n_mono + mi] =
              m[(1 + c) * n_mono + pa] * xv + mp * sv[p][vi][1 + c];
        m[mi] = mp * xv;
      }
      __syncthreads();
    }

    // change of basis: thread tid owns U column tid
    if (tid < two_u) {
      const int q0 = l_ptr[tid];
      const int q1 = l_ptr[tid + 1];
      for (int p = 0; p < TILE && k0 + p < K; ++p) {
        const double* m = mono + p * 4 * n_mono;
        double u = 0.0, t0 = 0.0, t1 = 0.0, t2 = 0.0;
        for (int q = q0; q < q1; ++q) {
          const int row = l_row[q];
          const double c = l_val[q];
          u += c * m[row];
          t0 += c * m[n_mono + row];
          t1 += c * m[2 * n_mono + row];
          t2 += c * m[3 * n_mono + row];
        }
        const double wp = sw[p][0];
        const long long out = (a * K + k0 + p) * two_u + tid;
        const double wuv = wp * u;
        wu[out] = wuv;
        J[out] = wp * t0 + sw[p][1] * u;
        J[stream_stride + out] = wp * t1 + sw[p][2] * u;
        J[2 * stream_stride + out] = wp * t2 + sw[p][3] * u;
        const int ch = sch[p];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c == ch) acc[c] += wuv;
        }
      }
    }
    __syncthreads();
  }
  if (tid < two_u) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool self = NC == 1 || wselfall || c == ie;
      ut[(a * NC + c) * two_u + tid] = acc[c] + (self ? selfvec[tid] : 0.0);
    }
  }
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) u8, ielem (N,) i32,
// elem (nelem, 4) f64; monomial plan parent/var (n_mono,) i32 and levels
// (nlevels + 1,) i32; L as column CSR l_ptr (2U + 1,), l_row, l_val; nc
// element channels of utot (1, or nelements under chemflag, at most
// MAX_CHEM) and wselfallflag; selfvec (2U,), 2U <= MAX_THREADS.  Writes wu
// (N, K, 2U), J (3, N, K, 2U), ut (N, nc * 2U).
extern "C" int pair_u_duals(
    const double* disp, const int* jelem, const unsigned char* mask,
    const int* ielem, const double* elem, double rcutfac, double rfac0,
    double rmin0, int switchflag, int switchinnerflag, long long natoms,
    int K, const int* parent, const int* var, const int* levels, int nlevels,
    int n_mono, const int* l_ptr, const int* l_row, const double* l_val,
    int two_u, int nc, int wselfall, const double* selfvec, double* wu,
    double* J, double* ut, void* stream) {
  const Scalars s{rcutfac, rfac0, rmin0, switchflag, switchinnerflag};
  const int threads = ((two_u + 31) / 32) * 32;
  if (threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nc == 1   ? pair_u_duals_kernel<1>
                : nc == 2 ? pair_u_duals_kernel<2>
                : nc == 3 ? pair_u_duals_kernel<3>
                : nc == 4 ? pair_u_duals_kernel<MAX_CHEM>
                          : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(double) * TILE * 4 * n_mono;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        disp, jelem, mask, ielem, elem, s, natoms, K, parent, var, levels,
        nlevels, n_mono, l_ptr, l_row, l_val, two_u, wselfall, selfvec, wu,
        J, ut);
  }
  return static_cast<int>(cudaGetLastError());
}
