// K3 dbdd: per atom, dB/dutot from the three y-layers of the z-lists, the
// bispectrum B from the first layer, and the pair jacobian
//   dBdD[a, w, k, c] = sum_u y[a, w, ch(a, k), u] * J[c, a, k, u],
// where ch(a, k) is the utot channel of neighbor k: 0 with one channel, the
// neighbor's element in the chemflag mode (nc > 1 channels, y resolved by
// channel).
//
// Replaces fitsnap_tpu/ops/snap.py `_dbdu_ylist` and the contractions of
// `descriptors_with_jacobian` (the Bbase einsums and
// einsum("awu,caku->awkc") at ops/snap.py:956-971); in the chemflag mode
// `_chem_b_and_dbdu` (ops/snap.py:992-1058) and the contraction
// einsum("awnu,akn,caku->awkc") at :981-982.
//
// Bound on the H100: bytes.  The kernel must read J (3 x K x 2U doubles per
// atom, 430 KB at K = 64, twojmax 6) once; its FP64 work is 2 flops per J
// element per descriptor column (60 per J double at W = 30), which the
// card's FP64 rate covers faster than HBM delivers J.
//
// Design: one block per (atom, W-tile).  A column w of block (e1, e2, e3)
// (w = block * ntriples + t; one block (0, 0, 0) with one channel) gathers
// its y rows from z with y_src / y_fac, layer l reading z channel pair
// blk_pair[block][l] into channel blk_chan[block][l].  The tile's y rows
// (WT x nc x 2U doubles) sit in shared memory beside a J tile of KT
// neighbors (3 x KT rows of 2U doubles), so a y-list larger than a block's
// 227 KB (360 KB at twojmax 8) is split over tiles of W: 3 tiles of 19 rows
// at twojmax 8, 7 of 35 rows with the two channels of InP at twojmax 6.
// The 24 threads that share a y row read the tile's 24 J rows, stored in
// their order (neighbor, direction) and padded to 2U + 1 doubles: with
// 2U = 280 an unpadded stride put the 16 rows a half-warp reads on 2 of the
// 16 double-wide bank groups (an 8-way conflict); 16 consecutive rows of an
// odd stride fall on 16 different ones.  Every tile of an
// atom streams the atom's J with coalesced loads; the tiles of one atom have
// neighbouring block indices, so they run together and the later tiles' J
// reads hit in L2 (an atom's J is 876 KB at twojmax 8, K = 64).  Each thread
// computes whole dot products in a fixed order: deterministic.
#include "common.cuh"

namespace {

constexpr int KT = 8;  // neighbors per J tile

__global__ void dbdd_kernel(const double* __restrict__ ut,
                            const double* __restrict__ zr,
                            const double* __restrict__ zi,
                            const double* __restrict__ J,
                            const int* __restrict__ jelem,
                            const int* __restrict__ y_src,
                            const double* __restrict__ y_fac,
                            const int* __restrict__ blk_chan,
                            const int* __restrict__ blk_pair,
                            const double* __restrict__ bzero, int W,
                            int ntrip, int U, int nz, int nc, int K, int WT,
                            int ntiles, double* __restrict__ B,
                            double* __restrict__ dBdD) {
  extern __shared__ double smem[];
  const int two_u = 2 * U;
  const long long a = blockIdx.x / ntiles;
  const int w0 = (blockIdx.x % ntiles) * WT;
  const int wt = min(WT, W - w0);
  const long long natoms = gridDim.x / ntiles;
  const int jrow = two_u + 1;              // padded J tile row
  double* y = smem;                        // [wt][nc][2U]
  double* jt = smem + WT * nc * two_u;     // [KT][3][2U + 1]
  const int tid = threadIdx.x;
  const long long zrow = static_cast<long long>(nc) * nc * nz;
  const double* za_r = zr + a * zrow;
  const double* za_i = zi + a * zrow;

  for (int idx = tid; idx < wt * nc * U; idx += blockDim.x) {
    const int wl = idx / (nc * U);
    const int ch = (idx / U) % nc;
    const int u = idx % U;
    const int w = w0 + wl;
    const int blk = w / ntrip;
    const int t = w % ntrip;
    double yr = 0.0, yi = 0.0;
    for (int layer = 0; layer < 3; ++layer) {
      if (blk_chan[blk * 3 + layer] != ch) continue;
      const int q = (layer * ntrip + t) * U + u;
      const double f = y_fac[q];
      const long long src =
          static_cast<long long>(blk_pair[blk * 3 + layer]) * nz + y_src[q];
      yr += f * za_r[src];
      yi += f * za_i[src];
    }
    double* yw = y + (wl * nc + ch) * two_u;
    yw[u] = yr;
    yw[U + u] = yi;
  }

  // B_w = Re[conj(utot of channel blk_chan[block][0]) . z] over the fac-0
  // layer, minus bzero
  for (int wl = tid; wl < wt; wl += blockDim.x) {
    const int w = w0 + wl;
    const int blk = w / ntrip;
    const int t = w % ntrip;
    const double* ua = ut + (a * nc + blk_chan[blk * 3]) * two_u;
    const long long zoff = static_cast<long long>(blk_pair[blk * 3]) * nz;
    double br = 0.0, bi = 0.0;
    for (int u = 0; u < U; ++u) {
      const double f = y_fac[t * U + u];
      const long long src = zoff + y_src[t * U + u];
      br += ua[u] * (f * za_r[src]);
      bi += ua[U + u] * (f * za_i[src]);
    }
    B[a * W + w] = (br + bi) - bzero[w];
  }
  __syncthreads();

  const long long jstride = natoms * K * two_u;  // one row c of J
  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int idx = tid; idx < 3 * KT * two_u; idx += blockDim.x) {
      const int row = idx / two_u;             // kk * 3 + c
      const int u = idx % two_u;
      const int k = k0 + row / 3;
      jt[row * jrow + u] =
          k < K ? J[(row % 3) * jstride + (a * K + k) * two_u + u] : 0.0;
    }
    __syncthreads();
    for (int idx = tid; idx < wt * KT * 3; idx += blockDim.x) {
      const int wl = idx / (KT * 3);
      const int kk = (idx / 3) % KT;
      const int c = idx % 3;
      const int k = k0 + kk;
      if (k < K) {
        const int ch = nc > 1 ? jelem[a * K + k] : 0;
        const double* yw = y + (wl * nc + ch) * two_u;
        const double* jr = jt + (kk * 3 + c) * jrow;
        double s = 0.0;
        for (int u = 0; u < two_u; ++u) s += yw[u] * jr[u];
        dBdD[((a * W + w0 + wl) * K + k) * 3 + c] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ut (N, nc * 2U), zr, zi (N, nc * nc, nz), J (3, N, K, 2U) f64; jelem
// (N, K) i32, read only when nc > 1; y plan y_src (3, ntrip, U) i32 and
// y_fac (3, ntrip, U) f64; blk_chan, blk_pair (nc^3, 3) i32; bzero (W,) f64
// (zeros when bzeroflag is 0), W = nc^3 * ntrip.  WT rows of W per block.
// Writes B (N, W) and dBdD (N, W, K, 3).
extern "C" int dbdd(const double* ut, const double* zr, const double* zi,
                    const double* J, const int* jelem, const int* y_src,
                    const double* y_fac, const int* blk_chan,
                    const int* blk_pair, const double* bzero,
                    long long natoms, int K, int ntrip, int U, int nz, int nc,
                    int WT, double* B, double* dBdD, void* stream) {
  const int W = nc * nc * nc * ntrip;
  const int ntiles = (W + WT - 1) / WT;
  const size_t smem = sizeof(double) * (static_cast<size_t>(WT) * nc * 2 * U
                                        + 3 * KT * (2 * U + 1));
  const int err = fs_allow_smem(dbdd_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    dbdd_kernel<<<static_cast<unsigned>(natoms * ntiles), 256, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        ut, zr, zi, J, jelem, y_src, y_fac, blk_chan, blk_pair, bzero, W,
        ntrip, U, nz, nc, K, WT, ntiles, B, dBdD);
  }
  return static_cast<int>(cudaGetLastError());
}
