// K3 dbdd: per atom, dB/dutot from the three y-layers of the z-lists, the
// bispectrum B from the first layer, and the pair jacobian
//   dBdD[a, w, k, c] = sum_u y[a, w, u] * J[c, a, k, u].
//
// Replaces fitsnap_tpu/ops/snap.py `_dbdu_ylist` and the contractions of
// `descriptors_with_jacobian` (the Bbase einsums and
// einsum("awu,caku->awkc") at ops/snap.py:956-971).
//
// Bound on the H100: bytes.  The kernel must read J (3 x K x 2U doubles per
// atom, 430 KB at K = 64, twojmax 6) once; its FP64 work is 2 flops per J
// element per descriptor column (60 per J double at W = 30), which the
// card's FP64 rate covers faster than HBM delivers J.
//
// Design: one block per atom.  The y-list (W x 2U doubles, 67 KB at
// twojmax 6) is gathered from z with y_src / y_fac into shared memory once
// and then reused for every neighbor; J is streamed through shared memory
// in tiles of KT neighbors with coalesced loads, so every J element is read
// from device memory exactly once.  Each thread computes whole dot products
// in a fixed order: deterministic.
#include "common.cuh"

namespace {

constexpr int KT = 8;  // neighbors per J tile

__global__ void dbdd_kernel(const double* __restrict__ ut,
                            const double* __restrict__ zr,
                            const double* __restrict__ zi,
                            const double* __restrict__ J,
                            const int* __restrict__ y_src,
                            const double* __restrict__ y_fac,
                            const double* __restrict__ bzero, int W, int U,
                            int nz, int K, long long natoms,
                            double* __restrict__ B,
                            double* __restrict__ dBdD) {
  extern __shared__ double smem[];
  const int two_u = 2 * U;
  double* y = smem;                  // [W][2U]
  double* jt = smem + W * two_u;     // [3][KT][2U]
  const long long a = blockIdx.x;
  const int tid = threadIdx.x;
  const double* za_r = zr + a * nz;
  const double* za_i = zi + a * nz;

  for (int idx = tid; idx < W * U; idx += blockDim.x) {
    const int w = idx / U;
    const int u = idx % U;
    double yr = 0.0, yi = 0.0;
    for (int layer = 0; layer < 3; ++layer) {
      const long long q = (static_cast<long long>(layer) * W + w) * U + u;
      const double f = y_fac[q];
      const int src = y_src[q];
      yr += f * za_r[src];
      yi += f * za_i[src];
    }
    y[w * two_u + u] = yr;
    y[w * two_u + U + u] = yi;
  }

  // B_w = Re[conj(utot) . z] over the fac-0 layer, minus bzero
  const double* ua = ut + a * two_u;
  for (int w = tid; w < W; w += blockDim.x) {
    double br = 0.0, bi = 0.0;
    for (int u = 0; u < U; ++u) {
      const double f = y_fac[w * U + u];
      const int src = y_src[w * U + u];
      br += ua[u] * (f * za_r[src]);
      bi += ua[U + u] * (f * za_i[src]);
    }
    B[a * W + w] = (br + bi) - bzero[w];
  }
  __syncthreads();

  const long long jstride = natoms * K * two_u;  // one row c of J
  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int idx = tid; idx < 3 * KT * two_u; idx += blockDim.x) {
      const int c = idx / (KT * two_u);
      const int rem = idx % (KT * two_u);
      const int k = k0 + rem / two_u;
      const int u = rem % two_u;
      jt[idx] = k < K ? J[c * jstride + (a * K + k) * two_u + u] : 0.0;
    }
    __syncthreads();
    for (int idx = tid; idx < W * KT * 3; idx += blockDim.x) {
      const int w = idx / (KT * 3);
      const int kk = (idx / 3) % KT;
      const int c = idx % 3;
      if (k0 + kk < K) {
        const double* yw = y + w * two_u;
        const double* jr = jt + (c * KT + kk) * two_u;
        double s = 0.0;
        for (int u = 0; u < two_u; ++u) s += yw[u] * jr[u];
        dBdD[((a * W + w) * K + k0 + kk) * 3 + c] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// ut (N, 2U), zr, zi (N, nz), J (3, N, K, 2U) f64; y plan y_src (3, W, U)
// i32 and y_fac (3, W, U) f64; bzero (W,) f64 (zeros when bzeroflag is 0).
// Writes B (N, W) and dBdD (N, W, K, 3).
extern "C" int dbdd(const double* ut, const double* zr, const double* zi,
                    const double* J, const int* y_src, const double* y_fac,
                    const double* bzero, long long natoms, int K, int W,
                    int U, int nz, double* B, double* dBdD, void* stream) {
  const size_t smem = sizeof(double) * (static_cast<size_t>(W) + 3 * KT) *
                      2 * U;
  const int err = fs_allow_smem(dbdd_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    dbdd_kernel<<<static_cast<unsigned>(natoms), 256, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        ut, zr, zi, J, y_src, y_fac, bzero, W, U, nz, K, natoms, B, dBdD);
  }
  return static_cast<int>(cudaGetLastError());
}
