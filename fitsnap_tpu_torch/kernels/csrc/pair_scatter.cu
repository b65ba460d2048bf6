// K4 pair_scatter_rows: force and virial rows from a per-pair gradient.
//
// From g (C, A, X, K, 3), the gradient of X per-atom quantities with
// respect to each pair displacement D[i, k] = x_{jidx[i,k]} - x_i, it forms
// per destination atom n and source type t
//   force[n, d, t, x] = sum_k g[n, x, k, d] [type n == t]
//                       - sum_{(i,k): jidx[i,k] = n, type i == t} g[i, x, k, d]
// and per config the six virial components
//   virial[v, t, x] = -sum_{(i,k): type i == t} D[i,k,pa_v] * g[i,x,k,pb_v]
// with (pa, pb) = xx, yy, zz, yz, xz, xy.
//
// Replaces the one-hot (A, K, A) matmuls of fitsnap_tpu/calculators/snap.py
// `_rows_fn.one_config` (calculators/snap.py:326-343, the same code as
// parallel/fit.py:268-286 and :597-605) and of ops/refpot.py:295-302
// (where X = 1 and one type).
//
// Bound on the H100: bytes (g is read about twice, once per kernel; a few
// flops per element).
//
// Design: deterministic gathers instead of atomics.  The host builds a
// reverse neighbor table rev (C, A, R): for each destination atom the flat
// slots i*K + k that point at it, increasing, padded with -1.  An atom that
// is its own neighbor through periodic images (small cells) appears once
// per such slot, so repeated indices accumulate.  Force: one block per
// destination atom, one thread per (x, d).  Virial: one block per
// (config, type, x), a strided loop over the pairs and a fixed-order
// shared-memory tree reduction.
#include "common.cuh"

namespace {

constexpr int VIRIAL_THREADS = 256;

__global__ void scatter_force_kernel(const double* __restrict__ g,
                                     const int* __restrict__ rev,
                                     const int* __restrict__ types, int A,
                                     int X, int K, int R, int T,
                                     double* __restrict__ force) {
  const long long n = blockIdx.x;            // atom c * A + local index
  const long long first = (n / A) * A;       // first atom of its config
  const int tn = types[n];
  for (int idx = threadIdx.x; idx < X * 3; idx += blockDim.x) {
    const int x = idx / 3;
    const int d = idx % 3;
    for (int t = 0; t < T; ++t) {
      double scat = 0.0;
      for (int r = 0; r < R; ++r) {
        const int slot = rev[n * R + r];
        if (slot < 0) break;
        const long long i = first + slot / K;
        const int k = slot % K;
        if (types[i] == t) scat += g[((i * X + x) * K + k) * 3 + d];
      }
      double rows = 0.0;
      if (tn == t) {
        for (int k = 0; k < K; ++k) rows += g[((n * X + x) * K + k) * 3 + d];
      }
      force[((n * 3 + d) * T + t) * X + x] = rows - scat;
    }
  }
}

__global__ void scatter_virial_kernel(const double* __restrict__ g,
                                      const double* __restrict__ disp,
                                      const unsigned char* __restrict__ vmask,
                                      const int* __restrict__ types, int A,
                                      int X, int K, int T,
                                      double* __restrict__ virial) {
  __shared__ double red[6][VIRIAL_THREADS];
  const int pa[6] = {0, 1, 2, 1, 0, 0};
  const int pb[6] = {0, 1, 2, 2, 2, 1};
  const int x = blockIdx.x % X;
  const int t = (blockIdx.x / X) % T;
  const long long c = blockIdx.x / (static_cast<long long>(X) * T);
  const int tid = threadIdx.x;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int idx = tid; idx < A * K; idx += VIRIAL_THREADS) {
    const long long i = c * A + idx / K;
    const int k = idx % K;
    if (types[i] != t || !vmask[i * K + k]) continue;
    const double* dv = disp + (i * K + k) * 3;
    const double* gv = g + ((i * X + x) * K + k) * 3;
    for (int v = 0; v < 6; ++v) acc[v] += dv[pa[v]] * gv[pb[v]];
  }
  for (int v = 0; v < 6; ++v) red[v][tid] = acc[v];
  __syncthreads();
  for (int half = VIRIAL_THREADS / 2; half > 0; half /= 2) {
    if (tid < half) {
      for (int v = 0; v < 6; ++v) red[v][tid] += red[v][tid + half];
    }
    __syncthreads();
  }
  if (tid < 6) virial[((c * 6 + tid) * T + t) * X + x] = -red[tid][0];
}

}  // namespace

// g (C, A, X, K, 3) f64, disp (C, A, K, 3) f64, vmask (C, A, K) u8,
// rev (C, A, R) i32, types (C, A) i32.  Writes force (C, A, 3, T, X) and
// virial (C, 6, T, X).
extern "C" int pair_scatter_rows(const double* g, const double* disp,
                                 const unsigned char* vmask, const int* rev,
                                 const int* types, int C, int A, int X,
                                 int K, int R, int T, double* force,
                                 double* virial, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long natoms = static_cast<long long>(C) * A;
  if (natoms > 0) {
    scatter_force_kernel<<<static_cast<unsigned>(natoms), 128, 0, st>>>(
        g, rev, types, A, X, K, R, T, force);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    scatter_virial_kernel<<<static_cast<unsigned>(C) * X * T,
                            VIRIAL_THREADS, 0, st>>>(g, disp, vmask, types,
                                                     A, X, K, T, virial);
  }
  return static_cast<int>(cudaGetLastError());
}
