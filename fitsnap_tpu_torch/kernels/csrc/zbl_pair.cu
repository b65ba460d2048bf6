// K5 zbl_pair_grad: the ZBL reference pair energy and its gradient with
// respect to each pair displacement, in closed form.
//
// Per directed pair slot (c, i, k) with mask set, r = |D[i, k]| and the
// LAMMPS `pair_style zbl` energy of `zbl_pair_energy`
//   e(r)  = pre / r * phi(r / a) + sw5 + [r > r_in] t^3 (sw3 + sw4 t)
//   e'(r) = pre * (-phi / r^2 + phi' / r) + [r > r_in] (3 sw3 t^2 + 4 sw4 t^3)
// with t = r - r_in, phi(x) = sum_m c_m exp(-d_m x), phi' = dphi/dr, and
// e = e' = 0 at r >= r_out or for a type pair without coefficients.  Outputs
// g[c, i, k] = 0.5 e'(r) D / r (zero for masked slots), which is what the
// vjp of 0.5 sum e gives, and energy[c] = 0.5 sum e, summed per atom and
// then per config in a fixed order.  Forces and virial are formed from g by
// K4 (pair_scatter_rows) with a width of 1.
//
// Replaces fitsnap_tpu/ops/refpot.py `reference_eav` (its `jax.vjp` of the
// pair energy) and `zbl_pair_energy`.
//
// Bound on the H100: bytes.  Each pair slot reads 24 B of displacement, 5 B
// of index and mask, and writes 24 B of gradient; the four exponentials
// per pair are far below the card's FP64 rate for that traffic.
//
// Design: one block per atom, one thread per neighbor slot (strided), the
// per-type-pair table (pre, a, sw3, sw4, sw5, active) read through the
// cache.  The atom's energy is a shared-memory tree sum; a second kernel
// sums the atoms of each config in order.  No atomics: deterministic.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
__constant__ double kC[4] = {0.02817, 0.28022, 0.50986, 0.18175};
__constant__ double kD[4] = {0.20162, 0.40290, 0.94229, 3.19980};

__global__ void zbl_pair_kernel(const double* __restrict__ disp,
                                const int* __restrict__ jidx,
                                const unsigned char* __restrict__ mask,
                                const int* __restrict__ types,
                                const double* __restrict__ table, int A,
                                int K, int T, double cut_inner,
                                double cut_outer, double* __restrict__ g,
                                double* __restrict__ e_atom) {
  __shared__ double red[THREADS];
  const long long n = blockIdx.x;            // atom c * A + local index
  const long long first = (n / A) * A;       // first atom of its config
  const int ti = types[n];
  const int tid = threadIdx.x;
  double esum = 0.0;
  for (int k = tid; k < K; k += THREADS) {
    const long long s = n * K + k;
    double f = 0.0;
    double dx = 0.0, dy = 0.0, dz = 0.0;
    if (mask[s]) {
      dx = disp[s * 3];
      dy = disp[s * 3 + 1];
      dz = disp[s * 3 + 2];
      const double r = sqrt(dx * dx + dy * dy + dz * dz);
      const double* p = table + (ti * T + types[first + jidx[s]]) * 6;
      if (p[5] != 0.0 && r < cut_outer) {
        const double pre = p[0];
        const double a = p[1];
        const double x = r / a;
        double phi = 0.0, dphi = 0.0;
        for (int m = 0; m < 4; ++m) {
          const double ex = exp(-kD[m] * x);
          phi += kC[m] * ex;
          dphi -= kC[m] * kD[m] * ex;
        }
        dphi /= a;
        double e = pre / r * phi;
        e += p[4];
        double de = pre * (-phi / (r * r) + dphi / r);
        if (r > cut_inner) {
          const double t = r - cut_inner;
          e += t * t * t * (p[2] + p[3] * t);
          de += t * t * (3.0 * p[2] + 4.0 * p[3] * t);
        }
        esum += e;
        f = 0.5 * de / r;
      }
    }
    g[s * 3] = f * dx;
    g[s * 3 + 1] = f * dy;
    g[s * 3 + 2] = f * dz;
  }
  red[tid] = esum;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) e_atom[n] = red[0];
}

__global__ void config_sum_kernel(const double* __restrict__ e_atom, int A,
                                  double* __restrict__ energy) {
  __shared__ double red[THREADS];
  const long long c = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < A; i += THREADS) s += e_atom[c * A + i];
  red[tid] = s;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) energy[c] = 0.5 * red[0];
}

}  // namespace

// disp (C, A, K, 3) f64, jidx (C, A, K) i32, mask (C, A, K) u8, types
// (C, A) i32, table (T, T, 6) f64 rows (pre, a, sw3, sw4, sw5, active);
// e_atom (C, A) f64 scratch.  Writes g (C, A, K, 3) and energy (C,).
extern "C" int zbl_pair_grad(const double* disp, const int* jidx,
                             const unsigned char* mask, const int* types,
                             const double* table, int C, int A, int K, int T,
                             double cut_inner, double cut_outer,
                             double* e_atom, double* g, double* energy,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long natoms = static_cast<long long>(C) * A;
  if (natoms > 0) {
    zbl_pair_kernel<<<static_cast<unsigned>(natoms), THREADS, 0, st>>>(
        disp, jidx, mask, types, table, A, K, T, cut_inner, cut_outer, g,
        e_atom);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    config_sum_kernel<<<static_cast<unsigned>(C), THREADS, 0, st>>>(
        e_atom, A, energy);
  }
  return static_cast<int>(cudaGetLastError());
}
