// K10 nn_dedu_vg and its transpose K10T nn_dedu_vg_t: dE/dB of the NN
// solver's cached mode taken back to the pair grid, per atom.
//
// K10: from dE/dB (W,) and the atom's z-lists (computed from its cached ut
//   by K2 zlist),
//     dEdu[u]   = sum over y entries (t, src, fac) of u
//                 dEdB[t] fac (z_r[src], z_i[src])        (real, imag parts)
//     vg[d, e]  = sum_u dEdu[u] Lg[d, e, u].
//   This is LAMMPS's compute_yi with a per-atom beta = dE/dB, followed by
//   the change of basis to the grid.  Replaces fitsnap_tpu/ops/snap.py
//   `nn_dEdu` (the block-restricted y plan of `_y_block_plan`) and `nn_vg`.
// K10T: the transpose, dE/dB's cotangent from vg's,
//     du[u]     = sum_(d, e) vgc[d, e] Lg[d, e, u]
//     dEdBc[t]  = sum over y entries (u, src, fac) of t
//                 fac (z_r[src] du[u] + z_i[src] du[U + u]),
//   reading the z-lists that the forward pass formed (K2 does not run twice
//   in a step).  What JAX's autodiff takes through the same lines.
//
// Bound on the H100: bytes.  Per atom K10 reads the two z rows (2 nz
// doubles, 50 KB at twojmax 6) and writes n_t^2 doubles for about 2 x 2,012
// y entries and 2 x 1,835 Lg entries of multiply-adds; K10T the same
// traffic with n_t^2 read and W written.
//
// Design: one block per atom.  The y entries and Lg come as host-built CSR
// tables (the y entries by U column for K10 and by descriptor for K10T; Lg
// by grid row for K10 and by U column for K10T), read through the
// read-only cache; the 2U-wide intermediate stays in shared memory.  Each
// output is one thread's sum in table order: no atomics, a run repeats bit
// for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) nn_dedu_vg_kernel(
    const double* __restrict__ dedb, const double* __restrict__ zr,
    const double* __restrict__ zi, int W, int nz, int two_u,
    const int* __restrict__ yu_ptr, const int* __restrict__ yu_t,
    const int* __restrict__ yu_src, const double* __restrict__ yu_fac,
    int nt2, const int* __restrict__ lgr_ptr,
    const int* __restrict__ lgr_col, const double* __restrict__ lgr_val,
    double* __restrict__ vg) {
  extern __shared__ double sm[];
  double* sd = sm;          // [W] this atom's dE/dB
  double* du = sm + W;      // [2U] dE/dutot
  const long long a = blockIdx.x;
  const int U = two_u / 2;
  const double* zra = zr + a * nz;
  const double* zia = zi + a * nz;
  for (int t = threadIdx.x; t < W; t += blockDim.x) sd[t] = dedb[a * W + t];
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    double r = 0.0, i = 0.0;
    for (int q = yu_ptr[u]; q < yu_ptr[u + 1]; ++q) {
      const double w = sd[yu_t[q]] * yu_fac[q];
      const int src = yu_src[q];
      r += w * zra[src];
      i += w * zia[src];
    }
    du[u] = r;
    du[U + u] = i;
  }
  __syncthreads();
  for (int de = threadIdx.x; de < nt2; de += blockDim.x) {
    double acc = 0.0;
    for (int q = lgr_ptr[de]; q < lgr_ptr[de + 1]; ++q)
      acc += du[lgr_col[q]] * lgr_val[q];
    vg[a * nt2 + de] = acc;
  }
}

__global__ void __launch_bounds__(THREADS) nn_dedu_vg_t_kernel(
    const double* __restrict__ vgc, const double* __restrict__ zr,
    const double* __restrict__ zi, int W, int nz, int two_u,
    const int* __restrict__ lgc_ptr, const int* __restrict__ lgc_row,
    const double* __restrict__ lgc_val, int nt2,
    const int* __restrict__ yt_ptr, const int* __restrict__ yt_u,
    const int* __restrict__ yt_src, const double* __restrict__ yt_fac,
    double* __restrict__ out) {
  extern __shared__ double sm[];
  double* sv = sm;          // [n_t^2] this atom's grid cotangent
  double* du = sm + nt2;    // [2U] its image on utot
  const long long a = blockIdx.x;
  const int U = two_u / 2;
  const double* zra = zr + a * nz;
  const double* zia = zi + a * nz;
  for (int i = threadIdx.x; i < nt2; i += blockDim.x) sv[i] = vgc[a * nt2 + i];
  __syncthreads();
  for (int u = threadIdx.x; u < two_u; u += blockDim.x) {
    double acc = 0.0;
    for (int q = lgc_ptr[u]; q < lgc_ptr[u + 1]; ++q)
      acc += sv[lgc_row[q]] * lgc_val[q];
    du[u] = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < W; t += blockDim.x) {
    double acc = 0.0;
    for (int q = yt_ptr[t]; q < yt_ptr[t + 1]; ++q) {
      const int u = yt_u[q];
      const int src = yt_src[q];
      acc += yt_fac[q] * (zra[src] * du[u] + zia[src] * du[U + u]);
    }
    out[a * W + t] = acc;
  }
}

}  // namespace

// dedb (N, W) f64, zr, zi (N, nz) f64 (K2's z-lists of the atoms' ut); the
// y entries by U column (yu_ptr (U + 1,), yu_t, yu_src i32, yu_fac f64) and
// Lg by grid row (lgr_ptr (n_t^2 + 1,), lgr_col i32, lgr_val f64).  Writes
// vg (N, n_t^2).
extern "C" int nn_dedu_vg(const double* dedb, const double* zr,
                          const double* zi, long long natoms, int W, int nz,
                          int two_u, const int* yu_ptr, const int* yu_t,
                          const int* yu_src, const double* yu_fac, int nt2,
                          const int* lgr_ptr, const int* lgr_col,
                          const double* lgr_val, double* vg, void* stream) {
  const size_t smem = sizeof(double) * (W + two_u);
  const int err = fs_allow_smem(nn_dedu_vg_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_dedu_vg_kernel<<<static_cast<unsigned>(natoms), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        dedb, zr, zi, W, nz, two_u, yu_ptr, yu_t, yu_src, yu_fac, nt2,
        lgr_ptr, lgr_col, lgr_val, vg);
  }
  return static_cast<int>(cudaGetLastError());
}

// vgc (N, n_t^2) f64, zr, zi (N, nz) f64; Lg by U column (lgc_ptr (2U + 1,),
// lgc_row i32, lgc_val f64) and the y entries by descriptor (yt_ptr
// (W + 1,), yt_u, yt_src i32, yt_fac f64).  Writes out (N, W).
extern "C" int nn_dedu_vg_t(const double* vgc, const double* zr,
                            const double* zi, long long natoms, int W, int nz,
                            int two_u, const int* lgc_ptr, const int* lgc_row,
                            const double* lgc_val, int nt2, const int* yt_ptr,
                            const int* yt_u, const int* yt_src,
                            const double* yt_fac, double* out, void* stream) {
  const size_t smem = sizeof(double) * (nt2 + two_u);
  const int err = fs_allow_smem(nn_dedu_vg_t_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_dedu_vg_t_kernel<<<static_cast<unsigned>(natoms), THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        vgc, zr, zi, W, nz, two_u, lgc_ptr, lgc_row, lgc_val, nt2, yt_ptr,
        yt_u, yt_src, yt_fac, out);
  }
  return static_cast<int>(cudaGetLastError());
}
