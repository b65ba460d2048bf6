// K2 zlist: the SNAP z-lists, z[o] = sum of cg*cg * u1[i1] * u2[i2] over the
// Clebsch-Gordan product terms of each flat z output o (complex pairs).  With
// nc element channels (the chemflag mode) one launch forms the z-lists of
// every ordered channel pair (ea, eb), u1 = utot of channel ea and u2 = utot
// of channel eb, as nc^2 consecutive blocks of nz outputs per atom.
//
// Replaces fitsnap_tpu/ops/snap.py `_compute_zcat_pair` (via `_compute_zcat`,
// and the channel-pair loop of `_chem_b_and_dbdu`, ops/snap.py:1005-1010).
// The TPU form gathers padded term lists and reduces them with (A, P) x
// (P, D^2) GEMMs against a dense M that is mostly zeros; here the host folds
// M into a compact term list (13,868 terms over 3,136 outputs at twojmax 6),
// sorted by output and indexed by a CSR pointer.
//
// Bound on the H100: bytes at small batches (the z outputs, 2 x nc^2 x 3136
// doubles per atom at twojmax 6, against one nc x 2U row of input); the term
// work is about 110 kflop per atom and channel pair.
//
// Design: one block per atom.  The atom's utot row (nc x 2U doubles) is
// staged in shared memory; each thread owns z outputs and sums their terms in
// term order, reading the term table through the read-only cache (it is the
// same for every atom and channel pair, so it stays in L1/L2).  No atomics:
// deterministic.
#include "common.cuh"

namespace {

__global__ void zlist_kernel(const double* __restrict__ ut, int two_u, int nc,
                             const int* __restrict__ z_ptr,
                             const int* __restrict__ z_i1,
                             const int* __restrict__ z_i2,
                             const double* __restrict__ z_c, int nz,
                             double* __restrict__ zr,
                             double* __restrict__ zi) {
  extern __shared__ double su[];  // [nc][2U]: real | imag per channel
  const long long a = blockIdx.x;
  const int U = two_u / 2;
  const int row = nc * two_u;
  const long long nout = static_cast<long long>(nc) * nc * nz;
  for (int i = threadIdx.x; i < row; i += blockDim.x) su[i] = ut[a * row + i];
  __syncthreads();
  for (int o = threadIdx.x; o < nout; o += blockDim.x) {
    const int pair = o / nz;
    const int oz = o % nz;
    const double* u1 = su + (pair / nc) * two_u;
    const double* u2 = su + (pair % nc) * two_u;
    double sr = 0.0, si = 0.0;
    const int q1 = z_ptr[oz + 1];
    for (int q = z_ptr[oz]; q < q1; ++q) {
      const int i1 = z_i1[q];
      const int i2 = z_i2[q];
      const double c = z_c[q];
      const double ar = u1[i1], ai = u1[U + i1];
      const double br = u2[i2], bi = u2[U + i2];
      sr += (ar * br - ai * bi) * c;
      si += (ar * bi + ai * br) * c;
    }
    zr[a * nout + o] = sr;
    zi[a * nout + o] = si;
  }
}

}  // namespace

// ut (N, nc * 2U) f64; term table z_ptr (nz + 1,), z_i1, z_i2 (nterms,) i32
// and z_c (nterms,) f64.  Writes zr, zi (N, nc * nc, nz).
extern "C" int zlist(const double* ut, long long natoms, int two_u, int nc,
                     const int* z_ptr, const int* z_i1, const int* z_i2,
                     const double* z_c, int nz, double* zr, double* zi,
                     void* stream) {
  const size_t smem = sizeof(double) * nc * two_u;
  const int err = fs_allow_smem(zlist_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    zlist_kernel<<<static_cast<unsigned>(natoms), 256, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        ut, two_u, nc, z_ptr, z_i1, z_i2, z_c, nz, zr, zi);
  }
  return static_cast<int>(cudaGetLastError());
}
