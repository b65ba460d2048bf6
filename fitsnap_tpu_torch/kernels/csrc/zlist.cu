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
// M into a compact term list (13,868 terms over 3,136 outputs at twojmax 6).
//
// Bound on the H100: bytes (the z outputs, 2 x nc^2 x 3136 doubles per atom
// at twojmax 6, against one nc x 2U row of input); the term work is about
// 110 kflop per atom and channel pair.
//
// Design (host schedule `snap_kernels.zlist_tables`).  Only 1,388 of the
// 3,136 outputs have a term at twojmax 6 (4,367 of 10,125 at twojmax 8);
// the rest are structurally zero and get plain zero stores.  The outputs
// with terms are sorted by term count and dealt to warps 32 at a time, so
// that the lanes of a warp sum nearly equal counts; each group's terms are
// packed lane-interleaved as 16-byte records (coefficient, i1, i2), padded
// with zero terms to the group's longest.
//   * A block is (atom group, segment).  It stages the utot rows of its
//     atoms (8 with one channel, fewer with more) in shared memory; every
//     record a lane reads (4 in flight ahead of use) is applied to each
//     (atom, channel pair) of the block from registers, 8 at a time. 
//   * The segments (the grid's second axis, sized to fill the card) take
//     the groups round-robin and an equal share of the zero outputs.
// Each output's terms are summed in the host's term order.  No atomics: the
// output repeats bit for bit.
// Working types: a float32 instantiation (`zlist_f32`, the streamed linear
// SNAP fit at float32) reads float32 utot, whose records hold the float32
// coefficient (rounded once from the float64 one) in their first word, and
// sums in float32; the records stay 16 bytes.
#include "common.cuh"

namespace {

constexpr int NW = 8;   // warps of a block
constexpr int CB = 8;   // (atom, channel pair) combinations a pass
constexpr int PF = 4;   // records a lane keeps in flight

// A term record (16 bytes): the coefficient, then i1 and i2 in words 2 and
// 3; float64: the coefficient in words 0-1 (one double2), float32: its bits
// in word 0 (one int4).
template <typename T>
struct ZRec;

template <>
struct ZRec<double> {
  using V = double2;
  __device__ static V zero() { return make_double2(0.0, 0.0); }
  __device__ static void get(V r, double& c, int& i1, int& i2) {
    const long long b = __double_as_longlong(r.y);
    i1 = static_cast<int>(b & 0xffffffffLL);
    i2 = static_cast<int>(b >> 32);
    c = r.x;
  }
};

template <>
struct ZRec<float> {
  using V = int4;
  __device__ static V zero() { return make_int4(0, 0, 0, 0); }
  __device__ static void get(V r, float& c, int& i1, int& i2) {
    c = __int_as_float(r.x);
    i1 = r.z;
    i2 = r.w;
  }
};

template <typename T>
__global__ void __launch_bounds__(NW * 32) zlist_kernel(
    const T* __restrict__ ut, long long natoms, int two_u, int nc,
    int ab, const typename ZRec<T>::V* __restrict__ rec,
    const int2* __restrict__ grp, const int* __restrict__ grp_out, int ngrp,
    const int* __restrict__ zo, int nzero, int nz, T* __restrict__ zr,
    T* __restrict__ zi) {
  using V = typename ZRec<T>::V;
  extern __shared__ __align__(16) unsigned char su_raw[];
  T* su = reinterpret_cast<T*>(su_raw);  // [ab][nc][2U]: real | imag
  const long long a0 = static_cast<long long>(blockIdx.x) * ab;
  const int sg = blockIdx.y, nseg = gridDim.y;
  const int U = two_u / 2;
  const int row = nc * two_u;
  const int nat = static_cast<int>(min(static_cast<long long>(ab),
                                       natoms - a0));
  for (int i = threadIdx.x; i < ab * row; i += blockDim.x)
    su[i] = i < nat * row ? ut[a0 * row + i] : T(0);
  __syncthreads();
  const int npair = nc * nc;
  const long long out0 = a0 * npair;  // first (atom, channel pair) row

  // the segment's share of the structurally zero outputs
  const int z0 = static_cast<int>(static_cast<long long>(nzero) * sg / nseg);
  const int nzs =
      static_cast<int>(static_cast<long long>(nzero) * (sg + 1) / nseg) - z0;
  for (int i = threadIdx.x; i < nat * npair * nzs; i += blockDim.x) {
    const long long o = (out0 + i / nzs) * nz + zo[z0 + i % nzs];
    zr[o] = T(0);
    zi[o] = T(0);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncomb = nat * npair;
  for (int g = sg * NW + warp; g < ngrp; g += nseg * NW) {
    const int2 gb = grp[g];  // first record, terms of the group
    const int o = grp_out[g * 32 + lane];
    const V* rp = rec + gb.x + lane;
    for (int cb0 = 0; cb0 < ncomb; cb0 += CB) {
      int off1[CB], off2[CB];
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int cb = min(cb0 + i, ncomb - 1);
        const int at = cb / npair, pr = cb % npair;
        off1[i] = (at * nc + pr / nc) * two_u;
        off2[i] = (at * nc + pr % nc) * two_u;
      }
      T sr[CB], si[CB];
#pragma unroll
      for (int i = 0; i < CB; ++i) sr[i] = si[i] = T(0);
      // records PF ahead in registers
      V ring[PF];
#pragma unroll
      for (int j = 0; j < PF; ++j)
        ring[j] = j < gb.y ? rp[j * 32] : ZRec<T>::zero();
      for (int q0 = 0; q0 < gb.y; q0 += PF) {
#pragma unroll
        for (int j = 0; j < PF; ++j) {
          const int q = q0 + j;
          if (q >= gb.y) break;
          const V r = ring[j];
          if (q + PF < gb.y) ring[j] = rp[(q + PF) * 32];
          T c;
          int i1, i2;
          ZRec<T>::get(r, c, i1, i2);
#pragma unroll
          for (int i = 0; i < CB; ++i) {
            const T ar = su[off1[i] + i1], ai = su[off1[i] + U + i1];
            const T br = su[off2[i] + i2], bi = su[off2[i] + U + i2];
            sr[i] += (ar * br - ai * bi) * c;
            si[i] += (ar * bi + ai * br) * c;
          }
        }
      }
      if (o >= 0) {
#pragma unroll
        for (int i = 0; i < CB; ++i) {
          if (cb0 + i < ncomb) {
            const long long idx = (out0 + cb0 + i) * nz + o;
            zr[idx] = sr[i];
            zi[idx] = si[i];
          }
        }
      }
    }
  }
}

template <typename T>
int zlist_launch(const T* ut, long long natoms, int two_u, int nc, int ab,
                 int nseg, const void* rec, const int* grp,
                 const int* grp_out, int ngrp, const int* zo, int nzero,
                 int nz, T* zr, T* zi, void* stream) {
  const size_t smem = sizeof(T) * ab * nc * two_u;
  if (ab < 1 || nseg < 1 || nseg > 65535 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = fs_allow_smem(zlist_kernel<T>, smem);
  if (err) return err;
  if (natoms > 0) {
    const dim3 grid(static_cast<unsigned>((natoms + ab - 1) / ab),
                    static_cast<unsigned>(nseg));
    zlist_kernel<T><<<grid, NW * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        ut, natoms, two_u, nc, ab,
        reinterpret_cast<const typename ZRec<T>::V*>(rec),
        reinterpret_cast<const int2*>(grp), grp_out, ngrp, zo, nzero, nz, zr,
        zi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ut (N, nc * 2U) f64; the schedule of `snap_kernels.zlist_tables`: rec
// (R, 2) f64 records (coefficient; i1 | i2 << 32 as bits), grp (ngrp, 2)
// i32 (first record, terms), grp_out (ngrp * 32,) i32 (-1: no output), zo
// (nzero,) i32 the outputs without terms; ab atoms a block, nseg segments.
// Writes zr, zi (N, nc * nc, nz).
extern "C" int zlist(const double* ut, long long natoms, int two_u, int nc,
                     int ab, int nseg, const double* rec, const int* grp,
                     const int* grp_out, int ngrp, const int* zo, int nzero,
                     int nz, double* zr, double* zi, void* stream) {
  return zlist_launch<double>(ut, natoms, two_u, nc, ab, nseg, rec, grp,
                              grp_out, ngrp, zo, nzero, nz, zr, zi, stream);
}

// The float32 instantiation: ut, zr, zi f32, rec (R, 4) i32 records of a
// float32 plan (the coefficient's float32 bits, 0, i1, i2).
extern "C" int zlist_f32(const float* ut, long long natoms, int two_u,
                         int nc, int ab, int nseg, const int* rec,
                         const int* grp, const int* grp_out, int ngrp,
                         const int* zo, int nzero, int nz, float* zr,
                         float* zi, void* stream) {
  return zlist_launch<float>(ut, natoms, two_u, nc, ab, nseg, rec, grp,
                             grp_out, ngrp, zo, nzero, nz, zr, zi, stream);
}
