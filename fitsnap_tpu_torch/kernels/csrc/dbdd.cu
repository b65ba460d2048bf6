// K3 dbdd: per atom, dB/dutot from the three y-layers of the z-lists, the
// bispectrum B from the first layer, and the pair jacobian
//   dBdD[a, w, k, c] = sum_u y[a, w, ch(a, k), u] * J[c, a, k, u],
// where ch(a, k) is the utot channel of neighbor k: 0 with one channel, the
// neighbor's element in the chemflag mode (nc > 1 channels, y resolved by
// channel; a neighbor whose element is no channel gets zeros).
//
// Replaces fitsnap_tpu/ops/snap.py `_dbdu_ylist` and the contractions of
// `descriptors_with_jacobian` (the Bbase einsums and
// einsum("awu,caku->awkc") at ops/snap.py:956-971); in the chemflag mode
// `_chem_b_and_dbdu` (ops/snap.py:992-1058) and the contraction
// einsum("awnu,akn,caku->awkc") at :981-982.
//
// Bound on the H100: bytes, in all three modes.  The kernel must read J
// (3 x K x 2U doubles per atom, 430 KB at K = 64, twojmax 6) once and
// write dB/dD; its FP64 work, counted over y's nonzero entries (a row holds
// only the u levels of its triple's three layers and, in the chemflag mode,
// only the layers of the neighbor's channel), is 20 flops per J double at
// twojmax 6, 31 at twojmax 8 and 96 with InP's two channels (dense: 60,
// 110, 480), under the 160 a double that the FP64 tensor cores (67 T/s) do
// in the time HBM (3.35 TB/s) delivers one.
//
// Design: the per-atom product of atom_gemm.cuh, L = the atom's y rows.
// One block per (atom, tile of W), W split evenly over the tiles of at most
// MT (16 or 32) rows, planned by the wrapper (`dbdd_tiles`) so that two
// blocks share an SM where one channel's y rows (MT x 2U doubles) and the
// product's epilogue stage fit half its shared memory: one tile of 30 rows at twojmax 6, four of 14 at
// twojmax 8, eight of 30 with InP's two channels; the tiles of an atom have
// neighbouring block indices, so their J reads after the first hit L2.
//   1. y rows and the zero-block flags are cleared; warp 0 lists the
//      neighbors of channel ch by ballot, in slot order (one channel: all
//      of them), and those of no channel;
//   2. a warp per row forms B (first pass only: the fac-0 layer of the
//      row's channel against utot, lanes over u, a fixed butterfly), then
//      writes the row's nonzero y entries for channel ch from the host's
//      compact target list (the (triple, u) with a nonzero y_fac, each with
//      its three layers' sources and factors, summed in layer order as the
//      plain version does) and flags the (row tile, k-step) blocks it
//      touches;
//   3. the product runs over the columns (neighbor, direction) of channel
//      ch's neighbors only, so a neighbor meets its own channel's y rows
//      alone, skipping zero blocks; 1-3 repeat per channel;
//   4. the neighbors of no channel get zeros.
// Past twojmax 12, 16 whole y rows (2U doubles each) exceed a block's shared
// memory: the slab shape (`dbdd_slab_kernel`, the wrapper's `dbdd_plan`)
// takes rows of 32 and builds y a slab of u columns at a time, the
// accumulators carried across the slabs in inner order.
// Padding slots carry J = 0 and come out exactly 0.  No atomics: the
// output repeats bit for bit.
// Working types: the whole-row shape also has a float32 instantiation
// (`dbdd_f32`, the streamed linear SNAP fit at float32: float32 utot,
// z-lists, J and tables, y rows of float32 in shared memory), whose product
// is atom_gemm.cuh's float32 FMA path; the slab shape is float64 only.
#include "atom_gemm.cuh"

namespace {

template <typename T>
struct Args {
  const T* ut;               // (N, nc 2U)
  const T* zr;               // (N, nc^2, nz)
  const T* zi;
  const T* J;                // (3, N, K, 2U)
  const int* jelem;          // (N, K), read when nc > 1
  const int* tg_ptr;         // (ntrip + 1,) targets of triple t
  const int* tg_u;           // (nT,) u of each target
  const int* tg_src;         // (nT, 3) z index of each layer
  const T* tg_fac;           // (nT, 3) factor of each layer (0: none)
  const int4* tg_slab;       // slab shape: (ntrip, nslab) target ranges
  const int* y_src;          // (3, ntrip, U): layer 0 forms B
  const T* y_fac;
  const int* blk_chan;       // (nc^3, 3) channel of each layer
  const int* blk_pair;       // (nc^3, 3) z channel pair it reads
  const T* bzero;            // (W,)
  int W, ntrip, U, nz, nc, K, MT, ntiles;
  long long N;
};

template <int IW, typename T>
__global__ void __launch_bounds__(AG_THREADS, 2)
    dbdd_kernel(Args<T> p, T* __restrict__ B, T* __restrict__ dBdD) {
  extern __shared__ __align__(16) unsigned char smem_y[];
  const int two_u = 2 * p.U;
  const int ldl = ag_ldl(two_u);
  const int nks = ldl / 8;                   // k-steps of a y row
  T* y = reinterpret_cast<T*>(smem_y);       // [MT][ldl]
  T* stage = y + p.MT * ldl;                 // [AG_STAGE]
  int* slot = reinterpret_cast<int*>(stage + AG_STAGE);  // [K]
  int* none = slot + p.K;                    // [K] neighbors of no channel
  int* count = none + p.K;                   // [2]
  unsigned char* nzf = reinterpret_cast<unsigned char*>(count + 2);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long a = blockIdx.x / p.ntiles;
  const int per = (p.W + p.ntiles - 1) / p.ntiles;   // <= MT
  const int w0 = (blockIdx.x % p.ntiles) * per;
  const int rows = min(per, p.W - w0);
  const long long zrow = static_cast<long long>(p.nc) * p.nc * p.nz;
  const T* za_r = p.zr + a * zrow;
  const T* za_i = p.zi + a * zrow;
  const int* jel = p.nc > 1 ? p.jelem + a * p.K : nullptr;

  for (int idx = tid; idx < p.MT * ldl * static_cast<int>(sizeof(T)) / 16;
       idx += AG_THREADS)
    reinterpret_cast<uint4*>(y)[idx] = make_uint4(0u, 0u, 0u, 0u);

  AtomGemmT<T> g{y, ldl, rows, nzf, p.J + a * p.K * two_u,
                 p.N * p.K * two_u, two_u, slot, 0,
                 dBdD + (a * p.W + w0) * p.K * 3, 3LL * p.K, stage};
  for (int ch = 0; ch < p.nc; ++ch) {
    // 1.
    for (int idx = tid; idx < IW * nks; idx += AG_THREADS) nzf[idx] = 0;
    if (warp == 0) {
      int n = 0, nn = 0;
      for (int k0 = 0; k0 < p.K; k0 += 32) {
        const int k = k0 + lane;
        const int e = k < p.K ? (p.nc > 1 ? jel[k] : 0) : -1;
        const unsigned below = (1u << lane) - 1u;
        const unsigned in = __ballot_sync(0xffffffffu, e == ch);
        if (e == ch) slot[n + __popc(in & below)] = k;
        n += __popc(in);
        if (ch == 0) {
          const bool out = k < p.K && (e < 0 || e >= p.nc);
          const unsigned bad = __ballot_sync(0xffffffffu, out);
          if (out) none[nn + __popc(bad & below)] = k;
          nn += __popc(bad);
        }
      }
      if (lane == 0) {
        count[0] = n;
        if (ch == 0) count[1] = nn;
      }
    }
    __syncthreads();
    g.ncols = 3 * count[0];

    // 2.
    for (int r = warp; r < rows; r += AG_THREADS / 32) {
      const int w = w0 + r;
      const int blk = w / p.ntrip;
      const int t = w % p.ntrip;
      if (ch == 0) {
        const T* ua = p.ut + (a * p.nc + p.blk_chan[blk * 3]) * two_u;
        const long long zoff =
            static_cast<long long>(p.blk_pair[blk * 3]) * p.nz;
        // four u a lane at a time: their loads are in flight together
        T s = T(0);
        for (int u0 = lane; u0 < p.U; u0 += 128) {
          T f[4];
          long long src[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            f[k] = u0 + 32 * k < p.U ? p.y_fac[t * p.U + u] : T(0);
            src[k] = zoff + p.y_src[t * p.U + u];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            s += ua[u] * (f[k] * za_r[src[k]]) +
                 ua[p.U + u] * (f[k] * za_i[src[k]]);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) B[a * p.W + w] = s - p.bzero[w];
      }
      if (g.ncols == 0) continue;
      int chan[3];
      long long pair[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        chan[l] = p.blk_chan[blk * 3 + l];
        pair[l] = static_cast<long long>(p.blk_pair[blk * 3 + l]) * p.nz;
      }
      T* yw = y + r * ldl;
      const int q1 = p.tg_ptr[t + 1];
      // two targets a lane at a time: their loads are in flight together
      for (int q0 = p.tg_ptr[t] + lane; q0 < q1; q0 += 64) {
        T yr[2] = {T(0), T(0)}, yi[2] = {T(0), T(0)};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = min(q0 + 32 * k, q1 - 1);
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            if (chan[l] != ch) continue;
            const T f = p.tg_fac[q * 3 + l];
            const long long src = pair[l] + p.tg_src[q * 3 + l];
            yr[k] += f * za_r[src];
            yi[k] += f * za_i[src];
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (q0 + 32 * k >= q1) break;
          const int u = p.tg_u[q0 + 32 * k];
          yw[u] = yr[k];
          yw[p.U + u] = yi[k];
          if (yr[k] != T(0)) nzf[r / 16 * nks + u / 8] = 1;
          if (yi[k] != T(0)) nzf[r / 16 * nks + (p.U + u) / 8] = 1;
        }
      }
    }

    // 3.
    if (g.ncols > 0)
      ag_run<IW>(g);
    else
      __syncthreads();     // count is rewritten by the next pass
  }

  // 4.
  const int nbad = count[1];
  for (int idx = tid; idx < rows * nbad * 3; idx += AG_THREADS) {
    const int r = idx / (nbad * 3);
    const int k = none[(idx / 3) % nbad];
    dBdD[((a * p.W + w0 + r) * p.K + k) * 3 + idx % 3] = T(0);
  }
}

// The slab shape, for y rows past a block's shared memory (twojmax 13 and
// up): rows of MT = 16 IW, and y built `slab` columns at a time into
// [MT][ldl] (ldl = ag_ldl(slab)) for each sweep of the product's columns
// (ag_run_slabs), from the same compact targets: those whose real or
// imaginary column falls in the slab, a range of the triple's u-sorted
// targets for each part (`snap_kernels.dbdd_slab_ranges`), the part alone
// summed; B is formed once, before the product.  The product's chains are ag_run's, so the output equals the
// whole-row shape's bit for bit.
template <int IW>
__global__ void __launch_bounds__(AG_THREADS, 2)
    dbdd_slab_kernel(Args<double> p, int slab, double* __restrict__ B,
                     double* __restrict__ dBdD) {
  using T = double;
  extern __shared__ __align__(16) double smem[];
  const int two_u = 2 * p.U;
  const int ldl = ag_ldl(slab);
  const int nks = ldl / 8;                   // flags of a row tile
  const int nslab = (two_u + slab - 1) / slab;
  double* y = smem;                          // [MT][ldl]
  double* stage = y + p.MT * ldl;            // [AG_STAGE]
  int* slot = reinterpret_cast<int*>(stage + AG_STAGE);  // [K]
  int* none = slot + p.K;                    // [K] neighbors of no channel
  int* count = none + p.K;                   // [2]
  unsigned char* nzf = reinterpret_cast<unsigned char*>(count + 2);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long a = blockIdx.x / p.ntiles;
  const int per = (p.W + p.ntiles - 1) / p.ntiles;   // <= MT
  const int w0 = (blockIdx.x % p.ntiles) * per;
  const int rows = min(per, p.W - w0);
  const long long zrow = static_cast<long long>(p.nc) * p.nc * p.nz;
  const double* za_r = p.zr + a * zrow;
  const double* za_i = p.zi + a * zrow;
  const int* jel = p.nc > 1 ? p.jelem + a * p.K : nullptr;

  AtomGemm g{y, ldl, rows, nzf, p.J + a * p.K * two_u, p.N * p.K * two_u,
             two_u, slot, 0, dBdD + (a * p.W + w0) * p.K * 3, 3LL * p.K,
             stage};
  for (int ch = 0; ch < p.nc; ++ch) {
    // the neighbors of channel ch, and those of no channel
    if (warp == 0) {
      int n = 0, nn = 0;
      for (int k0 = 0; k0 < p.K; k0 += 32) {
        const int k = k0 + lane;
        const int e = k < p.K ? (p.nc > 1 ? jel[k] : 0) : -1;
        const unsigned below = (1u << lane) - 1u;
        const unsigned in = __ballot_sync(0xffffffffu, e == ch);
        if (e == ch) slot[n + __popc(in & below)] = k;
        n += __popc(in);
        if (ch == 0) {
          const bool out = k < p.K && (e < 0 || e >= p.nc);
          const unsigned bad = __ballot_sync(0xffffffffu, out);
          if (out) none[nn + __popc(bad & below)] = k;
          nn += __popc(bad);
        }
      }
      if (lane == 0) {
        count[0] = n;
        if (ch == 0) count[1] = nn;
      }
    }
    // B, a warp a row, as the whole-row shape's
    if (ch == 0) {
      for (int r = warp; r < rows; r += AG_THREADS / 32) {
        const int w = w0 + r;
        const int blk = w / p.ntrip;
        const int t = w % p.ntrip;
        const T* ua = p.ut + (a * p.nc + p.blk_chan[blk * 3]) * two_u;
        const long long zoff =
            static_cast<long long>(p.blk_pair[blk * 3]) * p.nz;
        T s = T(0);
        for (int u0 = lane; u0 < p.U; u0 += 128) {
          T f[4];
          long long src[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            f[k] = u0 + 32 * k < p.U ? p.y_fac[t * p.U + u] : T(0);
            src[k] = zoff + p.y_src[t * p.U + u];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            s += ua[u] * (f[k] * za_r[src[k]]) +
                 ua[p.U + u] * (f[k] * za_i[src[k]]);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) B[a * p.W + w] = s - p.bzero[w];
      }
    }
    __syncthreads();
    g.ncols = 3 * count[0];
    if (g.ncols == 0) {
      __syncthreads();     // count is rewritten by the next pass
      continue;
    }
    // y's columns [i0, i1) of channel ch and their zero flags
    auto build = [&](int i0, int i1) {
      for (int idx = tid; idx < p.MT * ldl / 2; idx += AG_THREADS)
        reinterpret_cast<double2*>(y)[idx] = make_double2(0.0, 0.0);
      for (int idx = tid; idx < IW * nks; idx += AG_THREADS) nzf[idx] = 0;
      __syncthreads();
      for (int r = warp; r < rows; r += AG_THREADS / 32) {
        const int w = w0 + r;
        const int blk = w / p.ntrip;
        const int t = w % p.ntrip;
        int chan[3];
        long long pair[3];
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          chan[l] = p.blk_chan[blk * 3 + l];
          pair[l] = static_cast<long long>(p.blk_pair[blk * 3 + l]) * p.nz;
        }
        double* yw = y + r * ldl - i0;
        // the targets whose real column (part 0) or imaginary column (part
        // 1, at U + u) falls in the slab: a range of the triple's u-sorted
        // targets each (the host's table); the part alone is summed
        const int4 rg = p.tg_slab[t * nslab + i0 / slab];
        for (int part = 0; part < 2; ++part) {
          const int qa = part ? rg.z : rg.x, qb = part ? rg.w : rg.y;
          const double* za = part ? za_i : za_r;
          for (int q = qa + lane; q < qb; q += 32) {
            const int col = part * p.U + p.tg_u[q];
            double v = 0.0;
#pragma unroll
            for (int l = 0; l < 3; ++l) {
              if (chan[l] != ch) continue;
              v += p.tg_fac[q * 3 + l] * za[pair[l] + p.tg_src[q * 3 + l]];
            }
            yw[col] = v;
            if (v != 0.0) nzf[r / 16 * nks + (col - i0) / 8] = 1;
          }
        }
      }
    };
    ag_run_slabs<IW>(g, slab, build);
  }

  // the neighbors of no channel get zeros
  const int nbad = count[1];
  for (int idx = tid; idx < rows * nbad * 3; idx += AG_THREADS) {
    const int r = idx / (nbad * 3);
    const int k = none[(idx / 3) % nbad];
    dBdD[((a * p.W + w0 + r) * p.K + k) * 3 + idx % 3] = 0.0;
  }
}

template <int IW>
int launch_slab(const Args<double>& p, int slab, size_t smem, double* B,
                double* dBdD, cudaStream_t stream) {
  const int err = fs_allow_smem(dbdd_slab_kernel<IW>, smem);
  if (err) return err;
  if (p.N > 0)
    dbdd_slab_kernel<IW><<<static_cast<unsigned>(p.N * p.ntiles),
                           AG_THREADS, smem, stream>>>(p, slab, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

template <int IW, typename T>
int launch(const Args<T>& p, size_t smem, T* B, T* dBdD,
           cudaStream_t stream) {
  const int err = fs_allow_smem(dbdd_kernel<IW, T>, smem);
  if (err) return err;
  if (p.N > 0)
    dbdd_kernel<IW, T><<<static_cast<unsigned>(p.N * p.ntiles), AG_THREADS,
                         smem, stream>>>(p, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

// The whole-row shape at either type.
template <typename T>
int launch_rows(const Args<T>& p, int MT, T* B, T* dBdD,
                cudaStream_t stream) {
  const int ldl = ag_ldl(2 * p.U);
  const size_t smem = sizeof(T) * (MT * ldl + AG_STAGE) +
                      sizeof(int) * (2 * static_cast<size_t>(p.K) + 2) +
                      MT / 16 * (ldl / 8);
  if (smem > FS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (MT == 16) return launch<1, T>(p, smem, B, dBdD, stream);
  if (MT == 32) return launch<2, T>(p, smem, B, dBdD, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ut (N, nc * 2U), zr, zi (N, nc * nc, nz), J (3, N, K, 2U) f64; jelem
// (N, K) i32, read only when nc > 1; compact y targets tg_ptr (ntrip + 1),
// tg_u (nT,), tg_src (nT, 3) i32, tg_fac (nT, 3) f64; y_src (3, ntrip, U)
// i32 and y_fac (3, ntrip, U) f64 (layer 0 forms B); blk_chan, blk_pair
// (nc^3, 3) i32; bzero (W,) f64 (zeros when bzeroflag is 0), W = nc^3 *
// ntrip.  W split evenly over ntiles blocks per atom of at most MT rows
// (16 or 32); slab 0 holds whole y rows, else y is built slab columns at a
// time (a multiple of 48) from tg_slab (ntrip, ceil(2U / slab), 4) i32,
// each slab's target ranges (`snap_kernels.dbdd_slab_ranges`).  Writes B (N, W) and dBdD (N, W, K, 3).
extern "C" int dbdd(const double* ut, const double* zr, const double* zi,
                    const double* J, const int* jelem, const int* tg_ptr,
                    const int* tg_u, const int* tg_src, const double* tg_fac,
                    const int* tg_slab, const int* y_src, const double* y_fac,
                    const int* blk_chan, const int* blk_pair,
                    const double* bzero, long long natoms, int K, int ntrip,
                    int U, int nz, int nc, int MT, int ntiles, int slab,
                    double* B, double* dBdD, void* stream) {
  const int W = nc * nc * nc * ntrip;
  const Args<double> p{ut, zr, zi, J, jelem, tg_ptr, tg_u, tg_src, tg_fac,
                       reinterpret_cast<const int4*>(tg_slab), y_src, y_fac,
                       blk_chan, blk_pair, bzero, W, ntrip, U, nz, nc, K,
                       MT, ntiles, natoms};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab != 0) {
    if (slab < 0 || slab % (8 * AG_DEPTH * 2) != 0 || !tg_slab)
      return static_cast<int>(cudaErrorInvalidValue);
    const int ldl = ag_ldl(slab);
    const size_t smem = sizeof(double) * (MT * ldl + AG_STAGE) +
                        sizeof(int) * (2 * static_cast<size_t>(K) + 2) +
                        MT / 16 * (ldl / 8);
    if (smem > FS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    if (MT == 16) return launch_slab<1>(p, slab, smem, B, dBdD, s);
    if (MT == 32) return launch_slab<2>(p, slab, smem, B, dBdD, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(p, MT, B, dBdD, s);
}

// The float32 instantiation of the whole-row shape: `dbdd`'s arguments
// with ut, zr, zi, J, tg_fac, y_fac, bzero, B and dBdD f32 (a float32
// plan's tables), and no slab.
extern "C" int dbdd_f32(const float* ut, const float* zr, const float* zi,
                        const float* J, const int* jelem, const int* tg_ptr,
                        const int* tg_u, const int* tg_src,
                        const float* tg_fac, const int* tg_slab,
                        const int* y_src, const float* y_fac,
                        const int* blk_chan, const int* blk_pair,
                        const float* bzero, long long natoms, int K,
                        int ntrip, int U, int nz, int nc, int MT, int ntiles,
                        int slab, float* B, float* dBdD, void* stream) {
  if (slab != 0 || tg_slab) return static_cast<int>(cudaErrorInvalidValue);
  const int W = nc * nc * nc * ntrip;
  const Args<float> p{ut, zr, zi, J, jelem, tg_ptr, tg_u, tg_src, tg_fac,
                      nullptr, y_src, y_fac, blk_chan, blk_pair, bzero, W,
                      ntrip, U, nz, nc, K, MT, ntiles, natoms};
  return launch_rows(p, MT, B, dBdD, static_cast<cudaStream_t>(stream));
}
