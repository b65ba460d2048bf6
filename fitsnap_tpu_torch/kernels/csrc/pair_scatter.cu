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
// Bound on the H100: bytes (g is read once from memory, and a second time
// from L2 by the gather; a few flops per element).
//
// Design: deterministic gathers instead of atomics.  The host builds a
// reverse neighbor table rev (C, A, R): for each destination atom the flat
// slots i*K + k that point at it, increasing, padded with -1.  An atom that
// is its own neighbor through periodic images (small cells) appears once
// per such slot, so repeated indices accumulate.  One block per
// (config, x-tile of XT columns, destination atom n), the atoms fastest,
// so that the blocks in flight share one config's x-tile of g in L2:
//   1. own pass: g[n, x-tile, :, :], one contiguous run, copied once to
//      shared memory by cp.async while the gather (2.) runs (XT is sized
//      so that the copy stays within 24 KB, which also keeps the tiles in
//      flight within L2); half-warps then take one x each, lanes along k,
//      and form the row sums and the six virial products against disp[n]
//      (staged masked), reduced over the half-warp by a fixed butterfly.
//      The virial goes out as a per-atom partial (C, A, 6, X);
//   2. neighbor gather: the atom's reverse slots and their source types
//      staged in shared memory once; warps take slots in turn, SB at a
//      time, lanes the tile's (x, d) entries, so one slot costs one round
//      of independent loads (from L2: the slot's own block reads it too);
//      each warp adds into its own accumulator of the slot's type;
//   3. force rows: the row sum of the atom's type minus the warps'
//      accumulators summed in warp order, written along x.
// A second kernel sums the virial partials over each config's atoms of
// type t in a fixed order.  No atomics: the outputs repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int XT_MAX = 16;           // x columns of one tile
constexpr int EJ_MAX = (3 * XT_MAX + 31) / 32;   // gather entries per lane
constexpr int SB = 4;                // gather slots in flight per warp
constexpr int VR_WARPS = 8;          // warps of a virial block
constexpr int OWN_LANES = 16;        // lanes along k of one x (half-warp)

// Asynchronous copy of `bytes` (8 or 16) from global to shared memory.
__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__global__ void __launch_bounds__(SC_THREADS)
    scatter_rows_kernel(const double* __restrict__ g,
                        const double* __restrict__ disp,
                        const unsigned char* __restrict__ vmask,
                        const int* __restrict__ rev,
                        const int* __restrict__ types, int A, int X, int K,
                        int R, int T, int XT, double* __restrict__ force,
                        double* __restrict__ vpart) {
  extern __shared__ double sm[];
  const int nxt = (X + XT - 1) / XT;
  const long long b = blockIdx.x;
  const long long c = b / (static_cast<long long>(nxt) * A);
  const int x0 = static_cast<int>((b / A) % nxt) * XT;
  const int nx = X - x0 < XT ? X - x0 : XT;   // live columns of the tile
  const long long n = c * A + b % A;     // destination atom
  const long long first = c * A;         // first atom of its config
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ne = 3 * XT;                 // (x, d) entries of the tile
  const int run = 3 * K;                 // doubles of one x's (k, d) run

  double* sg = sm;                       // [XT][3K] the atom's own g
  double* sd = sg + XT * run;            // [K][3] masked displacements
  double* sacc = sd + run;               // [warp][T][ne] gather sums
  double* srow = sacc + SC_WARPS * T * ne;  // [XT][3] row sums
  double* svir = srow + ne;              // [6][XT] virial products
  long long* soff = reinterpret_cast<long long*>(svir + 6 * XT);  // [R]
  int* stype = reinterpret_cast<int*>(soff + R);                  // [R]

  // the own run g[n, x0:x0+nx] is contiguous: copied by cp.async (16
  // bytes where aligned), in flight during the gather below
  {
    const long long start = (n * X + x0) * run;
    const int len = nx * run;
    if ((reinterpret_cast<unsigned long long>(g + start) & 15) == 0 &&
        (len & 1) == 0) {
      for (int m = tid; m < len / 2; m += SC_THREADS)
        cp_async(sg + 2 * m, g + start + 2 * m, 16);
    } else {
      for (int m = tid; m < len; m += SC_THREADS)
        cp_async(sg + m, g + start + m, 8);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int e = tid; e < run; e += SC_THREADS) {
    const long long pk = n * K + e / 3;
    sd[e] = vmask[pk] ? disp[pk * 3 + e % 3] : 0.0;
  }
  for (int e = tid; e < SC_WARPS * T * ne; e += SC_THREADS) sacc[e] = 0.0;
  for (int r = tid; r < R; r += SC_THREADS) {
    const int slot = rev[n * R + r];
    if (slot >= 0) {
      const long long i = first + slot / K;
      soff[r] = ((i * X + x0) * K + slot % K) * 3;
      stype[r] = types[i];
    } else {
      soff[r] = -1;
    }
  }
  __syncthreads();

  // 2. neighbor gather, while the own run arrives: warp w takes slots w,
  // w + SC_WARPS, ...
  int eo[EJ_MAX];
  bool live[EJ_MAX];
#pragma unroll
  for (int j = 0; j < EJ_MAX; ++j) {
    const int e = lane + 32 * j;
    live[j] = e < 3 * nx;
    eo[j] = (e / 3) * run + e % 3;
  }
  double* acc = sacc + warp * T * ne;
  for (int r0 = warp; r0 < R; r0 += SB * SC_WARPS) {
    long long off[SB];
    double val[SB][EJ_MAX];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int r = r0 + u * SC_WARPS;
      off[u] = r < R ? soff[r] : -1;
#pragma unroll
      for (int j = 0; j < EJ_MAX; ++j)
        val[u][j] = off[u] >= 0 && live[j] ? g[off[u] + eo[j]] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      if (off[u] < 0) continue;
      double* at = acc + stype[r0 + u * SC_WARPS] * ne;
#pragma unroll
      for (int j = 0; j < EJ_MAX; ++j)
        if (live[j]) at[lane + 32 * j] += val[u][j];
    }
  }

  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 1. own pass: half-warp h takes x = h, h + 2 SC_WARPS, ... of the tile
  for (int xl0 = 0; xl0 < XT; xl0 += 2 * SC_WARPS) {
    const int xl = xl0 + tid / OWN_LANES;
    const int kl = tid % OWN_LANES;
    double s[3] = {0.0, 0.0, 0.0};
    double v[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (xl < nx) {
      const double* gx = sg + xl * run;
#pragma unroll 4
      for (int k = kl; k < K; k += OWN_LANES) {
        const double g0 = gx[k * 3], g1 = gx[k * 3 + 1], g2 = gx[k * 3 + 2];
        const double d0 = sd[k * 3], d1 = sd[k * 3 + 1], d2 = sd[k * 3 + 2];
        s[0] += g0;
        s[1] += g1;
        s[2] += g2;
        v[0] += d0 * g0;     // xx
        v[1] += d1 * g1;     // yy
        v[2] += d2 * g2;     // zz
        v[3] += d1 * g2;     // yz
        v[4] += d0 * g2;     // xz
        v[5] += d0 * g1;     // xy
      }
    }
    for (int off = OWN_LANES / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
#pragma unroll
      for (int q = 0; q < 6; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
    }
    if (kl == 0 && xl < XT) {
#pragma unroll
      for (int q = 0; q < 3; ++q) srow[xl * 3 + q] = s[q];
#pragma unroll
      for (int q = 0; q < 6; ++q) svir[q * XT + xl] = v[q];
    }
  }
  __syncthreads();

  // 3. force rows along x, and the virial partial
  const int tn = types[n];
  for (int e = tid; e < 3 * T * XT; e += SC_THREADS) {
    const int xl = e % XT;
    const int t = (e / XT) % T;
    const int d = e / (XT * T);
    if (xl >= nx) continue;
    double scat = 0.0;
    for (int w = 0; w < SC_WARPS; ++w)
      scat += sacc[(w * T + t) * ne + xl * 3 + d];
    const double rows = t == tn ? srow[xl * 3 + d] : 0.0;
    force[((n * 3 + d) * T + t) * X + x0 + xl] = rows - scat;
  }
  for (int e = tid; e < 6 * XT; e += SC_THREADS) {
    const int xl = e % XT;
    if (xl < nx) vpart[(n * 6 + e / XT) * X + x0 + xl] = svir[e];
  }
}

// virial[c, v, t, x] = -sum over the config's atoms n of type t of
// vpart[n, v, x]: one block per (c, v, t, 32 columns x); warp w sums the
// atoms w, w + VR_WARPS, ... in order, then the warps' sums add in warp
// order.
__global__ void __launch_bounds__(VR_WARPS * 32)
    scatter_virial_kernel(const double* __restrict__ vpart,
                          const int* __restrict__ types, int A, int X,
                          int T, double* __restrict__ virial) {
  __shared__ double part[VR_WARPS][32];
  const int nxb = (X + 31) / 32;
  const long long b = blockIdx.x;
  const int xb = static_cast<int>(b % nxb);
  const int t = static_cast<int>((b / nxb) % T);
  const int v = static_cast<int>((b / (static_cast<long long>(nxb) * T)) % 6);
  const long long c = b / (6LL * T * nxb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = xb * 32 + lane;
  double acc = 0.0;
  if (x < X) {
#pragma unroll 4
    for (int i = warp; i < A; i += VR_WARPS) {
      const long long ni = c * A + i;
      if (types[ni] == t) acc += vpart[(ni * 6 + v) * X + x];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && x < X) {
    double sum = 0.0;
    for (int w = 0; w < VR_WARPS; ++w) sum += part[w][lane];
    virial[((c * 6 + v) * T + t) * X + x] = -sum;
  }
}

}  // namespace

// g (C, A, X, K, 3) f64, disp (C, A, K, 3) f64, vmask (C, A, K) u8,
// rev (C, A, R) i32, types (C, A) i32; x-tile XT (a power of two, 1 to
// XT_MAX); scratch vpart (C, A, 6, X) f64.  Writes force
// (C, A, 3, T, X) and virial (C, 6, T, X).
extern "C" int pair_scatter_rows(const double* g, const double* disp,
                                 const unsigned char* vmask, const int* rev,
                                 const int* types, int C, int A, int X,
                                 int K, int R, int T, int XT, double* vpart,
                                 double* force, double* virial,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (XT < 1 || XT > XT_MAX || (XT & (XT - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long natoms = static_cast<long long>(C) * A;
  if (natoms == 0 || X == 0) return 0;
  const long long nxt = (X + XT - 1) / XT;
  const size_t smem = sizeof(double) * (3 * K * (XT + 1) +
                                        SC_WARPS * T * 3 * XT + 9 * XT) +
                      (sizeof(long long) + sizeof(int)) * R;
  int err = fs_allow_smem(scatter_rows_kernel, smem);
  if (err) return err;
  scatter_rows_kernel<<<static_cast<unsigned>(natoms * nxt), SC_THREADS,
                        smem, st>>>(g, disp, vmask, rev, types, A, X, K, R,
                                    T, XT, force, vpart);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long vblocks = static_cast<long long>(C) * 6 * T *
                            ((X + 31) / 32);
  scatter_virial_kernel<<<static_cast<unsigned>(vblocks), VR_WARPS * 32, 0,
                          st>>>(vpart, types, A, X, T, virial);
  return static_cast<int>(cudaGetLastError());
}
