// The pair-grid kernels of the NN solver's cached mode: K9 nn_ut_b, K11
// nn_pair_force and its transpose K11T nn_pair_force_t.
//
// Every monomial of the U expansion factors on the pair grid as
// T1[d] T2[e], T1[d] = ar^p[d] ai^q[d] and T2[e] = br^p[e] bi^q[e] over the
// n_t exponent pairs of degree <= twojmax (28 at twojmax 6).
//
// K9 nn_ut_b: per atom, wg[d, e] = sum_k w T1[d] T2[e], then
//   ut = wg . Lg + the self term and B by the trilinear CG contraction of ut.
//   Replaces fitsnap_tpu/ops/snap.py `compute_utot_mono` (+ `_grid_tensors`,
//   `bispectrum_from_utot`, `nn_ut_b`): the TPU form builds T1, T2 of every
//   pair in HBM with one-hot GEMMs and maps wg through the dense Lg.
// K11 nn_pair_force: per pair, from the atom's grid cotangent vg,
//   sp = T1 . vg . T2, st_c = T1t_c . vg . T2 + T1 . vg . T2t_c and
//   g_c = w st_c + wt_c sp (T1t, T2t, wt: tangents along displacement c).
//   Replaces fitsnap_tpu/ops/snap.py `nn_grid_pair` + `nn_pair_force`, which
//   materialize the grid tensors and their tangents in HBM every step.
// K11T nn_pair_force_t: the transpose, the cotangent of vg from that of the
//   forces gF: per pair gh = gF[a] - gF[jidx[a, k]] (the force gather's
//   transpose, as in K12T), s = sum_c gh_c wt_c, h_c = gh_c w, and
//   vgc[d, e] = sum_k T1[d] (s T2[e] + h . T2t[e]) + (h . T1t[d]) T2[e].
//   What JAX's autodiff takes through the same lines for the force loss.
//
// Bound on the H100: K11 and K11T by operations (about 4 n_t^2 and 2 n_t^2
// multiply-adds per pair, 6.3 / 3.1 kflop at twojmax 6, against 24 bytes of
// displacement); K9 by operations too (n_t^2 per pair).
//
// Design: one block per atom; the pair prologue and its tangents are
// computed once per pair in closed form (prologue.cuh, as K1) and the grid
// tensors never reach HBM.  The neighbors go in chunks of CHUNK pairs: one
// thread per pair forms the chunk's prologues into shared memory at once
// (the dual-number prologue, with its tan, sqrt and cos, is the longest
// serial step).  K9 and K11T then walk the chunk in tiles of TILE pairs:
// the tile's grid vectors go to shared memory, and each thread owns entries
// (d, e) of the shared grid accumulator, which it updates pair by pair in
// neighbor order.  K11 keeps vg in shared memory and gives each pair to one
// warp: lanes build the grid vectors, then each lane contracts columns e of
// vg and the warp reduces with shuffles in a fixed tree.  A pair whose
// weight and weight tangents are all zero (masked, or past the SNAP cutoff)
// adds exactly nothing, so K11 skips it and K9 and K11T skip a tile of such
// pairs: the lists are nearest first, and about a third of the slots of
// the Ta set's minibatch are live.  No atomics: a run repeats bit for bit.  ut = wg . Lg reads Lg as a column CSR table (1,835
// nonzeros of 784 x 280 at twojmax 6).
#include "common.cuh"
#include "prologue.cuh"

namespace {

constexpr int GRID_THREADS = 256;  // K9, K11T
constexpr int CHUNK = 128;         // pairs whose prologues form at once
constexpr int TILE = 16;           // pairs per tile of K9, K11T
constexpr int FORCE_WARPS = 8;     // K11: pairs in flight per block
constexpr int DUALS = 20;          // ar, ai, br, bi, w: value + 3 tangents

__device__ __forceinline__ double ipow(double x, int n) {
  double v = 1.0;
  for (int i = 0; i < n; ++i) v *= x;
  return v;
}

// d(x^n)/dc = n x^(n-1) dx/dc.
__device__ __forceinline__ double ipow_tan(double x, int n, double dx) {
  return n == 0 ? 0.0 : static_cast<double>(n) * ipow(x, n - 1) * dx;
}

__device__ void pair_duals(const double* __restrict__ disp,
                           const int* __restrict__ jelem,
                           const unsigned char* __restrict__ mask, int ie,
                           const double* __restrict__ elem, const Scalars& s,
                           long long pk, double* o) {
  Dual out[5];
  prologue(disp[pk * 3], disp[pk * 3 + 1], disp[pk * 3 + 2], mask[pk] != 0,
           ie, jelem[pk], elem, s, out);
  for (int v = 0; v < 5; ++v) {
    o[4 * v] = out[v].v;
    for (int c = 0; c < 3; ++c) o[4 * v + 1 + c] = out[v].d[c];
  }
}

// The duals of pairs pk0 .. pk0 + n - 1 of one atom, one thread per pair,
// into rows of `stride` doubles; the rows up to CHUNK past n are zeroed (a
// zero weight: such a pair adds nothing).
__device__ void chunk_duals(const double* __restrict__ disp,
                           const int* __restrict__ jelem,
                           const unsigned char* __restrict__ mask, int ie,
                           const double* __restrict__ elem, const Scalars& s,
                           long long pk0, int n, double* pro, int stride) {
  for (int i = threadIdx.x; i < CHUNK; i += blockDim.x) {
    double* o = pro + i * stride;
    if (i < n) {
      pair_duals(disp, jelem, mask, ie, elem, s, pk0 + i, o);
    } else {
      for (int v = 0; v < stride; ++v) o[v] = 0.0;
    }
  }
}

// True when every pair of a tile of `stride`-double dual rows has zero
// weight (and, with `tangents`, zero weight tangents): the tile adds nothing.
__device__ __forceinline__ bool dead_tile(const double* tp, int stride,
                                          bool tangents) {
  for (int pr = 0; pr < TILE; ++pr) {
    const double* o = tp + pr * stride;
    if (o[16] != 0.0) return false;
    if (tangents && (o[17] != 0.0 || o[18] != 0.0 || o[19] != 0.0))
      return false;
  }
  return true;
}

// Grid entries at exponents (p, q) of one pair from its duals o: T1, T2
// and their tangents T1t[c], T2t[c].
__device__ __forceinline__ void grid_entry(const double* o, int p, int q,
                                           double& t1, double t1t[3],
                                           double& t2, double t2t[3]) {
  const double ar = o[0], ai = o[4], br = o[8], bi = o[12];
  const double pa = ipow(ar, p), pai = ipow(ai, q);
  const double pb = ipow(br, p), pbi = ipow(bi, q);
  t1 = pa * pai;
  t2 = pb * pbi;
  for (int c = 0; c < 3; ++c) {
    t1t[c] = ipow_tan(ar, p, o[1 + c]) * pai + pa * ipow_tan(ai, q, o[5 + c]);
    t2t[c] = ipow_tan(br, p, o[9 + c]) * pbi + pb * ipow_tan(bi, q, o[13 + c]);
  }
}

__global__ void __launch_bounds__(GRID_THREADS) nn_ut_b_kernel(
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, int K, int n_t,
    const int* __restrict__ pidx, const int* __restrict__ qidx,
    const int* __restrict__ lgc_ptr, const int* __restrict__ lgc_row,
    const double* __restrict__ lgc_val, int two_u,
    const double* __restrict__ selfvec, const int* __restrict__ bt_ptr,
    const int* __restrict__ bt_i1, const int* __restrict__ bt_i2,
    const int* __restrict__ bt_i3, const double* __restrict__ bt_c, int W,
    const double* __restrict__ bzero, double* __restrict__ ut,
    double* __restrict__ B) {
  extern __shared__ double sm[];
  const int nt2 = n_t * n_t;
  double* wg = sm;                    // [n_t^2] grid accumulator
  double* pro = wg + nt2;             // [CHUNK][DUALS]
  double* t1 = pro + CHUNK * DUALS;   // [TILE][n_t]
  double* t2 = t1 + TILE * n_t;       // [TILE][n_t]
  double* su = t2 + TILE * n_t;       // [2U] this atom's ut
  const long long a = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < nt2; i += blockDim.x) wg[i] = 0.0;
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
    const int nc = min(CHUNK, K - c0);
    chunk_duals(disp, jelem, mask, ielem[a], elem, s, a * K + c0, nc, pro,
                DUALS);
    __syncthreads();
    for (int k0 = 0; k0 < nc; k0 += TILE) {
      const double* tp = pro + k0 * DUALS;
      if (dead_tile(tp, DUALS, false)) continue;
      for (int i = tid; i < TILE * n_t; i += blockDim.x) {
        const double* o = tp + (i / n_t) * DUALS;
        const int d = i % n_t;
        t1[i] = ipow(o[0], pidx[d]) * ipow(o[4], qidx[d]);
        t2[i] = ipow(o[8], pidx[d]) * ipow(o[12], qidx[d]);
      }
      __syncthreads();
      for (int i = tid; i < nt2; i += blockDim.x) {
        const int d = i / n_t, e = i % n_t;
        double acc = wg[i];
        for (int pr = 0; pr < TILE; ++pr)
          acc += tp[pr * DUALS + 16] * t1[pr * n_t + d] * t2[pr * n_t + e];
        wg[i] = acc;
      }
      __syncthreads();
    }
  }
  const int U = two_u / 2;
  for (int u = tid; u < two_u; u += blockDim.x) {
    double acc = 0.0;
    for (int q = lgc_ptr[u]; q < lgc_ptr[u + 1]; ++q)
      acc += wg[lgc_row[q]] * lgc_val[q];
    acc += selfvec[u];
    su[u] = acc;
    ut[a * two_u + u] = acc;
  }
  __syncthreads();
  for (int t = tid; t < W; t += blockDim.x) {
    double acc = 0.0;
    for (int q = bt_ptr[t]; q < bt_ptr[t + 1]; ++q) {
      const int i1 = bt_i1[q], i2 = bt_i2[q], i3 = bt_i3[q];
      const double a_r = su[i1], a_i = su[U + i1];
      const double b_r = su[i2], b_i = su[U + i2];
      const double ab_r = a_r * b_r - a_i * b_i;
      const double ab_i = a_r * b_i + a_i * b_r;
      acc += (ab_r * su[i3] + ab_i * su[U + i3]) * bt_c[q];
    }
    if (bzero != nullptr) acc -= bzero[t];
    B[a * W + t] = acc;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(FORCE_WARPS * 32) nn_pair_force_kernel(
    const double* __restrict__ vg, const double* __restrict__ disp,
    const int* __restrict__ jelem, const unsigned char* __restrict__ mask,
    const int* __restrict__ ielem, const double* __restrict__ elem,
    Scalars s, int K, int n_t, const int* __restrict__ pidx,
    const int* __restrict__ qidx, double* __restrict__ g) {
  extern __shared__ double sm[];
  const int nt2 = n_t * n_t;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double* svg = sm;                                   // [n_t^2]
  double* pros = svg + nt2;                           // [CHUNK][DUALS]
  double* T1 = pros + CHUNK * DUALS + warp * 8 * n_t; // this warp's pair
  double* T1t = T1 + n_t;                             // [3][n_t]
  double* T2 = T1t + 3 * n_t;                         // [n_t]
  double* T2t = T2 + n_t;                             // [3][n_t]
  const long long a = blockIdx.x;
  for (int i = threadIdx.x; i < nt2; i += blockDim.x) svg[i] = vg[a * nt2 + i];
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
  const int nc = min(CHUNK, K - c0);
  chunk_duals(disp, jelem, mask, ielem[a], elem, s, a * K + c0, nc, pros,
              DUALS);
  __syncthreads();
  for (int kk = warp; kk < nc; kk += FORCE_WARPS) {
    const long long pk = a * K + c0 + kk;
    const double* pro = pros + kk * DUALS;
    if (pro[16] == 0.0 && pro[17] == 0.0 && pro[18] == 0.0 &&
        pro[19] == 0.0) {
      if (lane < 3) g[pk * 3 + lane] = 0.0;
      continue;
    }
    for (int d = lane; d < n_t; d += 32) {
      double t1t[3], t2t[3];
      grid_entry(pro, pidx[d], qidx[d], T1[d], t1t, T2[d], t2t);
      for (int c = 0; c < 3; ++c) {
        T1t[c * n_t + d] = t1t[c];
        T2t[c * n_t + d] = t2t[c];
      }
    }
    __syncwarp();
    double sp = 0.0, st[3] = {0.0, 0.0, 0.0};
    for (int e = lane; e < n_t; e += 32) {
      double tmp = 0.0, m[3] = {0.0, 0.0, 0.0};
      for (int d = 0; d < n_t; ++d) {
        const double v = svg[d * n_t + e];
        tmp += T1[d] * v;
        for (int c = 0; c < 3; ++c) m[c] += T1t[c * n_t + d] * v;
      }
      sp += tmp * T2[e];
      for (int c = 0; c < 3; ++c) st[c] += m[c] * T2[e] + tmp * T2t[c * n_t + e];
    }
    sp = warp_sum(sp);
    for (int c = 0; c < 3; ++c) st[c] = warp_sum(st[c]);
    if (lane == 0) {
      for (int c = 0; c < 3; ++c)
        g[pk * 3 + c] = pro[16] * st[c] + pro[17 + c] * sp;
    }
    __syncwarp();
  }
  __syncthreads();
  }
}

__global__ void __launch_bounds__(GRID_THREADS) nn_pair_force_t_kernel(
    const double* __restrict__ gF, const int* __restrict__ jidx,
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, int A, int K, int n_t,
    const int* __restrict__ pidx, const int* __restrict__ qidx,
    double* __restrict__ vgc) {
  extern __shared__ double sm[];
  const int nt2 = n_t * n_t;
  constexpr int PRO = DUALS + 4;      // duals, then s and h[3]
  double* acc = sm;                   // [n_t^2]
  double* pros = acc + nt2;           // [CHUNK][PRO]
  double* vec = pros + CHUNK * PRO;   // [TILE][4][n_t]: T1, Y, X, T2
  const long long a = blockIdx.x;
  const long long first = (a / A) * A;
  const int tid = threadIdx.x;
  for (int i = tid; i < nt2; i += blockDim.x) acc[i] = 0.0;
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
  const int nc = min(CHUNK, K - c0);
  chunk_duals(disp, jelem, mask, ielem[a], elem, s, a * K + c0, nc, pros,
              PRO);
  for (int i = tid; i < nc; i += blockDim.x) {
    double* o = pros + i * PRO;
    const long long j = first + jidx[a * K + c0 + i];
    double sc = 0.0;
    for (int c = 0; c < 3; ++c) {
      const double gh = gF[a * 3 + c] - gF[j * 3 + c];
      sc += gh * o[17 + c];
      o[DUALS + 1 + c] = gh * o[16];
    }
    o[DUALS] = sc;
  }
  __syncthreads();
  for (int k0 = 0; k0 < nc; k0 += TILE) {
    const double* tp = pros + k0 * PRO;
    if (dead_tile(tp, PRO, true)) continue;
    for (int i = tid; i < TILE * n_t; i += blockDim.x) {
      const int pr = i / n_t, d = i % n_t;
      const double* o = tp + pr * PRO;
      double t1, t2, t1t[3], t2t[3];
      grid_entry(o, pidx[d], qidx[d], t1, t1t, t2, t2t);
      const double* h = o + DUALS + 1;
      double* v = vec + pr * 4 * n_t;
      v[d] = t1;
      v[n_t + d] = h[0] * t1t[0] + h[1] * t1t[1] + h[2] * t1t[2];
      v[2 * n_t + d] =
          o[DUALS] * t2 + h[0] * t2t[0] + h[1] * t2t[1] + h[2] * t2t[2];
      v[3 * n_t + d] = t2;
    }
    __syncthreads();
    for (int i = tid; i < nt2; i += blockDim.x) {
      const int d = i / n_t, e = i % n_t;
      double sum = acc[i];
      for (int pr = 0; pr < TILE; ++pr) {
        const double* v = vec + pr * 4 * n_t;
        sum += v[d] * v[2 * n_t + e] + v[n_t + d] * v[3 * n_t + e];
      }
      acc[i] = sum;
    }
    __syncthreads();
  }
  }
  for (int i = tid; i < nt2; i += blockDim.x) vgc[a * nt2 + i] = acc[i];
}

Scalars scalars(double rcutfac, double rfac0, double rmin0, int switchflag,
                int switchinnerflag) {
  Scalars s;
  s.rcutfac = rcutfac;
  s.rfac0 = rfac0;
  s.rmin0 = rmin0;
  s.switchflag = switchflag;
  s.switchinnerflag = switchinnerflag;
  return s;
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) u8, ielem (N,) i32, elem
// (nelem, 4); the grid exponents pidx, qidx (n_t,) i32; Lg by column
// (lgc_ptr (2U + 1,), lgc_row, lgc_val); selfvec (2U,); the B terms by
// descriptor (bt_ptr (W + 1,), bt_i1, bt_i2, bt_i3, bt_c); bzero (W,) or
// null.  Writes ut (N, 2U) and B (N, W).
extern "C" int nn_ut_b(const double* disp, const int* jelem,
                       const unsigned char* mask, const int* ielem,
                       const double* elem, double rcutfac, double rfac0,
                       double rmin0, int switchflag, int switchinnerflag,
                       long long natoms, int K, int n_t, const int* pidx,
                       const int* qidx, const int* lgc_ptr,
                       const int* lgc_row, const double* lgc_val, int two_u,
                       const double* selfvec, const int* bt_ptr,
                       const int* bt_i1, const int* bt_i2, const int* bt_i3,
                       const double* bt_c, int W, const double* bzero,
                       double* ut, double* B, void* stream) {
  const size_t smem = sizeof(double) *
      (n_t * n_t + CHUNK * DUALS + 2 * TILE * n_t + two_u);
  const int err = fs_allow_smem(nn_ut_b_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_ut_b_kernel<<<static_cast<unsigned>(natoms), GRID_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), K, n_t,
        pidx, qidx, lgc_ptr, lgc_row, lgc_val, two_u, selfvec, bt_ptr, bt_i1,
        bt_i2, bt_i3, bt_c, W, bzero, ut, B);
  }
  return static_cast<int>(cudaGetLastError());
}

// vg (N, n_t, n_t) f64 and the pairs as nn_ut_b's.  Writes g (N, K, 3).
extern "C" int nn_pair_force(const double* vg, const double* disp,
                             const int* jelem, const unsigned char* mask,
                             const int* ielem, const double* elem,
                             double rcutfac, double rfac0, double rmin0,
                             int switchflag, int switchinnerflag,
                             long long natoms, int K, int n_t,
                             const int* pidx, const int* qidx, double* g,
                             void* stream) {
  const size_t smem = sizeof(double) *
      (n_t * n_t + CHUNK * DUALS + FORCE_WARPS * 8 * n_t);
  const int err = fs_allow_smem(nn_pair_force_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_pair_force_kernel<<<static_cast<unsigned>(natoms), FORCE_WARPS * 32,
                           smem, static_cast<cudaStream_t>(stream)>>>(
        vg, disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), K, n_t,
        pidx, qidx, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// gF (N, 3) f64 (N = configs x A atoms), jidx (N, K) i32 (atom index within
// the config of A atoms), the pairs as nn_ut_b's.  Writes vgc (N, n_t, n_t).
extern "C" int nn_pair_force_t(const double* gF, const int* jidx,
                               const double* disp, const int* jelem,
                               const unsigned char* mask, const int* ielem,
                               const double* elem, double rcutfac,
                               double rfac0, double rmin0, int switchflag,
                               int switchinnerflag, long long natoms, int A,
                               int K, int n_t, const int* pidx,
                               const int* qidx, double* vgc, void* stream) {
  const size_t smem = sizeof(double) *
      (n_t * n_t + CHUNK * (DUALS + 4) + 4 * TILE * n_t);
  const int err = fs_allow_smem(nn_pair_force_t_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_pair_force_t_kernel<<<static_cast<unsigned>(natoms), GRID_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        gF, jidx, disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), A, K,
        n_t, pidx, qidx, vgc);
  }
  return static_cast<int>(cudaGetLastError());
}
