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
// Bound on the H100: K9, K11 and K11T by operations per pair (about n_t^2,
// 4 n_t^2 and 2 n_t^2 multiply-adds per live pair, 6.3 / 3.1 kflop for K11
// / K11T at twojmax 6, against 24 bytes of displacement).  At the NN
// minibatch of 4 x 128 x 64 (9,202 live pairs) K11T's bound is 1.3 us, by
// its bytes (the n_t^2 grid cotangent it writes an atom), and its
// operations take about as long at the FP64 vector rate.
//
// Design of K9 and K11: one block per atom; the pair prologue and its
// tangents are computed once per pair in closed form (prologue.cuh, as K1)
// and the grid tensors never reach HBM.  The neighbors go in chunks of
// CHUNK pairs: one thread per pair forms the chunk's prologues into shared
// memory at once (the dual-number prologue, with its tan, sqrt and cos, is
// the longest serial step).  K9 then walks the chunk in tiles of TILE
// pairs: the tile's grid vectors go to shared memory, and each thread owns
// entries (d, e) of the shared grid accumulator, which it updates pair by
// pair in neighbor order.  K11 keeps vg in shared memory and gives each
// pair to one warp: lanes build the grid vectors, then each lane contracts
// columns e of vg and the warp reduces with shuffles in a fixed tree.  A
// pair whose weight and weight tangents are all zero (masked, or past the
// SNAP cutoff) adds exactly nothing, so K11 skips it and K9 skips a tile of
// such pairs: the lists are nearest first, and about a third of the slots
// of the Ta set's minibatch are live.  ut = wg . Lg reads Lg as a column
// CSR table (1,835 nonzeros of 784 x 280 at twojmax 6).
//
// Design of K11T: one block per atom, four warps up to twojmax 7 (more
// beyond, a warp to four output tiles).  Its time is one block's chain of
// dependent steps, not its bytes or operations, so each step is kept
// short.  (1) one block-wide scan lists the atom's masked slots in neighbor
// order (holes allowed), and a padded atom writes its zeros and returns; the
// first chunk's inputs (displacement, cutoff, weight, gh) are staged in
// shared memory on the way, a thread's first slot read ahead in the shadow
// of the mask's load and the scan; (2) the listed pairs' prologues go one a
// thread, in closed form (prologue_t: shared reciprocals where the dual
// numbers divide about twenty times), and a second scan keeps the pairs with
// a nonzero weight or weight tangent (the rest add exactly nothing), writing
// for each s, the four h.dx and the power tables of ar, ai, br, bi (a
// running product) into shared memory, in neighbor order; (3) vgc is the
// product A B of the n_t x 2L matrix A of the L live pairs' columns T1, Y =
// h.T1t and the 2L x n_t matrix B of their rows X = s T2 + h.T2t, T2: for
// k-tiles of FT_PAIRS pairs, the threads build the vectors from the tables
// (a few FMAs an entry, zero past n_t and past the live pairs) and each warp
// multiplies its 16 x 8 output tiles on the FP64 tensor cores (mma.sync
// m16n8k8, atom_gemm.cuh), the accumulators in registers; (4) the warps
// store their tiles.  A register-blocked FMA accumulation (each thread 4 x 8
// entries, groups of lanes over disjoint pairs, partial grids summed in
// shared memory) was slower at the NN minibatch: its FMA chains and shared
// loads set it.  No atomics, and every output one chain of tensor-core steps
// in neighbor order: a run repeats bit for bit.
#include "atom_gemm.cuh"
#include "common.cuh"
#include "prologue.cuh"

namespace {

constexpr int GRID_THREADS = 256;  // K9
constexpr int CHUNK = 128;         // pairs whose prologues form at once
constexpr int TILE = 16;           // pairs per tile of K9
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
// weight: the tile adds nothing to K9's grid.
__device__ __forceinline__ bool dead_tile(const double* tp, int stride) {
  for (int pr = 0; pr < TILE; ++pr)
    if (tp[pr * stride + 16] != 0.0) return false;
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
      if (dead_tile(tp, DUALS)) continue;
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

// K11T.  Exclusive prefix sum of one int a thread over the block (a
// multiple of 32 threads), the block's total in `total`; `ws` holds 33
// ints.  Every thread calls it; the caller puts a barrier between two calls
// (the first call's reads of ws against the second's writes).
__device__ int block_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int x = v;
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? ws[lane] : 0;
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) ws[lane] = w;
    if (lane == nw - 1) ws[32] = w;
  }
  __syncthreads();
  total = ws[32];
  return (warp > 0 ? ws[warp - 1] : 0) + x - v;
}

// A masked pair's inputs to K11T, staged in shared memory: its
// displacement, its cutoff rcut_ij, its neighbor's weight wj, the inner
// switching function's centre and half-width, and gh = gF[a] - gF[j].
constexpr int FT_STAGE = 10;

// Reads a masked pair pk's staged inputs; ei is its atom's row of elem.
__device__ __forceinline__ void ft_load(
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const int* __restrict__ jidx, const double* __restrict__ gF,
    const double* __restrict__ elem, const Scalars& s, const double ei[4],
    long long a, long long first, long long pk, double st[FT_STAGE]) {
  const int je = jelem[pk];
  const long long j = first + jidx[pk];
  for (int c = 0; c < 3; ++c) st[c] = disp[pk * 3 + c];
  st[3] = (ei[0] + elem[je * 4]) * s.rcutfac;
  st[4] = elem[je * 4 + 1];
  st[5] = s.switchinnerflag ? 0.5 * (ei[2] + elem[je * 4 + 2]) : 0.0;
  st[6] = s.switchinnerflag ? 0.5 * (ei[3] + elem[je * 4 + 3]) : 0.0;
  for (int c = 0; c < 3; ++c) st[7 + c] = gF[a * 3 + c] - gF[j * 3 + c];
}

// K11T's prologue of a masked pair from its staged inputs: the values (ar,
// ai, br, bi, w) of `prologue` (prologue.cuh) with their tangents along
// the three displacement axes in closed form, sharing 1 / r, 1 / tan and
// one rsqrt where the dual numbers divide about twenty times.
__device__ void prologue_t(const double st[FT_STAGE], const Scalars& s,
                           double v[5], double t[5][3]) {
  const double dx = st[0], dy = st[1], dz = st[2], rcutij = st[3];
  const double dd[3] = {dx, dy, dz};
  const double r = sqrt(dx * dx + dy * dy + dz * dz);
  const double rinv = 1.0 / r;
  const double span = rcutij - s.rmin0;
  const double kth = s.rfac0 * M_PI / span;      // d theta0 / dr
  const double tn = tan((r - s.rmin0) * kth);
  const double itn = 1.0 / tn;
  const double z0 = r * itn;
  const double r0inv = rsqrt(r * r + z0 * z0);
  const double r0i3 = r0inv * r0inv * r0inv;
  v[0] = r0inv * z0;
  v[1] = -(r0inv * dz);
  v[2] = r0inv * dy;
  v[3] = -(r0inv * dx);
  double sf = 1.0, dsf = 0.0;                    // dsf: d sfac / dr
  if (s.switchflag && r > s.rmin0) {
    if (r > rcutij) {
      sf = 0.0;
    } else {
      const double rscale = M_PI / span;
      double sn, cs;
      sincos((r - s.rmin0) * rscale, &sn, &cs);
      sf = 0.5 * (cs + 1.0);
      dsf = -0.5 * sn * rscale;
    }
  }
  if (s.switchinnerflag) {
    const double sin_ij = st[5], din_ij = st[6];
    double inner = 1.0, dinner = 0.0;
    if (r <= sin_ij - din_ij) {
      inner = 0.0;
    } else if (r < sin_ij + din_ij) {
      const double karg = 0.5 * M_PI / din_ij;
      const double arg = (r - sin_ij) * karg;
      double sn, cs;
      sincos(fmin(fmax(arg, -0.5 * M_PI), 0.5 * M_PI) + 0.5 * M_PI, &sn,
             &cs);
      inner = 0.5 * (1.0 - cs);
      dinner = fabs(arg) > 0.5 * M_PI ? 0.0 : 0.5 * sn * karg;
    }
    dsf = dsf * inner + sf * dinner;
    sf *= inner;
  }
  const double wj = st[4];
  v[4] = sf * wj;
  for (int c = 0; c < 3; ++c) {
    const double dr = dd[c] * rinv;
    const double dtn = (1.0 + tn * tn) * kth * dr;
    const double dz0 = (dr - z0 * dtn) * itn;
    const double dr0 = -r0i3 * (r * dr + z0 * dz0);
    t[0][c] = dr0 * z0 + r0inv * dz0;
    t[1][c] = -(dr0 * dz + (c == 2 ? r0inv : 0.0));
    t[2][c] = dr0 * dy + (c == 1 ? r0inv : 0.0);
    t[3][c] = -(dr0 * dx + (c == 0 ? r0inv : 0.0));
    t[4][c] = dsf * dr * wj;
  }
}

// A live pair's record in shared memory: s, h . dar, h . dai, h . dbr,
// h . dbi (dx: the tangents of x along the three displacement axes), then
// the power tables of ar, ai, br, bi, each 0, x^0, .., x^twojmax, so that
// x^n sits at [n + 1] and n x^(n-1) = n [n] holds at n = 0 too.
constexpr int FT_REC = 5;
constexpr int FT_CHUNK = 128;      // masked pairs whose prologues form at once
constexpr int FT_PAIRS = 16;       // live pairs a k-tile of the product
constexpr int FT_TILES = 4;        // output tiles of a warp, at most

// Masked pairs whose prologues form at once: one a thread, at most
// FT_CHUNK or K.
__host__ __device__ __forceinline__ int ft_chunk(int threads, int K) {
  return min(threads, min(FT_CHUNK, K));
}

// The grid's padding: mp rows (m-tiles of 16), np columns (n-tiles of 8),
// and the k-tile's row strides, 4 mod 16 doubles so that a half-warp's
// fragment loads fall in 16 different double-wide banks.
struct FtShape {
  int mp, np, lda, ldb, tiles;
  __host__ __device__ explicit FtShape(int n_t)
      : mp((n_t + 15) / 16 * 16), np((n_t + 7) / 8 * 8),
        lda(mp + 4), ldb(np + 4 + (np % 16 == 8 ? 8 : 0)),
        tiles((mp / 16) * (np / 8)) {}
};

template <int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nn_pair_force_t_kernel(
    const double* __restrict__ gF, const int* __restrict__ jidx,
    const double* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const double* __restrict__ elem, Scalars s, int A, int K, int n_t,
    int twojmax, const int* __restrict__ pidx, const int* __restrict__ qidx,
    size_t work_doubles, double* __restrict__ vgc) {
  extern __shared__ double sm[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int nt2 = n_t * n_t;
  const int np1 = twojmax + 2;
  const int rec_len = FT_REC + 4 * np1;
  const int chunk = ft_chunk(T, K);
  const FtShape sh(n_t);
  double* rec = sm;                              // [chunk][rec_len]
  // a k-tile of the product vgc = A B: k-rows 2 j, 2 j + 1 of pair j are
  // T1, Y in at (A transposed, [2 FT_PAIRS][lda]) and X, T2 in bk
  // ([2 FT_PAIRS][ldb])
  double* at = rec + chunk * rec_len;
  double* bk = at + 2 * FT_PAIRS * sh.lda;
  double* stage = sm + work_doubles;             // [chunk][FT_STAGE]
  int* list = reinterpret_cast<int*>(stage + chunk * FT_STAGE);  // [K]
  int* ws = list + K;                                      // [33]
  const long long a = blockIdx.x;
  const long long first = (a / A) * A;
  double* out = vgc + a * nt2;

  // the masked slots in neighbor order: thread t counts slots
  // [t per, (t + 1) per), one scan places them, and the first chunk's
  // inputs are staged (a thread's first slot read ahead, in the shadow of
  // the mask and the scan)
  const int ie = ielem[a];
  double ei[4];
  for (int c = 0; c < 4; ++c) ei[c] = elem[ie * 4 + c];
  const int per = (K + T - 1) / T;
  const int k0 = min(K, tid * per), k1 = min(K, k0 + per);
  double ahead[FT_STAGE];
  if (k0 < k1)
    ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first, a * K + k0, ahead);
  int cnt = 0;
  for (int k = k0; k < k1; ++k) cnt += mask[a * K + k] != 0;
  int nm;
  int pos = block_scan(cnt, ws, nm);
  for (int k = k0; k < k1; ++k) {
    if (mask[a * K + k] == 0) continue;
    list[pos] = k;
    if (pos < chunk) {
      double* st = stage + pos * FT_STAGE;
      if (k == k0) {
        for (int v = 0; v < FT_STAGE; ++v) st[v] = ahead[v];
      } else {
        ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first, a * K + k, st);
      }
    }
    ++pos;
  }
  if (nm == 0) {                                 // a padded atom
    for (int i = tid; i < nt2; i += T) out[i] = 0.0;
    return;
  }
  __syncthreads();

  // warp w owns output tiles w, w + warps, ... (16 x 8 each), in registers
  const int lane = tid % 32, warp = tid / 32, warps = T / 32;
  const int g = lane / 4, tq = lane % 4;
  double acc[FT_TILES][4];
  int m0[FT_TILES], n0[FT_TILES];                // -1: no tile
  for (int i = 0; i < FT_TILES; ++i) {
    const int tt = warp + i * warps;
    m0[i] = tt < sh.tiles ? (tt / (sh.np / 8)) * 16 : -1;
    n0[i] = (tt % (sh.np / 8)) * 8;
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.0;
  }

  for (int c0 = 0; c0 < nm; c0 += chunk) {
    // one masked pair a thread: its prologue, then the live ones (nonzero
    // weight or weight tangent: the others add exactly nothing) are
    // written in neighbor order
    bool alive = false;
    double ab[4], r5[FT_REC];
    if (tid < min(chunk, nm - c0)) {
      double st[FT_STAGE];
      if (c0 == 0) {
        for (int u = 0; u < FT_STAGE; ++u) st[u] = stage[tid * FT_STAGE + u];
      } else {
        ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first,
                a * K + list[c0 + tid], st);
      }
      double v[5], t[5][3];
      prologue_t(st, s, v, t);
      alive = v[4] != 0.0 || t[4][0] != 0.0 || t[4][1] != 0.0
              || t[4][2] != 0.0;
      if (alive) {
        double h[3];
        r5[0] = 0.0;
        for (int c = 0; c < 3; ++c) {
          r5[0] += st[7 + c] * t[4][c];
          h[c] = st[7 + c] * v[4];
        }
        for (int u = 0; u < 4; ++u) {
          ab[u] = v[u];
          r5[1 + u] = h[0] * t[u][0] + h[1] * t[u][1] + h[2] * t[u][2];
        }
      }
    }
    int nl;
    const int slot = block_scan(alive ? 1 : 0, ws, nl);
    if (alive) {
      double* rr = rec + slot * rec_len;
      for (int v = 0; v < FT_REC; ++v) rr[v] = r5[v];
      double* pw = rr + FT_REC;
      for (int v = 0; v < 4; ++v) {
        double x = 1.0;
        pw[v * np1] = 0.0;
        for (int n = 0; n <= twojmax; ++n) {
          pw[v * np1 + n + 1] = x;
          x *= ab[v];
        }
      }
    }
    __syncthreads();
    for (int p0 = 0; p0 < nl; p0 += FT_PAIRS) {
      // the k-tile: pair j's grid vectors T1, Y = h . T1t, X = s T2 +
      // h . T2t and T2 from its tables, zero past the live pairs (and,
      // for the padding, past n_t)
      const int npr = min(FT_PAIRS, nl - p0);
      for (int d = lane; d < max(sh.mp, sh.np); d += 32) {
        const bool in = d < n_t;
        const int p = in ? pidx[d] : 0, q = in ? qidx[d] : 0;
        const double pd = p, qd = q;
        for (int j = warp; j < FT_PAIRS; j += warps) {
          double t1 = 0.0, y = 0.0, x = 0.0, t2 = 0.0;
          if (in && j < npr) {
            const double* rr = rec + (p0 + j) * rec_len;
            const double* pa = rr + FT_REC;
            const double* pai = pa + np1;
            const double* pb = pai + np1;
            const double* pbi = pb + np1;
            t1 = pa[p + 1] * pai[q + 1];
            t2 = pb[p + 1] * pbi[q + 1];
            y = pd * pa[p] * pai[q + 1] * rr[1]
                + qd * pa[p + 1] * pai[q] * rr[2];
            x = rr[0] * t2 + pd * pb[p] * pbi[q + 1] * rr[3]
                + qd * pb[p + 1] * pbi[q] * rr[4];
          }
          if (d < sh.mp) {
            at[2 * j * sh.lda + d] = t1;
            at[(2 * j + 1) * sh.lda + d] = y;
          }
          if (d < sh.np) {
            bk[2 * j * sh.ldb + d] = x;
            bk[(2 * j + 1) * sh.ldb + d] = t2;
          }
        }
      }
      __syncthreads();
      // vgc += A B over the tile's k-steps of 8 (4 pairs), in k order
      const int ksteps = (2 * npr + 7) / 8;
      for (int ks = 0; ks < ksteps; ++ks) {
        const double* ak = at + (8 * ks + tq) * sh.lda + g;
        const double* bq = bk + (8 * ks + tq) * sh.ldb + g;
        for (int i = 0; i < FT_TILES; ++i) {
          if (m0[i] < 0) break;
          double fa[4], fb[2];
          for (int h = 0; h < 2; ++h) {
            fa[2 * h] = ak[4 * h * sh.lda + m0[i]];
            fa[2 * h + 1] = ak[4 * h * sh.lda + m0[i] + 8];
            fb[h] = bq[4 * h * sh.ldb + n0[i]];
          }
          mma_f64(acc[i], fa, fb);
        }
      }
      __syncthreads();
    }
  }
  // the tiles (zero where no pair is live)
  for (int i = 0; i < FT_TILES; ++i) {
    if (m0[i] < 0) break;
    for (int h = 0; h < 2; ++h) {
      const int row = m0[i] + g + 8 * h;
      for (int c = 0; c < 2; ++c) {
        const int col = n0[i] + 2 * tq + c;
        if (row < n_t && col < n_t) out[row * n_t + col] = acc[i][2 * h + c];
      }
    }
  }
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
  int twojmax = 0;                     // n_t = (twojmax + 1)(twojmax + 2) / 2
  while ((twojmax + 1) * (twojmax + 2) / 2 < n_t) ++twojmax;
  if ((twojmax + 1) * (twojmax + 2) / 2 != n_t)
    return static_cast<int>(cudaErrorInvalidValue);
  // a warp a FT_TILES output tiles, at least four warps
  const FtShape sh(n_t);
  const int threads = max(128, (sh.tiles + FT_TILES - 1) / FT_TILES * 32);
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = ft_chunk(threads, K);
  const size_t work = static_cast<size_t>(chunk) * (FT_REC + 4 * (twojmax + 2))
                      + 2 * FT_PAIRS * (sh.lda + sh.ldb);
  const size_t smem = (work + static_cast<size_t>(chunk) * FT_STAGE)
                      * sizeof(double) + (K + 33) * sizeof(int);
  const auto kernel = threads > 256 ? nn_pair_force_t_kernel<1024, 1>
                                    : nn_pair_force_t_kernel<256, 2>;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        gF, jidx, disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), A, K,
        n_t, twojmax, pidx, qidx, work, vgc);
  }
  return static_cast<int>(cudaGetLastError());
}
