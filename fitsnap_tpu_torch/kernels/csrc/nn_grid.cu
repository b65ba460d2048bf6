// The pair-grid kernels of the NN solver's cached mode: K9 nn_ut_b, K11
// nn_pair_force and its transpose K11T nn_pair_force_t.
//
// Every monomial of the U expansion factors on the pair grid as
// T1[d] T2[e], T1[d] = ar^p[d] ai^q[d] and T2[e] = br^p[e] bi^q[e] over the
// n_t exponent pairs of degree <= twojmax (28 at twojmax 6).
//
// K9 nn_ut_b: per atom, wg[d, e] = sum_k w T1[d] T2[e], then
//   ut = wg . Lg + the self term and B by the trilinear CG contraction of ut.
//   Under chemflag one grid an element channel, wg[c] over the pairs whose
//   neighbor is of element c, and B over the nchem^3 channel triples.
//   Replaces fitsnap_tpu/ops/snap.py `compute_utot_mono` (both branches; +
//   `_grid_tensors`, `bispectrum_from_utot`, `nn_ut_b`): the TPU form builds
//   T1, T2 of every pair in HBM with one-hot GEMMs and maps wg through the
//   dense Lg.
// K11 nn_pair_force: per pair, from the atom's grid cotangent vg,
//   sp = T1 . vg . T2, st_c = T1t_c . vg . T2 + T1 . vg . T2t_c and
//   g_c = w st_c + wt_c sp (T1t, T2t, wt: tangents along displacement c);
//   the derivative of the atom's energy along the pair's displacement.
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
// / K11T at twojmax 6, against 24 bytes of displacement), K9 also by its B
// terms (about 12 flops each, 3,549 an atom at twojmax 6).  At the NN
// minibatch of 4 x 128 x 64 (9,202 live pairs) K11's and K11T's bounds are
// 1.5 and 1.3 us, by their bytes (the n_t^2 grid (co)tangent of an atom),
// and their operations take about as long at the FP64 vector rate.
//
// Design of K9, K11 and K11T: one block per atom.  Their time is one
// block's chain of dependent steps, not their bytes or operations, so each
// step is kept short.  (1) one block-wide scan lists the atom's masked
// slots in neighbor order (holes allowed; K11 writes the other slots'
// zeros on the way); a padded atom writes its zeros and returns (K9: its
// grid stays 0, so its ut is the self term and its B that of the self
// term); the first chunk's inputs (displacement, cutoff, weight, K11T's
// gh) are staged in shared memory on the way, a thread's first slot read
// ahead in the shadow of the mask's load and the scan (ft_list); (2) the
// listed pairs' prologues go one a thread, in closed form (prologue_t:
// shared reciprocals where the dual numbers divide about twenty times; K9
// the values alone), and a second scan keeps the live pairs (a nonzero
// weight, or for K11 and K11T a nonzero weight tangent; the rest add
// exactly nothing: K11 writes their zeros), writing their records and the
// power tables of ar, ai, br, bi (a running product) into shared memory,
// in neighbor order; (3) a product on the FP64 tensor cores (mma.sync
// m16n8k8, atom_gemm.cuh), its operands built from the tables (a few FMAs
// an entry, zero past n_t and past the live pairs), the accumulators in
// registers.
//   K9 (the block the B-term schedule sets, 256 threads at twojmax 6): wg
// is the product A B of the n_t x L matrix A of the L live pairs' columns
// w T1 and the L x n_t matrix B of their rows T2, over k-tiles of up to
// K9_PAIRS pairs staged in shared memory, the warps' output tiles kept in
// wg between chunks (in rounds where the tiles outnumber the warps); under
// chemflag the second scan places each channel's live pairs together, in
// neighbor order, and the product runs once a channel into its own grid.
// Then ut = wg . Lg + the self term, a thread a U column (Lg as a column
// CSR table, 1,835 nonzeros of 784 x 280 at twojmax 6, read through L2),
// and the B terms in a host-built schedule (ops/snap.py `deal`): each
// descriptor's terms dealt to segments of at most `per` (15 at twojmax 6,
// where a descriptor has up to 505 terms), one a thread, whose partial
// sums the descriptor adds in order.
//   K11T (four warps up to twojmax 7, a warp to four output tiles beyond;
// from twojmax 15, where that passes 1,024 threads, the tiles split over
// two or more blocks an atom, each repeating (1) and (2)):
// vgc is the product A B of the n_t x 2L matrix A of the L live pairs'
// columns T1, Y = h.T1t and the 2L x n_t matrix B of their rows X = s T2 +
// h.T2t, T2, over k-tiles of FT_PAIRS pairs staged in shared memory; then
// the warps store their 16 x 8 output tiles.  A register-blocked FMA
// accumulation (each thread 4 x 8 entries, groups of lanes over disjoint
// pairs, partial grids summed in shared memory) was slower at the NN
// minibatch: its FMA chains and shared loads set it.
//   K11 (four warps, or eight where the atoms fit one wave): vg goes to
// shared memory by asynchronous copies in the shadow of (1) and (2).  Each
// live pair's T1t_c = dar_c dT1/dar + dai_c dT1/dai, so its rows [T1;
// dT1/dar; dT1/dai] stack into X (3L rows; each entry one product of two
// of the pair's tables, the derivative tables n x^(n-1) written beside the
// powers) and Q = X vg is formed in m-tiles of FF_PAIRS pairs (16 rows),
// one warp a tile, each lane building its A fragments straight from the
// tables in registers (no staging, no barrier); each row's dot products
// with T2, dT2/dbr and dT2/dbi follow on the accumulators, each lane with
// the tables at its own columns, summed over the row's lanes by an xor
// butterfly, and then sp = Q_0 . T2, st_c = dar_c Q_1 . T2 + dai_c Q_2 . T2
// + dbr_c Q_0 . dT2/dbr + dbi_c Q_0 . dT2/dbi and g_c = w st_c + wt_c sp.
// X goes on vg's left (not [T2; T2t_c] on its right, the same work): its
// rows index pairs, so a warp's m-tile holds whole pairs and nothing
// crosses warps.  The three rows, not the four of [T1; T1t_c], save a
// quarter of the tensor-core steps and most of the operand arithmetic.
// A chunk holds as many records as the shared memory beside vg allows (all
// of a block's threads up to twojmax 12; fewer at 13 and 14, whose grids
// then run more chunks).  Every slot is written once: masked-out, dead and
// padded slots exactly 0.  No atomics, and every output a fixed chain of
// tensor-core steps and sums in neighbor order: a run repeats bit for bit.
//
// Float32 (the `_f32` entry points, the NN solver's float32 cached and OTF
// modes): every kernel is a template on the working type T, with the same
// list, prologue (at T: the scalars rounded to T once, as the JAX package's
// weakly typed Python floats are) and records.  No tensor-core type keeps
// float32's 24-bit mantissa (TF32 keeps 11; TF32 stays off), so the
// products run on the CUDA cores in plain float32 FMAs over the same
// operands: K9 and K11T stage the same k-tiles (at, bk) and each thread
// owns grid entries (d, e), accumulated over the tile's k-rows in k order
// (K9 in its grids wg, K11T in a grid of its own in shared memory); K11
// takes a thread a live pair, its rows X = [T1; dT1/dar; dT1/dai] over the
// grid's first factor staged beside its record, and forms Q_r[e] = sum_d
// X_r[d] vg[d, e] in d order (vg read as a broadcast), then the dot
// products with T2, dT2/dbr and dT2/dbi in e order.  Sums stay float32.
#include <type_traits>

#include "atom_gemm.cuh"
#include "common.cuh"
#include "prologue.cuh"

namespace {

// K9, K11 and K11T.  Exclusive prefix sum of one int a thread over the block
// (a multiple of 32 threads), the block's total in `total`; `ws` holds 33
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

// A masked pair's inputs to K11 and K11T, staged in shared memory: its
// displacement, its cutoff rcut_ij, its neighbor's weight wj, the inner
// switching function's centre and half-width, and (K11T) gh = gF[a] -
// gF[j].
constexpr int FT_STAGE = 10;

// Reads a masked pair pk's staged inputs; ei is its atom's row of elem.
// Without gF (K11) gh is 0 and jidx is not read.
template <typename T>
__device__ __forceinline__ void ft_load(
    const T* __restrict__ disp, const int* __restrict__ jelem,
    const int* __restrict__ jidx, const T* __restrict__ gF,
    const T* __restrict__ elem, const Scalars& s, const T ei[4],
    long long a, long long first, long long pk, T st[FT_STAGE]) {
  const int je = jelem[pk];
  const long long j = gF != nullptr ? first + jidx[pk] : 0;
  for (int c = 0; c < 3; ++c) st[c] = disp[pk * 3 + c];
  st[3] = (ei[0] + elem[je * 4]) * static_cast<T>(s.rcutfac);
  st[4] = elem[je * 4 + 1];
  st[5] = s.switchinnerflag ? T(0.5) * (ei[2] + elem[je * 4 + 2]) : T(0);
  st[6] = s.switchinnerflag ? T(0.5) * (ei[3] + elem[je * 4 + 3]) : T(0);
  for (int c = 0; c < 3; ++c)
    st[7 + c] = gF != nullptr ? gF[a * 3 + c] - gF[j * 3 + c] : T(0);
}

// The masked slots of atom a in neighbor order: thread t counts slots
// [t per, (t + 1) per), one scan places them in `list` ([K]), and the
// first `chunk` listed slots' inputs are staged in `stage` (a thread's
// first slot read ahead, in the shadow of the mask's load and the scan).
// With `g` (K11's pair gradients) an unmasked slot's output is set to 0 on
// the way.  Returns the number of masked slots, in every thread.
template <typename T>
__device__ int ft_list(const T* __restrict__ disp,
                       const int* __restrict__ jelem,
                       const int* __restrict__ jidx,
                       const T* __restrict__ gF,
                       const unsigned char* __restrict__ mask,
                       const T* __restrict__ elem, const Scalars& s,
                       const T ei[4], long long a, long long first,
                       int K, int chunk, T* stage, int* list, int* ws,
                       T* __restrict__ g) {
  const int nth = blockDim.x;
  const int per = (K + nth - 1) / nth;
  const int k0 = min(K, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(K, k0 + per);
  T ahead[FT_STAGE];
  if (k0 < k1)
    ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first, a * K + k0, ahead);
  int cnt = 0;
  for (int k = k0; k < k1; ++k) cnt += mask[a * K + k] != 0;
  int nm;
  int pos = block_scan(cnt, ws, nm);
  for (int k = k0; k < k1; ++k) {
    if (mask[a * K + k] == 0) {
      if (g != nullptr)
        for (int c = 0; c < 3; ++c) g[(a * K + k) * 3 + c] = T(0);
      continue;
    }
    list[pos] = k;
    if (pos < chunk) {
      T* st = stage + pos * FT_STAGE;
      if (k == k0) {
        for (int v = 0; v < FT_STAGE; ++v) st[v] = ahead[v];
      } else {
        ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first, a * K + k, st);
      }
    }
    ++pos;
  }
  return nm;
}

// The prologue of a masked pair from its staged inputs: the values (ar,
// ai, br, bi, w) of `prologue` (prologue.cuh) and, with TAN (K11, K11T),
// their tangents along the three displacement axes in closed form, sharing
// 1 / r, 1 / tan and one rsqrt where the dual numbers divide about twenty
// times; K9 takes the values alone (t unused).  At T = float the scalars
// (and their products with pi, formed at float64) are rounded to float once.
template <bool TAN = true, typename T>
__device__ void prologue_t(const T st[FT_STAGE], const Scalars& s, T v[5],
                           T t[5][3]) {
  const T pi = static_cast<T>(M_PI), half_pi = static_cast<T>(0.5 * M_PI);
  const T rmin0 = static_cast<T>(s.rmin0);
  const T dx = st[0], dy = st[1], dz = st[2], rcutij = st[3];
  const T r = sqrt(dx * dx + dy * dy + dz * dz);
  const T span = rcutij - rmin0;
  const T kth = static_cast<T>(s.rfac0 * M_PI) / span;   // d theta0 / dr
  const T tn = tan((r - rmin0) * kth);
  const T itn = T(1) / tn;
  const T z0 = r * itn;
  const T r0inv = rsqrt(r * r + z0 * z0);
  v[0] = r0inv * z0;
  v[1] = -(r0inv * dz);
  v[2] = r0inv * dy;
  v[3] = -(r0inv * dx);
  T sf = T(1), dsf = T(0);                       // dsf: d sfac / dr
  if (s.switchflag && r > rmin0) {
    if (r > rcutij) {
      sf = T(0);
    } else {
      const T rscale = pi / span;
      T sn, cs;
      sincos((r - rmin0) * rscale, &sn, &cs);
      sf = T(0.5) * (cs + T(1));
      if (TAN) dsf = T(-0.5) * sn * rscale;
    }
  }
  if (s.switchinnerflag) {
    const T sin_ij = st[5], din_ij = st[6];
    T inner = T(1), dinner = T(0);
    if (r <= sin_ij - din_ij) {
      inner = T(0);
    } else if (r < sin_ij + din_ij) {
      const T karg = half_pi / din_ij;
      const T arg = (r - sin_ij) * karg;
      T sn, cs;
      sincos(fmin(fmax(arg, -half_pi), half_pi) + half_pi, &sn, &cs);
      inner = T(0.5) * (T(1) - cs);
      if (TAN) dinner = fabs(arg) > half_pi ? T(0) : T(0.5) * sn * karg;
    }
    if (TAN) dsf = dsf * inner + sf * dinner;
    sf *= inner;
  }
  const T wj = st[4];
  v[4] = sf * wj;
  if (!TAN) return;
  const T dd[3] = {dx, dy, dz};
  const T rinv = T(1) / r;
  const T r0i3 = r0inv * r0inv * r0inv;
  for (int c = 0; c < 3; ++c) {
    const T dr = dd[c] * rinv;
    const T dtn = (T(1) + tn * tn) * kth * dr;
    const T dz0 = (dr - z0 * dtn) * itn;
    const T dr0 = -r0i3 * (r * dr + z0 * dz0);
    t[0][c] = dr0 * z0 + r0inv * dz0;
    t[1][c] = -(dr0 * dz + (c == 2 ? r0inv : T(0)));
    t[2][c] = dr0 * dy + (c == 1 ? r0inv : T(0));
    t[3][c] = -(dr0 * dx + (c == 0 ? r0inv : T(0)));
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

// twojmax of a grid of n_t = (twojmax + 1)(twojmax + 2) / 2 exponent
// pairs, -1 if n_t is no such count.
inline int grid_twojmax(int n_t) {
  int twojmax = 0;
  while ((twojmax + 1) * (twojmax + 2) / 2 < n_t) ++twojmax;
  return (twojmax + 1) * (twojmax + 2) / 2 == n_t ? twojmax : -1;
}

// A pair adds exactly nothing unless its weight or a weight tangent is
// nonzero (it is masked in but past the SNAP cutoff, or switched off).
template <typename T>
__device__ __forceinline__ bool ft_alive(const T v[5], const T t[5][3]) {
  return v[4] != T(0) || t[4][0] != T(0) || t[4][1] != T(0)
         || t[4][2] != T(0);
}

// The 2-vector of a working type (K9's ut as (re, im) pairs).
template <typename T> struct Pair2;
template <> struct Pair2<double> { using type = double2; };
template <> struct Pair2<float> { using type = float2; };

// The float32 products' plain FMA (fmaf at float, fma at double).
__device__ __forceinline__ float fs_fma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fs_fma(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nn_pair_force_t_kernel(
    const T* __restrict__ gF, const int* __restrict__ jidx,
    const T* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const T* __restrict__ elem, Scalars s, int A, int K, int n_t,
    int twojmax, const int* __restrict__ pidx, const int* __restrict__ qidx,
    size_t work_doubles, int tper, T* __restrict__ vgc) {
  extern __shared__ __align__(16) unsigned char smem_ft[];
  T* sm = reinterpret_cast<T*>(smem_ft);
  constexpr bool F64 = std::is_same<T, double>::value;
  const int nth = blockDim.x, tid = threadIdx.x;
  const int nt2 = n_t * n_t;
  const int np1 = twojmax + 2;
  const int rec_len = FT_REC + 4 * np1;
  const int chunk = ft_chunk(nth, K);
  const FtShape sh(n_t);
  T* rec = sm;                                   // [chunk][rec_len]
  // a k-tile of the product vgc = A B: k-rows 2 j, 2 j + 1 of pair j are
  // T1, Y in at (A transposed, [2 FT_PAIRS][lda]) and X, T2 in bk
  // ([2 FT_PAIRS][ldb]); at float32 the grid's sums follow ([nt2])
  T* at = rec + chunk * rec_len;
  T* bk = at + 2 * FT_PAIRS * sh.lda;
  T* vs = bk + 2 * FT_PAIRS * sh.ldb;
  T* stage = sm + work_doubles;                  // [chunk][FT_STAGE]
  int* list = reinterpret_cast<int*>(stage + chunk * FT_STAGE);  // [K]
  int* ws = list + K;                                      // [33]
  const long long a = blockIdx.x;
  const long long first = (a / A) * A;
  T* out = vgc + a * nt2;

  // the masked slots in neighbor order, the first chunk's inputs staged
  const int ie = ielem[a];
  T ei[4];
  for (int c = 0; c < 4; ++c) ei[c] = elem[ie * 4 + c];
  const int nm = ft_list(disp, jelem, jidx, gF, mask, elem, s, ei, a, first,
                         K, chunk, stage, list, ws, static_cast<T*>(nullptr));
  if (nm == 0) {                                 // a padded atom
    if (blockIdx.y == 0)
      for (int i = tid; i < nt2; i += nth) out[i] = T(0);
    return;
  }
  if (!F64)
    for (int i = tid; i < nt2; i += nth) vs[i] = T(0);
  __syncthreads();

  // the block's output tiles are tper from blockIdx.y * tper on; warp w
  // owns its tiles w, w + warps, ... (16 x 8 each), in registers (float64;
  // at float32 one block an atom, thread t owns the grid entries t, t +
  // threads, ..., kept in vs)
  const int lane = tid % 32, warp = tid / 32, warps = nth / 32;
  const int g = lane / 4, tq = lane % 4;
  double acc[FT_TILES][4];
  int m0[FT_TILES], n0[FT_TILES];                // -1: no tile
  for (int i = 0; i < FT_TILES; ++i) {
    const int tt = blockIdx.y * tper + warp + i * warps;
    m0[i] = F64 && warp + i * warps < tper && tt < sh.tiles
                ? (tt / (sh.np / 8)) * 16
                : -1;
    n0[i] = (tt % (sh.np / 8)) * 8;
    for (int v = 0; v < 4; ++v) acc[i][v] = 0.0;
  }

  for (int c0 = 0; c0 < nm; c0 += chunk) {
    // one masked pair a thread: its prologue, then the live ones (nonzero
    // weight or weight tangent: the others add exactly nothing) are
    // written in neighbor order
    bool alive = false;
    T ab[4], r5[FT_REC];
    if (tid < min(chunk, nm - c0)) {
      T st[FT_STAGE];
      if (c0 == 0) {
        for (int u = 0; u < FT_STAGE; ++u) st[u] = stage[tid * FT_STAGE + u];
      } else {
        ft_load(disp, jelem, jidx, gF, elem, s, ei, a, first,
                a * K + list[c0 + tid], st);
      }
      T v[5], t[5][3];
      prologue_t(st, s, v, t);
      alive = ft_alive(v, t);
      if (alive) {
        T h[3];
        r5[0] = T(0);
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
      T* rr = rec + slot * rec_len;
      for (int v = 0; v < FT_REC; ++v) rr[v] = r5[v];
      T* pw = rr + FT_REC;
      for (int v = 0; v < 4; ++v) {
        T x = T(1);
        pw[v * np1] = T(0);
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
        const T pd = p, qd = q;
        for (int j = warp; j < FT_PAIRS; j += warps) {
          T t1 = T(0), y = T(0), x = T(0), t2 = T(0);
          if (in && j < npr) {
            const T* rr = rec + (p0 + j) * rec_len;
            const T* pa = rr + FT_REC;
            const T* pai = pa + np1;
            const T* pb = pai + np1;
            const T* pbi = pb + np1;
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
      if constexpr (F64) {
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
      } else {
        // vgc[d, e] += sum over the tile's k-rows of at[., d] bk[., e], in
        // k order, a thread its entries
        for (int i = tid; i < nt2; i += nth) {
          const int d = i / n_t, e = i - d * n_t;
          T sum = vs[i];
          for (int kr = 0; kr < 2 * npr; ++kr)
            sum = fs_fma(at[kr * sh.lda + d], bk[kr * sh.ldb + e], sum);
          vs[i] = sum;
        }
      }
      __syncthreads();
    }
  }
  // the tiles (zero where no pair is live)
  if constexpr (!F64) {
    for (int i = tid; i < nt2; i += nth) out[i] = vs[i];
    return;
  }
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

// K11.  A live pair's record: w, its tangents wt, and the tangents of ar,
// ai, br, bi (three each), then eight tables: the powers of ar, ai, br, bi
// as FT_REC's (x^n at [n + 1]) and their derivatives n x^(n-1) at [n]; the
// stride is 4 mod 16 doubles, so that an m-tile's pairs spread over the
// banks.
constexpr int FF_REC = 16;
constexpr int FF_NG = 4;           // n-tiles a warp multiplies at once
constexpr int FF_PAIRS = 5;        // pairs an m-tile of 16 rows (3 each)

__host__ __device__ __forceinline__ int ff_rec_len(int twojmax) {
  const int n = FF_REC + 8 * (twojmax + 2);
  return n + (20 - n % 16) % 16;
}

// At float32 a record also holds the pair's rows X (3 n_t: T1, dT1/dar,
// dT1/dai over the grid's first factor), its length odd so that a warp's
// pairs read different banks.
template <typename T>
__host__ __device__ __forceinline__ int ff_rec_len_t(int twojmax, int n_t) {
  if (std::is_same<T, double>::value) return ff_rec_len(twojmax);
  const int n = ff_rec_len(twojmax) + 3 * n_t;
  return n | 1;
}

template <typename T, int THREADS, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) nn_pair_force_kernel(
    const T* __restrict__ vg, const T* __restrict__ disp,
    const int* __restrict__ jelem, const unsigned char* __restrict__ mask,
    const int* __restrict__ ielem, const T* __restrict__ elem,
    Scalars s, int K, int n_t, int twojmax, const int* __restrict__ pidx,
    const int* __restrict__ qidx, int chunk, size_t work_doubles,
    T* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem_ff[];
  T* sm = reinterpret_cast<T*>(smem_ff);
  constexpr bool F64 = std::is_same<T, double>::value;
  const int nth = blockDim.x, tid = threadIdx.x;
  const int np1 = twojmax + 2;
  const int rec_len = ff_rec_len_t<T>(twojmax, n_t);
  const FtShape sh(n_t);
  const int ld = sh.ldb;
  T* svg = sm;                                   // [np][ld]
  T* rec = svg + sh.np * ld;                     // [chunk][rec_len]
  // [chunk][FT_STAGE]: read before the second scan, the records after it
  T* stage = rec;
  T* zero = rec + chunk * rec_len;               // [np1] zeros
  T* rs = zero + np1;                            // [warps][16][3] row sums
  int* pq = reinterpret_cast<int*>(sm + work_doubles);         // [np]
  int* lslot = pq + sh.np;                       // [chunk] live pairs' slots
  int* list = lslot + chunk;                     // [K]
  int* ws = list + K;                            // [33]
  const long long a = blockIdx.x;

  // vg by asynchronous copies, zero padded to np x np, in flight through
  // the scan and the prologues; the exponents (p | q << 8; (0, 0) in the
  // padding) are loaded here and stored after the scan
  const T* va = vg + a * n_t * n_t;
  for (int i = tid; i < n_t * n_t; i += nth)
    fs_cp_async_elem(svg + (i / n_t) * ld + i % n_t, va + i);
  for (int i = tid; i < sh.np * ld; i += nth) {
    const int d = i / ld, e = i - d * ld;
    if (d >= n_t || e >= n_t) svg[i] = T(0);
  }
  for (int i = tid; i < np1; i += nth) zero[i] = T(0);
  const int pqv = tid < n_t ? pidx[tid] | qidx[tid] << 8 : 0;

  // the masked slots in neighbor order (the others' outputs set to 0), the
  // first chunk's inputs staged
  const int ie = ielem[a];
  T ei[4];
  for (int c = 0; c < 4; ++c) ei[c] = elem[ie * 4 + c];
  const int nm = ft_list(disp, jelem, nullptr, static_cast<const T*>(nullptr),
                         mask, elem, s, ei, a, 0, K, chunk, stage, list, ws,
                         g);
  if (nm == 0) {                                 // a padded atom
    fs_cp_async_wait_all();
    return;
  }
  for (int d = tid; d < sh.np; d += nth)
    pq[d] = d == tid ? pqv : d < n_t ? pidx[d] | qidx[d] << 8 : 0;
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32, warps = nth / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ntiles = sh.np / 8;                  // also the k-steps
  const int gsize = (ntiles + (ntiles + FF_NG - 1) / FF_NG - 1)
                    / ((ntiles + FF_NG - 1) / FF_NG);
  T* wrs = rs + warp * 48;
  for (int c0 = 0; c0 < nm; c0 += chunk) {
    // one masked pair a thread: its prologue (a dead pair's output 0),
    // then the live ones' records in neighbor order
    bool alive = false;
    int k = 0;
    T v[5], t[5][3];
    if (tid < min(chunk, nm - c0)) {
      T st[FT_STAGE];
      k = list[c0 + tid];
      if (c0 == 0) {
        for (int u = 0; u < FT_STAGE; ++u) st[u] = stage[tid * FT_STAGE + u];
      } else {
        ft_load(disp, jelem, nullptr, static_cast<const T*>(nullptr), elem,
                s, ei, a, 0, a * K + k, st);
      }
      prologue_t(st, s, v, t);
      alive = ft_alive(v, t);
      if (!alive)
        for (int c = 0; c < 3; ++c) g[(a * K + k) * 3 + c] = T(0);
    }
    int nl;
    const int slot = block_scan(alive ? 1 : 0, ws, nl);
    if (alive) {
      T* rr = rec + slot * rec_len;
      rr[0] = v[4];
      for (int c = 0; c < 3; ++c) {
        rr[1 + c] = t[4][c];
        for (int u = 0; u < 4; ++u) rr[4 + 3 * u + c] = t[u][c];
      }
      // the power tables (as K11T's) and their derivatives, the four
      // running products side by side
      T* pw = rr + FF_REC;
      T x[4] = {T(1), T(1), T(1), T(1)}, dn = T(1);
      for (int u = 0; u < 8; ++u) pw[u * np1] = T(0);
      for (int n = 0; n <= twojmax; ++n, dn += T(1)) {
        for (int u = 0; u < 4; ++u) {
          pw[u * np1 + n + 1] = x[u];
          pw[(4 + u) * np1 + n + 1] = dn * x[u];
          x[u] *= v[u];
        }
      }
      if (!F64) {
        // float32: the rows X over the grid's first factor, from the
        // tables just written (this thread's own)
        T* xs = rr + ff_rec_len(twojmax);
        for (int d = 0; d < n_t; ++d) {
          const int p = pidx[d], q = qidx[d];
          xs[d] = pw[p + 1] * pw[np1 + q + 1];
          xs[n_t + d] = pw[4 * np1 + p] * pw[np1 + q + 1];
          xs[2 * n_t + d] = pw[p + 1] * pw[5 * np1 + q];
        }
      }
      lslot[slot] = k;
    }
    if (c0 == 0) fs_cp_async_wait_all();
    __syncthreads();
    if constexpr (!F64) {
      // float32, a thread a live pair: Q_r[e] = sum_d X_r[d] vg[d, e] in d
      // order (vg a broadcast), then the dot products with T2, E1 =
      // dT2/dbr and E2 = dT2/dbi in e order; g_c = w st_c + wt_c sp as
      // below
      for (int j = tid; j < nl; j += nth) {
        const T* rr = rec + j * rec_len;
        const T* pw = rr + FF_REC;
        const T* xs = rr + ff_rec_len(twojmax);
        T S[5] = {T(0), T(0), T(0), T(0), T(0)};  // Q0.T2 Q0.E1 Q0.E2
        for (int e = 0; e < n_t; ++e) {           // Q1.T2 Q2.T2
          T q0 = T(0), q1 = T(0), q2 = T(0);
          for (int d = 0; d < n_t; ++d) {
            const T w = svg[d * ld + e];
            q0 = fs_fma(xs[d], w, q0);
            q1 = fs_fma(xs[n_t + d], w, q1);
            q2 = fs_fma(xs[2 * n_t + d], w, q2);
          }
          const int p = pq[e] & 255, q = pq[e] >> 8;
          const T t2 = pw[2 * np1 + p + 1] * pw[3 * np1 + q + 1];
          const T e1 = pw[6 * np1 + p] * pw[3 * np1 + q + 1];
          const T e2 = pw[2 * np1 + p + 1] * pw[7 * np1 + q];
          S[0] = fs_fma(q0, t2, S[0]);
          S[1] = fs_fma(q0, e1, S[1]);
          S[2] = fs_fma(q0, e2, S[2]);
          S[3] = fs_fma(q1, t2, S[3]);
          S[4] = fs_fma(q2, t2, S[4]);
        }
        for (int c = 0; c < 3; ++c) {
          const T st = rr[4 + c] * S[3] + rr[7 + c] * S[4]
                       + rr[10 + c] * S[1] + rr[13 + c] * S[2];
          g[(a * K + lslot[j]) * 3 + c] = rr[0] * st + rr[1 + c] * S[0];
        }
      }
    } else {

      // m-tile mt: rows 3 i + kind of its FF_PAIRS live pairs 5 mt + i, the
      // pair's T1 (kind 0), dT1/dar (1) and dT1/dai (2) over the grid's first
      // factor (each entry X[p] Y[q] of two of its tables), row 15 zero.
      // Lane (gq, tq) owns rows gq and gq + 8.  Q = X vg on the FP64 tensor
      // cores, gsize n-tiles at once, then each row's dot products with T2,
      // E1 = dT2/dbr and E2 = dT2/dbi over the lane's columns, summed over
      // the row's four lanes by an xor butterfly; per pair sp = Q_0 . T2 and
      // st_c = dar_c Q_1 . T2 + dai_c Q_2 . T2 + dbr_c Q_0 . E1
      // + dbi_c Q_0 . E2
      for (int mt = warp; FF_PAIRS * mt < nl; mt += warps) {
        const double* xr[2];
        const double* yr[2];
        const double* tb[2];
        for (int h = 0; h < 2; ++h) {
          const int row = gq + 8 * h, j = FF_PAIRS * mt + row / 3;
          const int kind = row % 3;
          const double* pw =
              rec + min(j, nl - 1) * rec_len + FF_REC;   // Pa Pai Pb Pbi Da ..
          const bool on = row < 3 * FF_PAIRS && j < nl;
          xr[h] = !on ? zero : kind == 1 ? pw + 4 * np1 : pw + 1;
          yr[h] = kind == 2 ? pw + 5 * np1 : pw + np1 + 1;
          tb[h] = pw + 2 * np1;
        }
        double S[2][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
        for (int n0 = 0; n0 < ntiles; n0 += gsize) {
          double acc[FF_NG][4];
  #pragma unroll
          for (int i = 0; i < FF_NG; ++i)
            for (int u = 0; u < 4; ++u) acc[i][u] = 0.0;
          for (int ks = 0; ks < ntiles; ++ks) {
            double fa[4];
  #pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = pq[8 * ks + tq + 4 * h];
              const int p = e & 255, q = e >> 8;
              fa[2 * h] = xr[0][p] * yr[0][q];
              fa[2 * h + 1] = xr[1][p] * yr[1][q];
            }
            const double* bq = svg + (8 * ks + tq) * ld + gq;
  #pragma unroll
            for (int i = 0; i < FF_NG; ++i) {
              if (i < gsize && n0 + i < ntiles) {
                const double fb[2] = {bq[8 * (n0 + i)],
                                      bq[4 * ld + 8 * (n0 + i)]};
                mma_f64(acc[i], fa, fb);
              }
            }
          }
  #pragma unroll
          for (int i = 0; i < FF_NG; ++i) {
            if (!(i < gsize && n0 + i < ntiles)) continue;
            for (int cc = 0; cc < 2; ++cc) {
              const int e = pq[8 * (n0 + i) + 2 * tq + cc];
              const int p = e & 255, q = e >> 8;
  #pragma unroll
              for (int h = 0; h < 2; ++h) {
                const double* pb = tb[h];            // Pb, Pbi, .., Db, Dbi
                const double r = acc[i][2 * h + cc];
                S[h][0] += r * (pb[p + 1] * pb[np1 + q + 1]);
                S[h][1] += r * (pb[4 * np1 + p] * pb[np1 + q + 1]);
                S[h][2] += r * (pb[p + 1] * pb[5 * np1 + q]);
              }
            }
          }
        }
        for (int h = 0; h < 2; ++h) {
          for (int u = 0; u < 3; ++u) {
            S[h][u] += __shfl_xor_sync(0xffffffffu, S[h][u], 1);
            S[h][u] += __shfl_xor_sync(0xffffffffu, S[h][u], 2);
            if (tq == 0) wrs[(gq + 8 * h) * 3 + u] = S[h][u];
          }
        }
        __syncwarp();
        const int j = FF_PAIRS * mt + lane / 3;
        if (lane < 3 * FF_PAIRS && j < nl) {       // g_c = w st_c + wt_c sp
          const int c = lane % 3;
          const double* rw = wrs + 9 * (lane / 3);
          const double* rr = rec + j * rec_len;
          const double st = rr[4 + c] * rw[3] + rr[7 + c] * rw[6]
                            + rr[10 + c] * rw[1] + rr[13 + c] * rw[2];
          g[(a * K + lslot[j]) * 3 + c] = rr[0] * st + rr[1 + c] * rw[0];
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// K9.  A live pair's record: its weight w, then the power tables of ar,
// ai, br, bi, each x^0 .. x^twojmax.
__host__ __device__ __forceinline__ int k9_rec_len(int twojmax) {
  return 1 + 4 * (twojmax + 1);
}

// K9's shared doubles: the grids wg, one an element channel (nchem n_t^2,
// rounded up to an even count so that the next region holds 16-byte
// pairs), and the work region, the product's (the records of `chunk` pairs
// and a k-tile of `kp` pairs: A transposed, [kp][lda], and B, [kp][ldb]) or
// the B terms' (ut as (re, im) pairs, nchem U of them, then the slots'
// partial sums), whichever is larger.
__host__ __device__ inline size_t k9_wg(int n_t, int nchem) {
  return (static_cast<size_t>(nchem) * n_t * n_t + 1) / 2 * 2;
}
__host__ __device__ inline size_t k9_work(const FtShape& sh, int twojmax,
                                          int chunk, int kp, int two_u,
                                          int nchem, int stride) {
  const size_t prod = static_cast<size_t>(chunk) * k9_rec_len(twojmax)
                      + static_cast<size_t>(kp) * (sh.lda + sh.ldb);
  const size_t terms = static_cast<size_t>(nchem) * two_u + stride;
  return prod > terms ? prod : terms;
}

constexpr int K9_PAIRS = 32;       // live pairs a k-tile, at most
constexpr int K9_BATCH = 4;        // B terms a thread loads at once

// K9's narrow launch bounds: blocks of up to 8 warps at 64 registers (the
// FP64 mma.sync takes no fewer), four an SM; wider blocks take the bounds
// of 1,024 threads, one block an SM.
constexpr int K9_NARROW_THREADS = 256;
constexpr int K9_NARROW_BLOCKS = 4;

template <typename T, int MAXT, int MINB, int TILES>
__global__ void __launch_bounds__(MAXT, MINB) nn_ut_b_kernel(
    const T* __restrict__ disp, const int* __restrict__ jelem,
    const unsigned char* __restrict__ mask, const int* __restrict__ ielem,
    const T* __restrict__ elem, Scalars s, int K, int n_t, int twojmax,
    const int* __restrict__ pidx, const int* __restrict__ qidx,
    const int* __restrict__ lgc_ptr, const int* __restrict__ lgc_row,
    const T* __restrict__ lgc_val, int two_u,
    const T* __restrict__ selfvec, int nchem, int self_all, int per,
    int stride,
    const long long* __restrict__ bs_key, const T* __restrict__ bs_fac,
    const int* __restrict__ bs_seg, int W, const T* __restrict__ bzero,
    int chunk, int kp, size_t work_doubles, T* __restrict__ ut,
    T* __restrict__ B) {
  extern __shared__ __align__(16) unsigned char smem_k9[];
  T* sm = reinterpret_cast<T*>(smem_k9);
  using T2 = typename Pair2<T>::type;
  constexpr bool F64 = std::is_same<T, double>::value;
  const int nth = blockDim.x, tid = threadIdx.x;
  const int U = two_u / 2;
  const int nt2 = n_t * n_t;
  const int np1 = twojmax + 1;
  const int rec_len = k9_rec_len(twojmax);
  const FtShape sh(n_t);
  T* wg = sm;                                    // [nchem][n_t][n_t]
  T* work = sm + k9_wg(n_t, nchem);
  T* rec = work;                                 // [chunk][rec_len]
  T* at = rec + chunk * rec_len;                 // [kp][lda]: A transposed
  T* bk = at + kp * sh.lda;                      // [kp][ldb]
  T2* su = reinterpret_cast<T2*>(work);          // terms: [nchem U] ut
  T* part = work + nchem * two_u;                // terms: [stride]
  T* stage = sm + work_doubles;                  // [chunk][FT_STAGE]
  int* pq = reinterpret_cast<int*>(stage + chunk * FT_STAGE);  // [np]
  int* list = pq + sh.np;                        // [K]
  int* ws = list + K;                            // [33]
  int* cb = ws + 33;                             // [nchem + 1]
  const long long a = blockIdx.x;

  // the grids zeroed and the exponents (p | q << 8; (0, 0) in the padding)
  // staged, in the shadow of the scan
  for (int i = tid; i < nchem * nt2; i += nth) wg[i] = T(0);
  for (int d = tid; d < sh.np; d += nth)
    pq[d] = d < n_t ? pidx[d] | qidx[d] << 8 : 0;

  // the masked slots in neighbor order, the first chunk's inputs staged; a
  // padded atom (no masked slot) keeps every wg 0: its ut is the self term
  const int ie = ielem[a];
  T ei[4];
  for (int c = 0; c < 4; ++c) ei[c] = elem[ie * 4 + c];
  const int nm = ft_list(disp, jelem, nullptr, static_cast<const T*>(nullptr),
                         mask, elem, s, ei, a, 0, K, chunk, stage, list, ws,
                         static_cast<T*>(nullptr));
  __syncthreads();

  // round r: warp w owns output tiles w + (r TILES + i) warps (16 x 8
  // each) of a channel's grid, accumulated in registers over the chunk's
  // k-tiles of that channel's pairs and kept in wg between chunks (float32:
  // thread t owns the grid entries t, t + threads, ..., summed in wg)
  const int lane = tid % 32, warp = tid / 32, warps = nth / 32;
  const int g = lane / 4, tq = lane % 4;
  const int rounds = (sh.tiles + warps * TILES - 1) / (warps * TILES);
  const int width = max(sh.mp, sh.np);
  for (int c0 = 0; c0 < nm; c0 += chunk) {
    // one masked pair a thread: its values, then the live ones (nonzero
    // weight: the others add exactly nothing) written channel by channel
    // (the neighbor's element), each channel's in neighbor order
    bool alive = false;
    int ch = 0;
    T v[5];
    if (tid < min(chunk, nm - c0)) {
      T st[FT_STAGE];
      if (c0 == 0) {
        for (int u = 0; u < FT_STAGE; ++u) st[u] = stage[tid * FT_STAGE + u];
      } else {
        ft_load(disp, jelem, nullptr, static_cast<const T*>(nullptr), elem,
                s, ei, a, 0, a * K + list[c0 + tid], st);
      }
      prologue_t<false>(st, s, v, static_cast<T(*)[3]>(nullptr));
      alive = v[4] != T(0);
      if (nchem > 1) ch = jelem[a * K + list[c0 + tid]];
    }
    // channel ec's live pairs of the chunk at records [cb[ec], cb[ec + 1])
    int nl = 0;
    for (int ec = 0; ec < nchem; ++ec) {
      const bool mine = alive && ch == ec;
      int nc;
      const int slot = nl + block_scan(mine ? 1 : 0, ws, nc);
      if (mine) {
        T* rr = rec + slot * rec_len;
        rr[0] = v[4];
        T x[4] = {T(1), T(1), T(1), T(1)};
        for (int n = 0; n < np1; ++n) {
          for (int u = 0; u < 4; ++u) {
            rr[1 + u * np1 + n] = x[u];
            x[u] *= v[u];
          }
        }
      }
      if (tid == 0) cb[ec] = nl;
      nl += nc;
      __syncthreads();
    }
    if (tid == 0) cb[nchem] = nl;
    __syncthreads();
    for (int ec = 0; ec < nchem; ++ec) {
      const int lo = cb[ec], nlc = cb[ec + 1] - lo;
      if (nlc == 0) continue;
      T* wgc = wg + ec * nt2;
      if constexpr (!F64) {
        // float32: the k-tiles of the channel's pairs, then wg[d, e] +=
        // sum over the tile's pairs of (w T1)[d] T2[e] in pair order, a
        // thread its entries
        for (int p0 = 0; p0 < nlc; p0 += kp) {
          const int npr = min(kp, nlc - p0);
          for (int i = tid; i < npr * n_t; i += nth) {
            const int j = i / n_t, d = i - j * n_t;
            const T* rr = rec + (lo + p0 + j) * rec_len;
            const int e = pq[d];
            const int pp = e & 255, qq = e >> 8;
            at[j * sh.lda + d] = rr[0] * (rr[1 + pp] * rr[1 + np1 + qq]);
            bk[j * sh.ldb + d] = rr[1 + 2 * np1 + pp] * rr[1 + 3 * np1 + qq];
          }
          __syncthreads();
          for (int i = tid; i < nt2; i += nth) {
            const int d = i / n_t, e = i - d * n_t;
            T sum = wgc[i];
            for (int j = 0; j < npr; ++j)
              sum = fs_fma(at[j * sh.lda + d], bk[j * sh.ldb + e], sum);
            wgc[i] = sum;
          }
          __syncthreads();
        }
      } else {
        for (int r = 0; r < rounds; ++r) {
          double acc[TILES][4];
          int m0[TILES], n0[TILES];                // -1: no tile
#pragma unroll
          for (int i = 0; i < TILES; ++i) {
            const int tt = warp + (r * TILES + i) * warps;
            m0[i] = tt < sh.tiles ? (tt / (sh.np / 8)) * 16 : -1;
            n0[i] = (tt % (sh.np / 8)) * 8;
            for (int h = 0; h < 2; ++h) {
              const int row = m0[i] + g + 8 * h;
              for (int c = 0; c < 2; ++c) {
                const int col = n0[i] + 2 * tq + c;
                acc[i][2 * h + c] = m0[i] >= 0 && row < n_t && col < n_t
                                        ? wgc[row * n_t + col] : 0.0;
              }
            }
          }
          for (int p0 = 0; p0 < nlc; p0 += kp) {
            // the k-tile: pair j's column w T1 and row T2 from its tables,
            // zero past the channel's live pairs and past n_t
            const int npr = min(kp, nlc - p0);
            for (int i = tid; i < kp * width; i += nth) {
              const int j = i / width, d = i - j * width;
              double t1 = 0.0, t2 = 0.0;
              if (j < npr && d < n_t) {
                const double* rr = rec + (lo + p0 + j) * rec_len;
                const int e = pq[d];
                const int pp = e & 255, qq = e >> 8;
                t1 = rr[0] * (rr[1 + pp] * rr[1 + np1 + qq]);
                t2 = rr[1 + 2 * np1 + pp] * rr[1 + 3 * np1 + qq];
              }
              if (d < sh.mp) at[j * sh.lda + d] = t1;
              if (d < sh.np) bk[j * sh.ldb + d] = t2;
            }
            __syncthreads();
            // wg += A B over the tile's k-steps of 8 pairs, in pair order
            const int ksteps = (npr + 7) / 8;
            for (int ks = 0; ks < ksteps; ++ks) {
              const double* ak = at + (8 * ks + tq) * sh.lda + g;
              const double* bq = bk + (8 * ks + tq) * sh.ldb + g;
#pragma unroll
              for (int i = 0; i < TILES; ++i) {
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
#pragma unroll
          for (int i = 0; i < TILES; ++i) {
            if (m0[i] < 0) break;
            for (int h = 0; h < 2; ++h) {
              const int row = m0[i] + g + 8 * h;
              for (int c = 0; c < 2; ++c) {
                const int col = n0[i] + 2 * tq + c;
                if (row < n_t && col < n_t)
                  wgc[row * n_t + col] = acc[i][2 * h + c];
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // ut = wg . Lg + the self term, a thread a column of a channel (the self
  // term in every channel under self_all, else in the atom's own), written
  // as the plain version lays ut out: every channel's real parts, then
  // every channel's imaginary parts; kept as (re, im) pairs for the B terms
  T* sud = reinterpret_cast<T*>(su);
  const int cu = nchem * U;
  for (int i = tid; i < nchem * two_u; i += nth) {
    const int ec = i / two_u, u = i - ec * two_u;
    const T* wgc = wg + ec * nt2;
    const int q0 = lgc_ptr[u], q1 = lgc_ptr[u + 1];
    T acc = T(0);
    for (int q = q0; q < q1; ++q) acc += wgc[lgc_row[q]] * lgc_val[q];
    if (self_all || ec == ie) acc += selfvec[u];
    const int im = u < U ? 0 : 1;
    const int col = ec * U + u - im * U;
    ut[a * 2 * cu + im * cu + col] = acc;
    sud[2 * col + im] = acc;
  }
  __syncthreads();

  // the B terms: slot s sums its segment's `per` terms in order,
  // K9_BATCH loaded at a time
  for (int sl = tid; sl < stride; sl += nth) {
    T acc = T(0);
    for (int j0 = 0; j0 < per; j0 += K9_BATCH) {
      long long kk[K9_BATCH];
      T cc[K9_BATCH];
#pragma unroll
      for (int r = 0; r < K9_BATCH; ++r) {
        const bool in = j0 + r < per;
        kk[r] = in ? bs_key[(j0 + r) * static_cast<long long>(stride) + sl]
                   : 0;
        cc[r] = in ? bs_fac[(j0 + r) * static_cast<long long>(stride) + sl]
                   : T(0);
      }
#pragma unroll
      for (int r = 0; r < K9_BATCH; ++r) {
        if (j0 + r >= per) break;
        const T2 x = su[kk[r] & 0xffff];
        const T2 y = su[(kk[r] >> 16) & 0xffff];
        const T2 z = su[kk[r] >> 32];
        const T ab_r = x.x * y.x - x.y * y.y;
        const T ab_i = x.x * y.y + x.y * y.x;
        acc += (ab_r * z.x + ab_i * z.y) * cc[r];
      }
    }
    part[sl] = acc;
  }
  __syncthreads();

  // a descriptor: its segments' sums in order, less bzero
  for (int t = tid; t < W; t += nth) {
    T acc = T(0);
    for (int q = bs_seg[t]; q < bs_seg[t + 1]; ++q) acc += part[q];
    if (bzero != nullptr) acc -= bzero[t];
    B[a * W + t] = acc;
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

template <typename T>
int nn_ut_b_launch(const T* disp, const int* jelem, const unsigned char* mask,
                   const int* ielem, const T* elem, double rcutfac,
                   double rfac0, double rmin0, int switchflag,
                   int switchinnerflag, long long natoms, int K, int n_t,
                   const int* pidx, const int* qidx, const int* lgc_ptr,
                   const int* lgc_row, const T* lgc_val, int two_u,
                   const T* selfvec, int nchem, int self_all, int threads,
                   int per, int stride, const long long* bs_key,
                   const T* bs_fac, const int* bs_seg, int W, const T* bzero,
                   T* ut, T* B, void* stream) {
  const int twojmax = grid_twojmax(n_t);
  if (twojmax < 0 || threads % 32 != 0 || threads > 1024 || stride < threads
      || nchem < 1 || static_cast<long long>(nchem) * (two_u / 2) > 1 << 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const FtShape sh(n_t);
  const size_t ints = static_cast<size_t>(sh.np) + K + 33 + nchem + 1;
  auto bytes = [&](int chunk, int kp) {
    return (k9_wg(n_t, nchem)
            + k9_work(sh, twojmax, chunk, kp, two_u, nchem, stride)
            + static_cast<size_t>(chunk) * FT_STAGE) * sizeof(T)
           + ints * sizeof(int);
  };
  // the widest k-tile beside a full chunk, else k-tiles of 8 pairs and the
  // chunk that fits
  const int full = ft_chunk(threads, K);
  int kp = K9_PAIRS;
  while (kp > 8 && bytes(full, kp) > FS_SMEM_LIMIT) kp -= 8;
  int chunk = full;
  while (chunk > 1 && bytes(chunk, kp) > FS_SMEM_LIMIT) --chunk;
  if (bytes(chunk, kp) > FS_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t work = k9_wg(n_t, nchem)
                      + k9_work(sh, twojmax, chunk, kp, two_u, nchem, stride);
  const auto kernel =
      threads <= K9_NARROW_THREADS
          ? nn_ut_b_kernel<T, K9_NARROW_THREADS, K9_NARROW_BLOCKS, 1>
          : nn_ut_b_kernel<T, 1024, 1, FT_TILES>;
  const int err = fs_allow_smem(kernel, bytes(chunk, kp));
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, bytes(chunk, kp),
             static_cast<cudaStream_t>(stream)>>>(
        disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), K, n_t,
        twojmax, pidx, qidx, lgc_ptr, lgc_row, lgc_val, two_u, selfvec, nchem,
        self_all, per, stride, bs_key, bs_fac, bs_seg,
        W, bzero, chunk, kp, work, ut, B);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int nn_pair_force_launch(const T* vg, const T* disp, const int* jelem,
                         const unsigned char* mask, const int* ielem,
                         const T* elem, double rcutfac, double rfac0,
                         double rmin0, int switchflag, int switchinnerflag,
                         long long natoms, int K, int n_t, const int* pidx,
                         const int* qidx, T* g, void* stream) {
  const int twojmax = grid_twojmax(n_t);
  if (twojmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool wide = natoms <= 2LL * sms;
  const int threads = wide ? 256 : 128;
  const FtShape sh(n_t);
  // the chunk's records take the shared memory that vg and the rest leave,
  // so that a large grid runs more, smaller chunks
  const int rec_len = ff_rec_len_t<T>(twojmax, n_t);
  const size_t fixed = static_cast<size_t>(sh.np) * sh.ldb + (twojmax + 2)
                       + threads / 32 * 48;
  const long long fixed_bytes = static_cast<long long>(
      fixed * sizeof(T) + (sh.np + K + 33) * sizeof(int));
  const long long room = (static_cast<long long>(FS_SMEM_LIMIT) - fixed_bytes)
                         / static_cast<long long>(rec_len * sizeof(T)
                                                  + sizeof(int));
  const int chunk = static_cast<int>(
      room < ft_chunk(threads, K) ? room : ft_chunk(threads, K));
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t work = fixed + static_cast<size_t>(chunk) * rec_len;
  const size_t smem = work * sizeof(T)
                      + (sh.np + chunk + K + 33) * sizeof(int);
  const auto kernel = wide ? nn_pair_force_kernel<T, 256, 2>
                           : nn_pair_force_kernel<T, 128, 4>;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        vg, disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), K, n_t,
        twojmax, pidx, qidx, chunk, work, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int nn_pair_force_t_launch(const T* gF, const int* jidx, const T* disp,
                           const int* jelem, const unsigned char* mask,
                           const int* ielem, const T* elem, double rcutfac,
                           double rfac0, double rmin0, int switchflag,
                           int switchinnerflag, long long natoms, int A,
                           int K, int n_t, const int* pidx, const int* qidx,
                           T* vgc, void* stream) {
  const int twojmax = grid_twojmax(n_t);
  if (twojmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool F64 = std::is_same<T, double>::value;
  // a warp a FT_TILES output tiles, at least four warps; where that takes
  // more than 1,024 threads (twojmax 15 and up), the tiles split evenly
  // over the fewest blocks an atom that keep to 1,024 (float32: one block
  // an atom, its threads sharing the grid's entries)
  const FtShape sh(n_t);
  int tsplit = 1, tper = sh.tiles, threads = 0;
  for (;; ++tsplit) {
    tper = (sh.tiles + tsplit - 1) / tsplit;
    threads = max(128, (tper + FT_TILES - 1) / FT_TILES * 32);
    if (threads <= 1024) break;
    if (!F64) {
      tsplit = 1;
      tper = sh.tiles;
      threads = 1024;
      break;
    }
  }
  const int chunk = ft_chunk(threads, K);
  const size_t work = static_cast<size_t>(chunk) * (FT_REC + 4 * (twojmax + 2))
                      + 2 * FT_PAIRS * (sh.lda + sh.ldb)
                      + (F64 ? 0 : static_cast<size_t>(n_t) * n_t);
  const size_t smem = (work + static_cast<size_t>(chunk) * FT_STAGE)
                      * sizeof(T) + (K + 33) * sizeof(int);
  if (smem > FS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = threads > 256 ? nn_pair_force_t_kernel<T, 1024, 1>
                                    : nn_pair_force_t_kernel<T, 256, 2>;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<dim3(static_cast<unsigned>(natoms), tsplit), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        gF, jidx, disp, jelem, mask, ielem, elem,
        scalars(rcutfac, rfac0, rmin0, switchflag, switchinnerflag), A, K,
        n_t, twojmax, pidx, qidx, work, tper, vgc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) u8, ielem (N,) i32, elem
// (nelem, 4); the grid exponents pidx, qidx (n_t,) i32; Lg by column
// (lgc_ptr (2U + 1,), lgc_row, lgc_val); selfvec (2U,); nchem element
// channels (a pair's channel its neighbor's element; 1 without chemflag)
// and self_all (the self term in every channel, else in the atom's own);
// the B terms' schedule by descriptor (ops/snap.py `deal`: `per` terms a
// slot, `stride` slots, `threads` threads, bs_key i64 i1 | i2 << 16 | i3
// << 32 into the channel-major ut, bs_fac f64, bs_seg (W + 1,) i32); bzero
// (W,) or null.  Writes ut (N, 2 nchem U) and B (N, W).  The chunk of
// prologues and the k-tile take what shared memory the grids leave (fewer
// pairs at the largest grids); grids past a block's shared memory (twojmax
// 17 and up in one channel, less in more) are refused.
extern "C" int nn_ut_b(const double* disp, const int* jelem,
                       const unsigned char* mask, const int* ielem,
                       const double* elem, double rcutfac, double rfac0,
                       double rmin0, int switchflag, int switchinnerflag,
                       long long natoms, int K, int n_t, const int* pidx,
                       const int* qidx, const int* lgc_ptr,
                       const int* lgc_row, const double* lgc_val, int two_u,
                       const double* selfvec, int nchem, int self_all,
                       int threads, int per, int stride,
                       const long long* bs_key,
                       const double* bs_fac, const int* bs_seg, int W,
                       const double* bzero, double* ut, double* B,
                       void* stream) {
  return nn_ut_b_launch<double>(
      disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, n_t, pidx, qidx, lgc_ptr, lgc_row, lgc_val,
      two_u, selfvec, nchem, self_all, threads, per, stride, bs_key, bs_fac,
      bs_seg, W, bzero, ut, B, stream);
}

// The float32 instantiation: disp, elem, lgc_val, selfvec, bs_fac, bzero,
// ut and B f32 (a float32 plan's tables), the scalars f64 (rounded to f32
// in the prologue).
extern "C" int nn_ut_b_f32(const float* disp, const int* jelem,
                           const unsigned char* mask, const int* ielem,
                           const float* elem, double rcutfac, double rfac0,
                           double rmin0, int switchflag, int switchinnerflag,
                           long long natoms, int K, int n_t, const int* pidx,
                           const int* qidx, const int* lgc_ptr,
                           const int* lgc_row, const float* lgc_val,
                           int two_u, const float* selfvec, int nchem,
                           int self_all, int threads, int per, int stride,
                           const long long* bs_key, const float* bs_fac,
                           const int* bs_seg, int W, const float* bzero,
                           float* ut, float* B, void* stream) {
  return nn_ut_b_launch<float>(
      disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, n_t, pidx, qidx, lgc_ptr, lgc_row, lgc_val,
      two_u, selfvec, nchem, self_all, threads, per, stride, bs_key, bs_fac,
      bs_seg, W, bzero, ut, B, stream);
}

// vg (N, n_t, n_t) f64 and the pairs as nn_ut_b's.  Writes g (N, K, 3).
// Four warps a block (four blocks an SM), or eight (two) where the atoms
// fit one wave of two blocks an SM: a block's chain is then the time.
extern "C" int nn_pair_force(const double* vg, const double* disp,
                             const int* jelem, const unsigned char* mask,
                             const int* ielem, const double* elem,
                             double rcutfac, double rfac0, double rmin0,
                             int switchflag, int switchinnerflag,
                             long long natoms, int K, int n_t,
                             const int* pidx, const int* qidx, double* g,
                             void* stream) {
  return nn_pair_force_launch<double>(
      vg, disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, n_t, pidx, qidx, g, stream);
}

// The float32 instantiation: vg, disp, elem and g f32.
extern "C" int nn_pair_force_f32(const float* vg, const float* disp,
                                 const int* jelem, const unsigned char* mask,
                                 const int* ielem, const float* elem,
                                 double rcutfac, double rfac0, double rmin0,
                                 int switchflag, int switchinnerflag,
                                 long long natoms, int K, int n_t,
                                 const int* pidx, const int* qidx, float* g,
                                 void* stream) {
  return nn_pair_force_launch<float>(
      vg, disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0, switchflag,
      switchinnerflag, natoms, K, n_t, pidx, qidx, g, stream);
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
  return nn_pair_force_t_launch<double>(
      gF, jidx, disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0,
      switchflag, switchinnerflag, natoms, A, K, n_t, pidx, qidx, vgc,
      stream);
}

// The float32 instantiation: gF, disp, elem and vgc f32.
extern "C" int nn_pair_force_t_f32(const float* gF, const int* jidx,
                                   const float* disp, const int* jelem,
                                   const unsigned char* mask,
                                   const int* ielem, const float* elem,
                                   double rcutfac, double rfac0,
                                   double rmin0, int switchflag,
                                   int switchinnerflag, long long natoms,
                                   int A, int K, int n_t, const int* pidx,
                                   const int* qidx, float* vgc,
                                   void* stream) {
  return nn_pair_force_t_launch<float>(
      gF, jidx, disp, jelem, mask, ielem, elem, rcutfac, rfac0, rmin0,
      switchflag, switchinnerflag, natoms, A, K, n_t, pidx, qidx, vgc,
      stream);
}
