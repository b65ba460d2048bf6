// K13 ace_pair_basis: per pair the ACE one-particle basis
//   phi[a, k, s] = g_n(r) fin(r) [jelem == mu] Yhat_lm(D / r)
// for every A-slot s = (mu, n, l, m) of the plan (l = -1: the rank-1 radial
// slot, no spherical harmonic), its three displacement tangents
//   Jp[c, a, k, s] = d phi[a, k, s] / d D[a, k, c]   (real part at s,
//                                                     imaginary at nA + s)
// and the neighbor sum A[a, s] = sum_k phi[a, k, s], with A[a, 0] = 1.
// g_n is the ChebExpCos radial base in any of the plan's six closed-form
// variants, given as a host-built code: which way x runs, its sign, the
// PACE stack (g_1 = env, g_n = (1 - T_{n-1}(x)) / 2 env) or the T stack
// (g_n = T_{n-1}(x) env, or T_n with T_0 skipped); fin is the optional
// distance-type inner ramp; Yhat_lm = s_l Y_lm in the plan's convention
// (s_l = sqrt(4 pi), 1 or sqrt(4 pi / (2l + 1)), folded into the host's
// normalisation table).  A spline plan (ML-PACE's radials) takes g_n and
// dg_n/dr from host-built cubic Hermite tables instead: per bond, bin
// b = floor(r / delta) and t = r / delta - b,
//   g_n = ((c3 t + c2) t + c1) t + c0,  dg_n/dr = ((3 c3 t + 2 c2) t + c1) / delta
// with the bin's four coefficients of each n read from device memory.
//
// Replaces fitsnap_tpu/ops/ace.py `ace_pair_phi` (:589) with
// `chebexpcos_basis` (:406), `spline_radial_basis` (:483) and `sph_harm`
// (:524), `ace_a_basis` (:656) and the jvp of
// `ace_descriptors_with_jacobian` (:671-676).
//
// Bound on the H100: bytes.  The kernel must write Jp (3 x K x 2 nA
// doubles per atom, 120 KB at K = 64, nA = 39); its FP64 work per pair
// (the radial and Legendre recursions with their derivatives, a few hundred
// flops, then 12 flops per slot column) is well under what the card's FP64
// rate does while HBM takes Jp.
//
// Design: one block per atom, W warps (the wrapper's choice), each on its
// own until the final sum: warp w takes the tiles of NW neighbors starting
// at k0 = (w + i W) NW.  Per tile:
//   1. records in shared memory, in two rounds of uniform work: first the
//      radial items, a neighbor a lane (1 / r, the unit vector, then the
//      radial recursion with its r derivative, g_n and dg_n/dr), then the
//      Legendre columns, a (neighbor, m) item a lane with the same m on
//      neighboring lanes: the column with its z derivative, scaled by the
//      host's normalisation, times (x + i y)^m, gives Yhat_lm and its
//      Cartesian gradient for l = m..lmax.  The host tabulates the
//      normalisations and the recursion's coefficients (2l-1)/(l-m) and
//      (l+m-1)/(l-m): the kernel divides by no l or m and takes no
//      factorial or sqrt of a constant; it divides once by r, rc and
//      e^lambda - 1 a pair and multiplies after.  A record's (l, m) entries
//      are ENTRY = 9 doubles apart, so the entries that neighboring lanes
//      read in step 2 fall in different shared-memory banks;
//   2. Jp: the tile's rows of one direction c are one contiguous run of
//      NW x 2 nA doubles; lanes take consecutive 16-byte pairs of columns
//      of it, the (neighbor, pair) index advanced by the launch shape (a
//      carry, no div/mod), and form the pair's three directions from the
//      record and a host-built column table (the record offsets of the
//      slot's Yhat part and its gradient, the sign of m < 0, n and mu):
//      three 16-byte stores.  The structurally zero columns (slot 0, the
//      imaginary parts of the radial slots and of m = 0) are written too;
//   3. A: each lane adds phi of its own columns over the tile's neighbors,
//      in neighbor order, to the warp's partial sums.
// Only __syncwarp separates these steps, so no barrier holds the block's
// other warps, or the SM's other blocks, out of their stores while one
// warp builds records.  After its last tile the block sums its warps'
// partials in warp order: A repeats bit for bit, no atomics.  Masked pairs
// take the displacement (1, 0, 0) and weight 0, and pairs at or beyond the
// cutoff weight 0: exactly zero phi and tangents.  The working set (the
// column table, W partial sums and W x NW records) is the wrapper's
// `k13_shape`; no lmax is refused that fits a block's shared memory.  The
// spline tables (ceil(rc / delta) + 1 bins x nrad x 4 doubles a bond, a
// few MB at delta 0.001) are far over a block's shared memory: a radial
// item reads its bin's 4 nrad doubles, one contiguous run, through L2.
#include "common.cuh"

namespace {

constexpr double PI = 3.14159265358979323846;
constexpr int ENTRY = 9;         // doubles of a (l, m) entry of a record

struct Args {
  const double* disp;            // (N, K, 3)
  const int* jelem;              // (N, K)
  const bool* mask;              // (N, K)
  const int* ielem;              // (N,)
  const double* rcut;            // (T, T) per bond
  const double* lmbda;
  const double* rcin;
  const double* dcin;
  const double* ytab;            // (3, ne): normalisation, a, b of (l, m)
  const int4* cols;              // (2 nA): Yhat, gradient, n - 1, sign (mu + 1)
  const double* spline;          // (T * T, nlut, nrad, 4) or null
  int T, inner, radial, nA, nrad, lmax, K, nw_log, rl, nlut;
  double delta;                  // the spline's bin width
  long long N;
};

// A neighbor's record (doubles): g (nrad), dg/dr (nrad), the unit vector
// and 1 / r (4), then per (l, m >= 0) at e = l (l + 1) / 2 + m an entry of
// ENTRY doubles: Yhat re, im, d/dD_c re (3), d/dD_c im (3); then one
// constant entry (1, 0, ...) that the rank-1 radial slots read
// (kernels/ace_kernels.py `k13_record`).

// Radial code bits (kernels/ace_kernels.py `radial_code`).
constexpr int RAD_X_UP = 1;      // x from e^{lambda r / rc} (pace_x*)
constexpr int RAD_NEG = 2;       // x negated (every pace* but pace_px)
constexpr int RAD_PACE = 4;      // the PACE stack
constexpr int RAD_T1 = 8;        // the T stack from T_1 (v0_t1)

// A neighbor's radial item: its displacement (1, 0, 0 where masked), unit
// vector, 1 / r and element into the record, then g_n and dg_n/dr with the
// inner ramp (zero unless the pair is live and r < rc).
__device__ void radial_item(const Args& p, long long a, int k, double* rec,
                            int* jel) {
  const long long q = a * p.K + k;
  const bool on = p.mask[q];
  double dx = 1.0, dy = 0.0, dz = 0.0;
  if (on) {
    dx = p.disp[3 * q];
    dy = p.disp[3 * q + 1];
    dz = p.disp[3 * q + 2];
  }
  const double r = sqrt(dx * dx + dy * dy + dz * dz);
  const double rinv = 1.0 / r;
  double* u = rec + 2 * p.nrad;
  u[0] = dx * rinv;
  u[1] = dy * rinv;
  u[2] = dz * rinv;
  u[3] = rinv;
  const int je = p.jelem[q];
  *jel = je;
  double* g = rec;
  double* dg = rec + p.nrad;
  const int bond = p.ielem[a] * p.T + je;
  const double rc = p.rcut[bond];
  if (!(on && r < rc)) {
    for (int n = 0; n < p.nrad; ++n) {
      g[n] = 0.0;
      dg[n] = 0.0;
    }
    return;
  }
  double fin = 1.0, dfin = 0.0;
  if (p.inner) {
    const double din = p.dcin[bond];
    const double dsi = 1.0 / (din > 1e-12 ? din : 1e-12);
    const double t = (r - (p.rcin[bond] - din)) * dsi;
    if (t <= 0.0) {
      fin = 0.0;
    } else if (t < 1.0) {
      double s, c;
      sincospi(t, &s, &c);
      fin = 0.5 * (1.0 - c);
      dfin = 0.5 * PI * s * dsi;
    }
  }
  if (p.spline) {
    const double xs = r / p.delta;
    double b = floor(xs);
    b = b < 0.0 ? 0.0 : (b > p.nlut - 1 ? p.nlut - 1 : b);
    const double t = xs - b;
    const double* c =
        p.spline + (static_cast<long long>(bond) * p.nlut +
                    static_cast<int>(b)) * p.nrad * 4;
    for (int n = 0; n < p.nrad; ++n) {
      const double c0 = c[4 * n], c1 = c[4 * n + 1], c2 = c[4 * n + 2],
                   c3 = c[4 * n + 3];
      const double h = ((c3 * t + c2) * t + c1) * t + c0;
      const double dh = ((3.0 * c3 * t + 2.0 * c2) * t + c1) / p.delta;
      g[n] = h * fin;
      dg[n] = dh * fin + h * dfin;
    }
    return;
  }
  const double lam = p.lmbda[bond];
  const double rci = 1.0 / rc;
  const double x0 = r * rci;
  const double deni = 1.0 / (exp(lam) - 1.0);
  double el, dx0;
  if (p.radial & RAD_X_UP) {
    el = exp(lam * x0);
    dx0 = -2.0 * lam * el * deni * rci;
  } else {
    el = exp(lam * (1.0 - x0));
    dx0 = 2.0 * lam * el * deni * rci;
  }
  double x = 1.0 - 2.0 * (el - 1.0) * deni;
  if (x < -1.0 || x > 1.0) {
    x = x < -1.0 ? -1.0 : 1.0;
    dx0 = 0.0;
  }
  if (p.radial & RAD_NEG) {
    x = -x;
    dx0 = -dx0;
  }
  double sz, cz0;
  sincospi(x0, &sz, &cz0);
  const double cz = 0.5 * (1.0 + cz0);
  const double dcz = -0.5 * PI * sz * rci;
  const bool pace = p.radial & RAD_PACE;
  const int skip = (!pace && (p.radial & RAD_T1)) ? 1 : 0;
  // (tc, dtc) = T_t(x) and dT_t/dr, (tm, dtm) = T_{t-1}
  double tm = 0.0, dtm = 0.0, tc = 1.0, dtc = 0.0;
  for (int t = 0; t < p.nrad + skip; ++t) {
    if (t == 1) {
      tm = tc;
      dtm = dtc;
      tc = x;
      dtc = dx0;
    } else if (t > 1) {
      const double tn = 2.0 * x * tc - tm;
      const double dtn = 2.0 * dx0 * tc + 2.0 * x * dtc - dtm;
      tm = tc;
      dtm = dtc;
      tc = tn;
      dtc = dtn;
    }
    if (t < skip) continue;
    double h, dh;
    if (!pace) {
      h = tc;
      dh = dtc;
    } else if (t == 0) {
      h = 1.0;
      dh = 0.0;
    } else {
      h = 0.5 * (1.0 - tc);
      dh = -0.5 * dtc;
    }
    const int n = t - skip;
    g[n] = h * cz * fin;
    dg[n] = (dh * cz + h * dcz) * fin + h * cz * dfin;
  }
}

// Legendre column m (sin^m factored out) with its z derivative, times the
// normalisation and (x + i y)^m: Yhat_lm and its gradient for l = m..lmax,
// from the unit vector and 1 / r of the neighbor's record.
__device__ void ylm_item(const Args& p, int m, double* rec) {
  const int ne = (p.lmax + 1) * (p.lmax + 2) / 2;
  const double* __restrict__ norm = p.ytab;
  const double* __restrict__ ca = p.ytab + ne;
  const double* __restrict__ cb = p.ytab + 2 * ne;
  const double* u = rec + 2 * p.nrad;
  const double x = u[0], y = u[1], z = u[2], rinv = u[3];
  double* yrec = rec + 2 * p.nrad + 4;
  double er = 1.0, ei = 0.0, erm = 0.0, eim = 0.0;   // (x + i y)^m, ^(m-1)
  for (int s = 0; s < m; ++s) {
    erm = er;
    eim = ei;
    const double t = er * x - ei * y;
    ei = er * y + ei * x;
    er = t;
  }
  int e = m * (m + 3) / 2;                           // (l, m) at l = m
  double p1 = ca[e], dp1 = 0.0, p2 = 0.0, dp2 = 0.0; // P_{l-1}, P_{l-2}
  for (int l = m; l <= p.lmax; ++l) {
    if (l > m) {
      const double pl = ca[e] * z * p1 - cb[e] * p2;
      const double dpl = ca[e] * (p1 + z * dp1) - cb[e] * dp2;
      p2 = p1;
      dp2 = dp1;
      p1 = pl;
      dp1 = dpl;
    }
    const double pl = norm[e] * p1, dpl = norm[e] * dp1;
    double gr0 = 0.0, gr1 = 0.0, gi0 = 0.0, gi1 = 0.0;
    if (m > 0) {
      gr0 = pl * m * erm;
      gi0 = pl * m * eim;
      gr1 = -pl * m * eim;
      gi1 = pl * m * erm;
    }
    const double gr2 = dpl * er, gi2 = dpl * ei;
    // chain rule through the unit vector: (g_c - u_c (u . g)) / r
    const double ur = x * gr0 + y * gr1 + z * gr2;
    const double ui = x * gi0 + y * gi1 + z * gi2;
    double* o = yrec + ENTRY * e;
    o[0] = pl * er;
    o[1] = pl * ei;
    o[2] = (gr0 - x * ur) * rinv;
    o[3] = (gr1 - y * ur) * rinv;
    o[4] = (gr2 - z * ur) * rinv;
    o[5] = (gi0 - x * ui) * rinv;
    o[6] = (gi1 - y * ui) * rinv;
    o[7] = (gi2 - z * ui) * rinv;
    e += l + 1;                                      // (l + 1, m)
  }
}

// The value (phi, or d phi / dD_c for c = 0..2) of one column of a record.
struct Column {
  double v, d[3];
};

__device__ __forceinline__ Column column(const double* rj, int je, int4 t,
                                         int nrad) {
  Column o;
  const int mu = (t.w < 0 ? -t.w : t.w) - 1;
  const double sg = t.w < 0 ? -1.0 : 1.0;
  double base = 0.0, dbase = 0.0;
  if (t.w != 0 && je == mu) {
    base = rj[t.z];
    dbase = rj[nrad + t.z];
  }
  const double* u = rj + 2 * nrad;   // unit vector
  const double yv = sg * rj[t.x];
  o.v = base * yv;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o.d[c] = dbase * u[c] * yv + base * (sg * rj[t.y + c]);
  return o;
}

__global__ void ace_pair_basis_kernel(Args p, double* __restrict__ A,
                                      double* __restrict__ Jp) {
  extern __shared__ __align__(16) double sm[];
  const int two_a = 2 * p.nA;
  const int nw = 1 << p.nw_log;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int4* cols = reinterpret_cast<int4*>(sm);                   // [2 nA]
  double* acc = sm + 2 * two_a;                               // [W][2 nA]
  double* rec = acc + warps * two_a + warp * nw * p.rl;       // [NW][rl]
  int* jel = reinterpret_cast<int*>(acc + warps * two_a +
                                    warps * nw * p.rl) + warp * nw;
  double* wacc = acc + warp * two_a;
  const long long a = blockIdx.x;
  const int c0 = 2 * p.nrad + 4 + ENTRY * (p.lmax + 1) * (p.lmax + 2) / 2;
  const long long jstride = p.N * p.K * two_a / 2;    // one direction, in pairs

  for (int s = threadIdx.x; s < two_a; s += blockDim.x) cols[s] = p.cols[s];
  for (int s = lane; s < two_a; s += 32) wacc[s] = 0.0;
  for (int j = lane; j < nw; j += 32) {
    double* cst = rec + j * p.rl + c0;
    cst[0] = 1.0;
    for (int i = 1; i < 8; ++i) cst[i] = 0.0;
  }
  __syncthreads();

  for (int k0 = warp * nw; k0 < p.K; k0 += warps * nw) {
    const int nk = p.K - k0 < nw ? p.K - k0 : nw;
    // 1. the tile's records: the radial items, a neighbor a lane, then
    // the Legendre columns, (neighbor, m) items with m the round's
    for (int j = lane; j < nk; j += 32)
      radial_item(p, a, k0 + j, rec + j * p.rl, jel + j);
    __syncwarp();
    for (int i = lane; i < (p.lmax + 1) << p.nw_log; i += 32) {
      const int j = i & (nw - 1);
      if (j < nk) ylm_item(p, i >> p.nw_log, rec + j * p.rl);
    }
    __syncwarp();
    // 2. Jp: consecutive column pairs of the tile's contiguous run
    double2* out = reinterpret_cast<double2*>(Jp + (a * p.K + k0) * two_a);
    int j = 0, q = lane;
    while (q >= p.nA) {
      q -= p.nA;
      ++j;
    }
    for (long long e = lane; j < nk; e += 32) {
      const double* rj = rec + j * p.rl;
      const int je = jel[j];
      const Column lo = column(rj, je, cols[2 * q], p.nrad);
      const Column hi = column(rj, je, cols[2 * q + 1], p.nrad);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        out[c * jstride + e] = make_double2(lo.d[c], hi.d[c]);
      q += 32;
      while (q >= p.nA) {
        q -= p.nA;
        ++j;
      }
    }
    // 3. A: each lane's columns over the tile's neighbors, in order
    for (int s = lane; s < two_a; s += 32) {
      const int4 t = cols[s];
      double v = wacc[s];
      for (int jj = 0; jj < nk; ++jj)
        v += column(rec + jj * p.rl, jel[jj], t, p.nrad).v;
      wacc[s] = v;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int s = threadIdx.x; s < two_a; s += blockDim.x) {
    double v = 0.0;
    for (int w = 0; w < warps; ++w) v += acc[w * two_a + s];
    A[a * two_a + s] = s == 0 ? 1.0 : v;
  }
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) bool, ielem (N,) i32;
// per-bond rcut, lmbda, rcin, dcin (T, T) f64; inner: apply the inner ramp;
// radial: the radial variant's code; ytab (3, (lmax + 1)(lmax + 2) / 2)
// f64 normalisations and recursion coefficients; cols (2 nA, 4) i32 the
// column table; spline (T * T, nlut, nrad, 4) f64 the Hermite tables of a
// spline plan, bin width delta, or null (the closed-form radial); nrad
// radial functions; the launch shape: warps a block,
// 2^nw_log neighbors a tile, rl doubles a record, smem bytes of shared
// memory (kernels/ace_kernels.py `k13_shape`).  Writes A (N, 2 nA)
// [Re | Im] and Jp (3, N, K, 2 nA).
extern "C" int ace_pair_basis(const double* disp, const int* jelem,
                              const bool* mask, const int* ielem,
                              const double* rcut, const double* lmbda,
                              const double* rcin, const double* dcin, int T,
                              int inner, int radial, const double* ytab,
                              const int* cols, const double* spline,
                              int nlut, double delta, int nA, int nrad,
                              int lmax,
                              long long N, int K, int warps, int nw_log,
                              int rl, int smem, double* A, double* Jp,
                              void* stream) {
  if (lmax < 0 || warps < 1 || warps > 32 || nw_log < 0 || nw_log > 5 ||
      static_cast<size_t>(smem) > FS_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (spline && (nlut < 1 || !(delta > 0.0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{disp, jelem, mask, ielem, rcut, lmbda, rcin, dcin, ytab,
               reinterpret_cast<const int4*>(cols), spline, T, inner, radial,
               nA, nrad, lmax, K, nw_log, rl, nlut, delta, N};
  const int err = fs_allow_smem(ace_pair_basis_kernel,
                                static_cast<size_t>(smem));
  if (err) return err;
  if (N > 0) {
    ace_pair_basis_kernel<<<static_cast<unsigned>(N), 32 * warps, smem,
                            static_cast<cudaStream_t>(stream)>>>(p, A, Jp);
  }
  return static_cast<int>(cudaGetLastError());
}
