// K13 ace_pair_basis: per pair the ACE one-particle basis
//   phi[a, k, s] = g_n(r) fin(r) [jelem == mu] Yhat_lm(D / r)
// for every A-slot s = (mu, n, l, m) of the plan (l = -1: the rank-1 radial
// slot, no spherical harmonic), its three displacement tangents
//   Jp[c, a, k, s] = d phi[a, k, s] / d D[a, k, c]   (real part at s,
//                                                     imaginary at nA + s)
// and the neighbor sum A[a, s] = sum_k phi[a, k, s], with A[a, 0] = 1.
// g_n is ML-PACE's ChebExpCos radial base ("pace_px": g_1 = env,
// g_n = (1 - T_{n-1}(x)) / 2 env), fin the optional distance-type inner
// ramp, Yhat_lm = sqrt(4 pi) Y_lm (ML-PACE normalisation, Y_00 = 1).
//
// Replaces fitsnap_tpu/ops/ace.py `ace_pair_phi` (:589) with
// `chebexpcos_basis` (:406) and `sph_harm` (:524), `ace_a_basis` (:656)
// and the jvp of `ace_descriptors_with_jacobian` (:671-676).
//
// Bound on the H100: bytes.  The kernel must write Jp (3 x K x 2 nA
// doubles per atom, 120 KB at K = 64, nA = 39); its FP64 work per pair
// (the radial and Ylm recursions with their derivatives, a few hundred
// flops, then 10 flops per slot and direction) is well under what the
// card's FP64 rate does while HBM takes Jp.
//
// Design: one block per atom, neighbors in tiles of KT.  Per neighbor one
// thread computes r, the unit vector, g_n and dg_n/dr (the Chebyshev
// recursion carried with its derivative), and Yhat_lm with its Cartesian
// gradient through d(unit)/dD = (I - u u^T) / r, into shared memory.  Then
// the block forms phi and Jp for every (neighbor, slot) from a host-built
// slot table (mu, n, l, m), writing Jp with neighbouring threads on
// neighbouring slots, and each slot's owner thread adds the tile's phi to
// its sum in neighbor order: A repeats bit for bit, no atomics.  Masked
// pairs take the displacement (1, 0, 0) and weight 0: exactly zero phi and
// zero tangents.
#include "common.cuh"

namespace {

constexpr int KT = 16;           // neighbors per tile
constexpr int THREADS = 128;
constexpr int LMAX = 6;          // largest l of the kernel
constexpr int NP = (LMAX + 1) * (LMAX + 2) / 2;
constexpr double PI = 3.14159265358979323846;

struct Args {
  const double* disp;            // (N, K, 3)
  const int* jelem;              // (N, K)
  const bool* mask;              // (N, K)
  const int* ielem;              // (N,)
  const double* rcut;            // (T, T) per bond
  const double* lmbda;
  const double* rcin;
  const double* dcin;
  const int* slot;               // (nA, 4): mu, n, l, m; slot 0 unused
  int T, inner, nA, nrad, lmax, K;
  long long N;
};

// Shared-memory record of one neighbor: g and dg/dr (nrad each), the unit
// vector (3), Yhat re / im (ny each), their gradients d/dD_c (3 ny each).
__device__ __forceinline__ int record_len(int nrad, int ny) {
  return 2 * nrad + 3 + 8 * ny;
}

__device__ void neighbor_record(const Args& p, long long a, int k,
                                double* rec, int* jel) {
  const int ny = (p.lmax + 1) * (p.lmax + 1);
  double* g = rec;
  double* dg = g + p.nrad;
  double* u = dg + p.nrad;
  double* yr = u + 3;
  double* yi = yr + ny;
  double* dyr = yi + ny;          // [3][ny]
  double* dyi = dyr + 3 * ny;     // [3][ny]
  const long long q = a * p.K + k;
  const bool on = p.mask[q];
  double dx = 1.0, dy = 0.0, dz = 0.0;
  if (on) {
    dx = p.disp[3 * q];
    dy = p.disp[3 * q + 1];
    dz = p.disp[3 * q + 2];
  }
  const int je = p.jelem[q];
  *jel = je;
  const int bond = p.ielem[a] * p.T + je;
  const double r = sqrt(dx * dx + dy * dy + dz * dz);
  const double x = dx / r, y = dy / r, z = dz / r;
  u[0] = x;
  u[1] = y;
  u[2] = z;

  // radial base with its r derivative, times the inner ramp and the mask
  const double rc = p.rcut[bond];
  const double lam = p.lmbda[bond];
  double fin = 1.0, dfin = 0.0;
  if (p.inner) {
    const double din = p.dcin[bond];
    const double dsafe = din > 1e-12 ? din : 1e-12;
    const double t = (r - (p.rcin[bond] - din)) / dsafe;
    if (t <= 0.0) {
      fin = 0.0;
    } else if (t < 1.0) {
      fin = 0.5 * (1.0 - cos(PI * t));
      dfin = 0.5 * PI * sin(PI * t) / dsafe;
    }
  }
  const bool live = on && r < rc;
  if (live) {
    // pace_px: x = 1 - 2 (e^{lambda (1 - r/rc)} - 1) / (e^lambda - 1),
    // increasing from -1 at r = 0 to 1 at r = rc
    const double x0 = r / rc;
    const double den = exp(lam) - 1.0;
    const double el = exp(lam * (1.0 - x0));
    double xs = 1.0 - 2.0 * (el - 1.0) / den;
    double dxs = 2.0 * lam * el / den / rc;
    if (xs < -1.0 || xs > 1.0) {
      xs = xs < -1.0 ? -1.0 : 1.0;
      dxs = 0.0;
    }
    const double cz = 0.5 * (1.0 + cos(PI * x0));
    const double dcz = -0.5 * PI * sin(PI * x0) / rc;
    // T_{n-1}(xs) and its xs-derivative, carried up the recursion
    double tm = 1.0, dtm = 0.0;   // T_{n-2}
    double tc = xs, dtc = 1.0;    // T_{n-1}
    g[0] = cz * fin;
    dg[0] = dcz * fin + cz * dfin;
    for (int n = 2; n <= p.nrad; ++n) {
      if (n > 2) {
        const double tn = 2.0 * xs * tc - tm;
        const double dtn = 2.0 * tc + 2.0 * xs * dtc - dtm;
        tm = tc;
        dtm = dtc;
        tc = tn;
        dtc = dtn;
      }
      const double h = 0.5 * (1.0 - tc);
      const double dh = -0.5 * dtc * dxs;
      g[n - 1] = h * cz * fin;
      dg[n - 1] = (dh * cz + h * dcz) * fin + h * cz * dfin;
    }
  } else {
    for (int n = 0; n < p.nrad; ++n) {
      g[n] = 0.0;
      dg[n] = 0.0;
    }
  }

  // associated Legendre polynomials P_lm(z) (sin^m factored out) and dP/dz
  double P[NP], dP[NP];
  P[0] = 1.0;
  dP[0] = 0.0;
  for (int m = 1; m <= p.lmax; ++m) {
    const int i = m * (m + 1) / 2 + m, j = (m - 1) * m / 2 + m - 1;
    P[i] = P[j] * (2 * m - 1);
    dP[i] = 0.0;
  }
  for (int m = 0; m < p.lmax; ++m) {
    const int i = (m + 1) * (m + 2) / 2 + m, j = m * (m + 1) / 2 + m;
    P[i] = z * (2 * m + 1) * P[j];
    dP[i] = (2 * m + 1) * P[j];
  }
  for (int m = 0; m <= p.lmax; ++m) {
    for (int l = m + 2; l <= p.lmax; ++l) {
      const int i = l * (l + 1) / 2 + m;
      const int i1 = (l - 1) * l / 2 + m, i2 = (l - 2) * (l - 1) / 2 + m;
      P[i] = ((2 * l - 1) * z * P[i1] - (l + m - 1) * P[i2]) / (l - m);
      dP[i] = ((2 * l - 1) * (P[i1] + z * dP[i1]) - (l + m - 1) * dP[i2]) /
              (l - m);
    }
  }
  // (x + i y)^m
  double er[LMAX + 1], ei[LMAX + 1];
  er[0] = 1.0;
  ei[0] = 0.0;
  for (int m = 1; m <= p.lmax; ++m) {
    er[m] = er[m - 1] * x - ei[m - 1] * y;
    ei[m] = er[m - 1] * y + ei[m - 1] * x;
  }
  const double rinv = 1.0 / r;
  for (int l = 0; l <= p.lmax; ++l) {
    for (int m = 0; m <= l; ++m) {
      double ratio = 1.0;  // (l - m)! / (l + m)!
      for (int f = l - m + 1; f <= l + m; ++f) ratio /= f;
      const double c = ((m & 1) ? -1.0 : 1.0) * sqrt((2 * l + 1) * ratio);
      const double pl = P[l * (l + 1) / 2 + m];
      const double dpl = dP[l * (l + 1) / 2 + m];
      const double vr = c * pl * er[m], vi = c * pl * ei[m];
      // partial derivatives in (x, y, z) of the polynomial form
      double gr[3], gi[3];
      if (m > 0) {
        gr[0] = c * pl * m * er[m - 1];
        gi[0] = c * pl * m * ei[m - 1];
        gr[1] = -c * pl * m * ei[m - 1];
        gi[1] = c * pl * m * er[m - 1];
      } else {
        gr[0] = gi[0] = gr[1] = gi[1] = 0.0;
      }
      gr[2] = c * dpl * er[m];
      gi[2] = c * dpl * ei[m];
      // chain rule through the unit vector: (g_c - u_c (u . g)) / r
      const double ur = x * gr[0] + y * gr[1] + z * gr[2];
      const double ui = x * gi[0] + y * gi[1] + z * gi[2];
      double tr[3], ti[3];
      for (int d = 0; d < 3; ++d) {
        tr[d] = (gr[d] - u[d] * ur) * rinv;
        ti[d] = (gi[d] - u[d] * ui) * rinv;
      }
      const int ip = l * l + l + m;
      yr[ip] = vr;
      yi[ip] = vi;
      for (int d = 0; d < 3; ++d) {
        dyr[d * ny + ip] = tr[d];
        dyi[d * ny + ip] = ti[d];
      }
      if (m > 0) {
        // Y_{l,-m} = (-1)^m conj(Y_lm)
        const double s = (m & 1) ? -1.0 : 1.0;
        const int in = l * l + l - m;
        yr[in] = s * vr;
        yi[in] = -s * vi;
        for (int d = 0; d < 3; ++d) {
          dyr[d * ny + in] = s * tr[d];
          dyi[d * ny + in] = -s * ti[d];
        }
      }
    }
  }
}

__global__ void ace_pair_basis_kernel(Args p, double* __restrict__ A,
                                      double* __restrict__ Jp) {
  extern __shared__ double sm[];
  const int ny = (p.lmax + 1) * (p.lmax + 1);
  const int rl = record_len(p.nrad, ny);
  const int two_a = 2 * p.nA;
  double* rec = sm;                        // [KT][rl]
  double* ph = rec + KT * rl;              // [KT][2 nA] phi of the tile
  double* acc = ph + KT * two_a;           // [2 nA] running sum over k
  int* jel = reinterpret_cast<int*>(acc + two_a);   // [KT]
  const long long a = blockIdx.x;
  const int tid = threadIdx.x;
  const long long jstride = p.N * p.K * two_a;      // one direction c of Jp

  for (int s = tid; s < two_a; s += THREADS) acc[s] = 0.0;
  for (int k0 = 0; k0 < p.K; k0 += KT) {
    const int nk = p.K - k0 < KT ? p.K - k0 : KT;
    if (tid < nk) neighbor_record(p, a, k0 + tid, rec + tid * rl, jel + tid);
    __syncthreads();
    for (int idx = tid; idx < nk * p.nA; idx += THREADS) {
      const int kk = idx / p.nA;
      const int s = idx % p.nA;
      const double* g = rec + kk * rl;
      const double* dg = g + p.nrad;
      const double* u = dg + p.nrad;
      const double* yr = u + 3;
      const double* yi = yr + ny;
      const double* dyr = yi + ny;
      const double* dyi = dyr + 3 * ny;
      double vr = 0.0, vi = 0.0, tr[3] = {0.0, 0.0, 0.0},
             ti[3] = {0.0, 0.0, 0.0};
      if (s > 0) {
        const int mu = p.slot[4 * s], n = p.slot[4 * s + 1];
        const int l = p.slot[4 * s + 2], m = p.slot[4 * s + 3];
        const bool ch = jel[kk] == mu;
        const double base = ch ? g[n - 1] : 0.0;
        const double dbase = ch ? dg[n - 1] : 0.0;
        if (l < 0) {
          vr = base;
          for (int c = 0; c < 3; ++c) tr[c] = dbase * u[c];
        } else {
          const int ip = l * l + l + m;
          vr = base * yr[ip];
          vi = base * yi[ip];
          for (int c = 0; c < 3; ++c) {
            tr[c] = dbase * u[c] * yr[ip] + base * dyr[c * ny + ip];
            ti[c] = dbase * u[c] * yi[ip] + base * dyi[c * ny + ip];
          }
        }
      }
      ph[kk * two_a + s] = vr;
      ph[kk * two_a + p.nA + s] = vi;
      const long long o = (a * p.K + k0 + kk) * two_a + s;
      for (int c = 0; c < 3; ++c) {
        Jp[c * jstride + o] = tr[c];
        Jp[c * jstride + o + p.nA] = ti[c];
      }
    }
    __syncthreads();
    for (int s = tid; s < two_a; s += THREADS) {
      double v = acc[s];
      for (int kk = 0; kk < nk; ++kk) v += ph[kk * two_a + s];
      acc[s] = v;
    }
    __syncthreads();
  }
  for (int s = tid; s < two_a; s += THREADS)
    A[a * two_a + s] = s == 0 ? 1.0 : acc[s];
}

}  // namespace

// disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K) bool, ielem (N,) i32;
// per-bond rcut, lmbda, rcin, dcin (T, T) f64; inner: apply the inner ramp;
// slot (nA, 4) i32 A-slot table (mu, n, l, m); nrad radial functions;
// lmax <= 6.  Writes A (N, 2 nA) [Re | Im] and Jp (3, N, K, 2 nA).
extern "C" int ace_pair_basis(const double* disp, const int* jelem,
                              const bool* mask, const int* ielem,
                              const double* rcut, const double* lmbda,
                              const double* rcin, const double* dcin, int T,
                              int inner, const int* slot, int nA, int nrad,
                              int lmax, long long N, int K, double* A,
                              double* Jp, void* stream) {
  if (lmax > LMAX || lmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args p{disp, jelem, mask, ielem, rcut, lmbda, rcin, dcin, slot,
               T, inner, nA, nrad, lmax, K, N};
  const int ny = (lmax + 1) * (lmax + 1);
  const size_t smem = sizeof(double) * (static_cast<size_t>(KT) *
                                            (2 * nrad + 3 + 8 * ny) +
                                        static_cast<size_t>(KT + 1) * 2 * nA) +
                      sizeof(int) * KT;
  const int err = fs_allow_smem(ace_pair_basis_kernel, smem);
  if (err) return err;
  if (N > 0) {
    ace_pair_basis_kernel<<<static_cast<unsigned>(N), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(p, A, Jp);
  }
  return static_cast<int>(cudaGetLastError());
}
