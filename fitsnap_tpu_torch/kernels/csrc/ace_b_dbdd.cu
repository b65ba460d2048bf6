// K14 ace_b_dbdd: per atom, the ACE descriptors
//   B[a, l] = sum_{t in l} coef_t Re(prod_r A[a, f_{t,r}])
// over the plan's product terms, the leave-one-out jacobian dB/dA (each
// factor's cofactor prefix_r x suffix_r, summed into the A-slots each label
// touches), and its contraction with the pair tangents of K13
//   dBdD[a, l, k, c] = sum_e dBdA[a, e] Jp[c, a, k, slot_e].
// Labels whose central element mu0 is not the atom's element give zero, and
// their entries are not computed: labels are sorted by mu0, so the entries
// of element e are the range [el_e[e], el_e[e + 1]).
//
// Replaces fitsnap_tpu/ops/ace.py `ace_b_and_dbda` (:706), the einsum
// ("alp,cakp->alkc") at :682 and the live mask at :684-686 of
// `ace_descriptors_with_jacobian`.
//
// Bound on the H100: bytes.  The kernel must read Jp (3 x K x 2 nA doubles
// per atom) and write dB/dD (nl x K x 3 doubles per atom, 104 KB at
// nl = 68, K = 64); the products and cofactors cost a few hundred thousand
// flops per atom, and the contraction 4 flops per (label, slot, neighbor,
// direction) over the label's few slots.
//
// Design: one block per atom.  A (2 nA doubles) sits in shared memory.
// Each thread computes whole labels of B, then whole entries of the compact
// dB/dA of the atom's element: the host lists, per label, the distinct
// A-slots its terms touch (slot 0, the padding factor's, is left out: Jp is
// zero there), and per entry its (term, factor) contributions in a fixed
// order, so each entry is one thread's sum with no atomics.  dB/dA takes 2 x (number of entries)
// doubles (the dense nl x 2 nA form would not fit a block at two-element
// plans).  Jp streams through shared memory in tiles of KT neighbors, read
// once, and each thread forms whole (label, neighbor, direction) outputs.
#include "common.cuh"

namespace {

constexpr int KT = 8;            // neighbors per Jp tile
constexpr int THREADS = 256;

struct Args {
  const double* A;               // (N, 2 nA) [Re | Im]
  const double* Jp;              // (3, N, K, 2 nA)
  const int* ielem;              // (N,)
  const int* mu0;                // (nl,) central element of each label
  const int* fact;               // (nterms, R) A-slots of each term
  const double* coef;            // (nterms,)
  const int* lab_t;              // (nl + 1,) terms of label l
  const int* lab_e;              // (nl + 1,) dB/dA entries of label l
  const int* e_slot;             // (nE,) A-slot of each entry
  const int* e_c;                // (nE + 1,) contributions of each entry
  const int* c_tr;               // (nC,) term * R + factor
  const int* el_e;               // (ntypes + 1,) entries of element e
  int ntypes, R, nl, nA, nE, K;
  long long N;
};

__global__ void ace_b_dbdd_kernel(Args p, double* __restrict__ B,
                                  double* __restrict__ dBdD) {
  extern __shared__ double sm[];
  const int two_a = 2 * p.nA;
  double* sa = sm;                 // [2 nA]
  double* sd = sa + two_a;         // [2][nE] dB/dA: real-slot, imag-slot
  double* sj = sd + 2 * p.nE;      // [3][KT][2 nA] tile of Jp
  const long long a = blockIdx.x;
  const int tid = threadIdx.x;
  const int ie = p.ielem[a];
  const bool known = ie >= 0 && ie < p.ntypes;
  const int e_end = known ? p.el_e[ie + 1] : 0;

  for (int s = tid; s < two_a; s += THREADS) sa[s] = p.A[a * two_a + s];
  __syncthreads();

  for (int l = tid; l < p.nl; l += THREADS) {
    double b = 0.0;
    if (p.mu0[l] == ie) {
      for (int t = p.lab_t[l]; t < p.lab_t[l + 1]; ++t) {
        const int* f = p.fact + static_cast<long long>(t) * p.R;
        double cr = sa[f[0]], ci = sa[p.nA + f[0]];
        for (int r = 1; r < p.R; ++r) {
          const double ar = sa[f[r]], ai = sa[p.nA + f[r]];
          const double nr = cr * ar - ci * ai;
          ci = cr * ai + ci * ar;
          cr = nr;
        }
        b += p.coef[t] * cr;
      }
    }
    B[a * p.nl + l] = b;
  }

  for (int e = (known ? p.el_e[ie] : 0) + tid; e < e_end; e += THREADS) {
    double sr = 0.0, si = 0.0;
    for (int q = p.e_c[e]; q < p.e_c[e + 1]; ++q) {
      const int t = p.c_tr[q] / p.R;
      const int r = p.c_tr[q] % p.R;
      const int* f = p.fact + static_cast<long long>(t) * p.R;
      double pr = 1.0, pi = 0.0;            // prod of the factors before r
      for (int j = 0; j < r; ++j) {
        const double ar = sa[f[j]], ai = sa[p.nA + f[j]];
        const double nr = pr * ar - pi * ai;
        pi = pr * ai + pi * ar;
        pr = nr;
      }
      double qr = 1.0, qi = 0.0;            // prod of the factors after r
      for (int j = p.R - 1; j > r; --j) {
        const double ar = sa[f[j]], ai = sa[p.nA + f[j]];
        const double nr = qr * ar - qi * ai;
        qi = qr * ai + qi * ar;
        qr = nr;
      }
      const double c = p.coef[t];
      sr += c * (pr * qr - pi * qi);
      si += c * (pr * qi + pi * qr);
    }
    // d Re[c prod] / dA_re = Re[cofactor], d / dA_im = -Im[cofactor]
    sd[e] = sr;
    sd[p.nE + e] = -si;
  }
  __syncthreads();

  const long long jstride = p.N * p.K * two_a;
  for (int k0 = 0; k0 < p.K; k0 += KT) {
    for (int idx = tid; idx < 3 * KT * two_a; idx += THREADS) {
      const int c = idx / (KT * two_a);
      const int rem = idx % (KT * two_a);
      const int k = k0 + rem / two_a;
      sj[idx] = k < p.K ? p.Jp[c * jstride + (a * p.K + k) * two_a +
                               rem % two_a]
                        : 0.0;
    }
    __syncthreads();
    for (int idx = tid; idx < p.nl * KT * 3; idx += THREADS) {
      const int l = idx / (KT * 3);
      const int kk = (idx / 3) % KT;
      const int c = idx % 3;
      if (k0 + kk < p.K) {
        double s = 0.0;
        if (p.mu0[l] == ie) {
          const double* jr = sj + (c * KT + kk) * two_a;
          for (int e = p.lab_e[l]; e < p.lab_e[l + 1]; ++e) {
            const int slot = p.e_slot[e];
            s += sd[e] * jr[slot] + sd[p.nE + e] * jr[p.nA + slot];
          }
        }
        dBdD[((a * p.nl + l) * p.K + k0 + kk) * 3 + c] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// A (N, 2 nA), Jp (3, N, K, 2 nA) f64 from K13; ielem (N,) i32; plan
// tables: mu0 (nl,), fact (nterms, R), coef (nterms,), lab_t, lab_e
// (nl + 1,), e_slot (nE,), e_c (nE + 1,), c_tr (nC,), el_e (ntypes + 1,).
// Writes B (N, nl) and dBdD (N, nl, K, 3).
extern "C" int ace_b_dbdd(const double* A, const double* Jp, const int* ielem,
                          const int* mu0, const int* fact, const double* coef,
                          const int* lab_t, const int* lab_e,
                          const int* e_slot, const int* e_c, const int* c_tr,
                          const int* el_e, int ntypes, int R, int nl, int nA,
                          int nE, long long N, int K, double* B, double* dBdD,
                          void* stream) {
  const Args p{A, Jp, ielem, mu0, fact, coef, lab_t, lab_e, e_slot, e_c,
               c_tr, el_e, ntypes, R, nl, nA, nE, K, N};
  const size_t smem = sizeof(double) * (2 * static_cast<size_t>(nA) +
                                        2 * static_cast<size_t>(nE) +
                                        3 * static_cast<size_t>(KT) * 2 * nA);
  const int err = fs_allow_smem(ace_b_dbdd_kernel, smem);
  if (err) return err;
  if (N > 0) {
    ace_b_dbdd_kernel<<<static_cast<unsigned>(N), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(p, B, dBdD);
  }
  return static_cast<int>(cudaGetLastError());
}
