// K14 ace_b_dbdd: per atom, the ACE descriptors
//   B[a, l] = sum_{t in l} coef_t Re(prod_r A[a, f_{t,r}])
// over the plan's product terms, the leave-one-out jacobian dB/dA (each
// factor's cofactor prefix_r x suffix_r, summed into the A-slot it reads),
// and its contraction with the pair tangents of K13
//   dBdD[a, l, k, c] = sum_s dBdA[a, l, s] Jp[c, a, k, s].
// Labels whose central element mu0 is not the atom's element, and every
// label of an atom whose element is out of range, give exact zeros with no
// product: labels are sorted by mu0, so element e owns the labels
// [el_l[e], el_l[e + 1]).
//
// Replaces fitsnap_tpu/ops/ace.py `ace_b_and_dbda` (:706), the einsum
// ("alp,cakp->alkc") at :682 and the live mask at :684-686 of
// `ace_descriptors_with_jacobian`.
//
// Bound on the H100: bytes.  The kernel must read Jp (3 x K x 2 nA doubles
// per atom, 120 KB at Ta_PACE's nA = 39, K = 64) and write dB/dD (nl x K x
// 3 doubles per atom, 104 KB at nl = 68); the product's FP64 work, 2 flops
// per (label, slot, neighbor, direction) of the atom's element, is under
// what the FP64 tensor cores do in that time.
//
// Design: the per-atom product of atom_gemm.cuh, L = the dense dB/dA rows
// of the atom's own labels.  One block per (atom, tile of the element's
// labels), at most MT (16 or 32) rows, the element's labels split evenly
// over the tiles, planned by the wrapper (`ace_b_dbdd_tiles`) so that two
// blocks share an SM: three tiles of 23 rows for Ta_PACE's 68 labels, six
// of 29 for an element of the InP_PACE shape (172 labels).
//   1. each block writes the zero rows (B and dB/dD) of its share of the
//      labels it does not own: labels of other elements, or all of them
//      when the element is unknown;
//   2. the atom's Jp is asked into L2 (bulk prefetch), A goes to shared
//      memory and the dB/dA rows are zeroed;
//   3. the tile's labels in segments whose terms fit a scratch of `seg`
//      terms (their factor slots, entries and contributions copied to
//      shared memory first, so that the chains below read no global
//      memory): a thread per term forms its prefix products, then its
//      suffix products, once, and leaves coef x each factor's cofactor and
//      coef x the term's real part there; then eight lanes per nonzero
//      entry (label, A-slot; host lists, slot 0 left out: Jp is zero
//      there) sum its (term, factor) contributions, strided in the host's
//      order and reduced by a fixed butterfly, into the dense row (real
//      part at s, imaginary at nA + s), and eight lanes per label its
//      terms' values into B;
//   4. the product with Jp writes the rows (its epilogue stage reuses the
//      term scratch).
// No atomics: the output repeats bit for bit.
#include "atom_gemm.cuh"

namespace {

struct Args {
  const double* A;               // (N, 2 nA) [Re | Im]
  const double* Jp;              // (3, N, K, 2 nA)
  const int* ielem;              // (N,)
  const int* fact;               // (nterms, R) A-slots of each term
  const double* coef;            // (nterms,)
  const int* lab_t;              // (nl + 1,) terms of label l
  const int* lab_e;              // (nl + 1,) entries of label l
  const int* e_slot;             // (nE,) A-slot of each entry
  const int* e_lab;              // (nE,) label of each entry
  const int* e_c;                // (nE + 1,) contributions of each entry
  const int* c_tr;               // (nC,) term * R + factor
  const int* el_l;               // (ntypes + 1,) labels of element e
  int ntypes, R, nl, nA, K, MT, ntiles, seg;
  long long N;
};

__device__ __forceinline__ void cmul(double& xr, double& xi, double yr,
                                     double yi) {
  const double r = xr * yr - xi * yi;
  xi = xr * yi + xi * yr;
  xr = r;
}

// Sum of v over the 8 lanes of an aligned group, the same on each.
__device__ __forceinline__ double sum8(double v) {
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 8);
  return v;
}

template <int IW>
__global__ void __launch_bounds__(AG_THREADS, 2)
    ace_b_dbdd_kernel(Args p, double* __restrict__ B,
                      double* __restrict__ dBdD) {
  extern __shared__ __align__(16) double sm[];
  const int two_a = 2 * p.nA;
  const int ldl = ag_ldl(two_a);
  const int seg = p.seg;                     // terms of the scratch
  double* L = sm;                             // [MT][ldl]
  double* sa = L + p.MT * ldl;                // [2 nA]
  double* cof_r = sa + two_a;                 // [seg][R] coef x cofactor
  double* cof_i = cof_r + seg * p.R;
  double* tval = cof_i + seg * p.R;           // [seg] coef x Re(product)
  double* stage = cof_r;    // the product's epilogue (>= AG_STAGE doubles)
  int* sf = reinterpret_cast<int*>(tval + seg);   // [seg][R] factor slots
  int* sc = sf + seg * p.R;                   // [seg R] contributions
  int* sec = sc + seg * p.R;                  // [seg R + 1] e_c, rebased
  int* sel = sec + seg * p.R + 1;             // [seg R] e_lab - r0
  int* ses = sel + seg * p.R;                 // [seg R] e_slot
  int* slt = ses + seg * p.R;                 // [MT + 1] the tile's lab_t
  const int tid = threadIdx.x;
  const long long a = blockIdx.x / p.ntiles;
  const int tile = blockIdx.x % p.ntiles;
  const int ie = p.ielem[a];
  const bool known = ie >= 0 && ie < p.ntypes;
  const int lo = known ? p.el_l[ie] : 0;
  const int hi = known ? p.el_l[ie + 1] : 0;
  const int per = (hi - lo + p.ntiles - 1) / p.ntiles;   // <= MT
  const int r0 = lo + tile * per;
  const int rows = known ? max(0, min(per, hi - r0)) : 0;
  const int row3k = 3 * p.K;

  // 1. zero rows: labels tile, tile + ntiles, ... outside [lo, hi)
  for (int l = tile + (tid >> 5) * p.ntiles; l < p.nl;
       l += p.ntiles * (AG_THREADS / 32)) {
    if (l >= lo && l < hi) continue;
    double* o = dBdD + (a * p.nl + l) * row3k;
    for (int c = tid & 31; c < row3k; c += 32) o[c] = 0.0;
    if ((tid & 31) == 0) B[a * p.nl + l] = 0.0;
  }
  if (rows == 0) return;

  // 2. (the atom's Jp, three runs of K x 2 nA doubles, is asked into L2 for
  // the product meanwhile)
  if (tid < 3)
    ag_prefetch(p.Jp + tid * p.N * p.K * two_a + a * p.K * two_a,
                8LL * p.K * two_a);
  for (int s = tid; s < two_a; s += AG_THREADS) sa[s] = p.A[a * two_a + s];
  for (int idx = tid; idx < p.MT * ldl / 2; idx += AG_THREADS)
    reinterpret_cast<double2*>(L)[idx] = make_double2(0.0, 0.0);
  for (int r = tid; r <= rows; r += AG_THREADS) slt[r] = p.lab_t[r0 + r];
  __syncthreads();

  // 3. (the segment's factor slots and contributions are staged in shared
  // memory first, so that the chains below read no global memory)
  const int g8 = tid & 7;
  for (int r = 0; r < rows;) {
    const int l0 = r0 + r;
    const int t0 = slt[r];
    int r1 = r + 1;
    while (r1 < rows && slt[r1 + 1] - t0 <= seg) ++r1;
    const int l1 = r0 + r1;
    const int nt = slt[r1] - t0;
    const int e0 = p.lab_e[l0], ne = p.lab_e[l1] - e0;
    const int c0 = p.e_c[e0];
    const int nc = p.e_c[e0 + ne] - c0;
    for (int idx = tid; idx < nt * p.R; idx += AG_THREADS)
      sf[idx] = p.fact[static_cast<long long>(t0) * p.R + idx];
    for (int idx = tid; idx < nc; idx += AG_THREADS)
      sc[idx] = p.c_tr[c0 + idx] - t0 * p.R;
    for (int idx = tid; idx <= ne; idx += AG_THREADS) {
      sec[idx] = p.e_c[e0 + idx] - c0;
      if (idx < ne) {
        sel[idx] = p.e_lab[e0 + idx] - r0;
        ses[idx] = p.e_slot[e0 + idx];
      }
    }
    __syncthreads();
    for (int j = tid; j < nt; j += AG_THREADS) {
      const long long t = t0 + j;
      double* cr = cof_r + j * p.R;
      double* ci = cof_i + j * p.R;
      double xr = 1.0, xi = 0.0;              // prefix products
      for (int q = 0; q < p.R; ++q) {
        const int f = sf[j * p.R + q];
        cr[q] = xr;
        ci[q] = xi;
        cmul(xr, xi, sa[f], sa[p.nA + f]);
      }
      const double c = p.coef[t];
      tval[j] = c * xr;
      double yr = c, yi = 0.0;                // coef x suffix products
      for (int q = p.R - 1; q >= 0; --q) {
        const int f = sf[j * p.R + q];
        const double pr = cr[q], pi = ci[q];
        cr[q] = pr * yr - pi * yi;
        ci[q] = pr * yi + pi * yr;
        cmul(yr, yi, sa[f], sa[p.nA + f]);
      }
    }
    __syncthreads();
    // the loops step whole warps (their shuffles take all 32 lanes)
    for (int eb = tid / 32 * 4; eb < ne; eb += AG_THREADS / 8) {
      const int e = eb + tid % 32 / 8;
      double vr = 0.0, vi = 0.0;
      if (e < ne) {
        for (int q = sec[e] + g8; q < sec[e + 1]; q += 8) {
          const int k = sc[q];
          vr += cof_r[k];
          vi += cof_i[k];
        }
      }
      vr = sum8(vr);
      vi = sum8(vi);
      // d Re[c prod] / dA_re = Re[cofactor], d / dA_im = -Im[cofactor]
      if (e < ne && g8 == 0) {
        double* row = L + sel[e] * ldl;
        row[ses[e]] = vr;
        row[p.nA + ses[e]] = -vi;
      }
    }
    for (int lb = l0 + tid / 32 * 4; lb < l1; lb += AG_THREADS / 8) {
      const int l = lb + tid % 32 / 8;
      double b = 0.0;
      if (l < l1)
        for (int j = slt[l - r0] - t0 + g8; j < slt[l + 1 - r0] - t0; j += 8)
          b += tval[j];
      b = sum8(b);
      if (l < l1 && g8 == 0) B[a * p.nl + l] = b;
    }
    __syncthreads();
    r = r1;
  }

  // 4.
  AtomGemm g{L, ldl, rows, nullptr, p.Jp + a * p.K * two_a,
             p.N * p.K * two_a, two_a, nullptr, row3k,
             dBdD + (a * p.nl + r0) * row3k, row3k, stage};
  ag_run<IW>(g);
}

template <int IW>
int launch(const Args& p, size_t smem, double* B, double* dBdD,
           cudaStream_t stream) {
  const int err = fs_allow_smem(ace_b_dbdd_kernel<IW>, smem);
  if (err) return err;
  if (p.N > 0)
    ace_b_dbdd_kernel<IW><<<static_cast<unsigned>(p.N * p.ntiles),
                            AG_THREADS, smem, stream>>>(p, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (N, 2 nA), Jp (3, N, K, 2 nA) f64 from K13; ielem (N,) i32; plan
// tables: fact (nterms, R) i32, coef (nterms,) f64, lab_t, lab_e (nl + 1,),
// e_slot, e_lab (nE,), e_c (nE + 1,), c_tr (nC,), el_l (ntypes + 1,) i32.
// MT labels per block (16 or 32), ntiles blocks per atom, a scratch of
// `seg` terms (at least the most terms of a label).  Writes B (N, nl) and
// dBdD (N, nl, K, 3).
extern "C" int ace_b_dbdd(const double* A, const double* Jp, const int* ielem,
                          const int* fact, const double* coef,
                          const int* lab_t, const int* lab_e,
                          const int* e_slot, const int* e_lab,
                          const int* e_c, const int* c_tr, const int* el_l,
                          int ntypes, int R, int nl, int nA, long long N,
                          int K, int MT, int ntiles, int seg, double* B,
                          double* dBdD, void* stream) {
  const Args p{A, Jp, ielem, fact, coef, lab_t, lab_e, e_slot, e_lab, e_c,
               c_tr, el_l, ntypes, R, nl, nA, K, MT, ntiles, seg, N};
  const size_t smem =
      sizeof(double) * (static_cast<size_t>(MT) * ag_ldl(2 * nA) + 2 * nA +
                        static_cast<size_t>(seg) * (2 * R + 1)) +
      sizeof(int) * (5 * static_cast<size_t>(seg) * R + MT + 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MT == 16) return launch<1>(p, smem, B, dBdD, s);
  if (MT == 32) return launch<2>(p, smem, B, dBdD, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
