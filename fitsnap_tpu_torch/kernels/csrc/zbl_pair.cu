// K5 zbl_eav / ref_eav: the reference potential of a batch of configs,
// energy, forces and virial in one launch.  zbl_eav is `pair_style zbl`
// alone; ref_eav is the whole `hybrid/overlay` of zbl, coul/cut and
// spin/exchange/biquadratic, any of the three.
//
// Per directed pair slot (c, i, k) with mask set, r = |D[i, k]| and the
// LAMMPS `pair_style zbl` energy of `zbl_pair_energy`
//   e(r)  = pre / r * phi(r / a) + sw5 + [r > r_in] t^3 (sw3 + sw4 t)
//   e'(r) = pre * (-phi / r^2 + phi' / r) + [r > r_in] (3 sw3 t^2 + 4 sw4 t^3)
// with t = r - r_in, phi(x) = sum_m c_m exp(-d_m x), phi' = dphi/dr, and
// e = e' = 0 at r >= r_out or for a type pair without coefficients.
// ref_eav adds, inside their cutoffs, the bare Coulomb energy
//   e_q(r) = qqr2e q_i q_j / r,   e_q'(r) = -e_q / r   (r < rc_q)
// and the Bethe-Slater spin energy
//   e_s = -(J(r) (s_i.s_j - off) + Kb(r) ((s_i.s_j)^2 - off))   (r < rc_s)
//   J(r) = 4 a (r/d)^2 (1 - g (r/d)^2) exp(-(r/d)^2)   (Kb alike)
// which enters the energy alone: the reference pins the spin term's
// mechanical force and virial to zero.  The slot's gradient is
// g = 0.5 (e' + e_q') D / r (what the vjp of 0.5 sum e gives), and per atom
// n and config c
//   force[c, n]  = sum_k g[c, n, k] - sum over n's reverse slots s of g[c, s]
//   virial[c, v] = -sum over masked slots D[pa_v] g[pb_v]
//   energy[c]    = 0.5 sum over masked slots (e + e_q + e_s)
// with (pa, pb) = xx, yy, zz, yz, xz, xy.
//
// Replaces fitsnap_tpu/ops/refpot.py `reference_eav` (:239; its `jax.vjp`
// of the pair energies, the coul/cut branch at :270-273, the spin branch
// at :274-281 and the one-hot matmul scatter of :295-302) and
// `zbl_pair_energy` (:96).
//
// Bound on the H100: bytes.  Each pair slot reads 24 B of displacement, 5 B
// of index and mask, and 4 B of the reverse table; per atom 12 B of types
// and 24 B of force out (ref_eav: 8 B of charge and 24 B of spin more).
// The four exponentials per pair (twice: once from each side), and the
// spin term's two, are far below the card's FP64 rate for that traffic.
//
// Design: two warps per atom (64 lanes), ATOMS atoms a block, the blocks
// of a config consecutive.  The atom's lane L takes its own slots k = L +
// 64 u, then its reverse slots rev[n, L + 64 u] (flat slots i K + k of the
// config whose jidx is n), G slots at a time: their indices, then their
// masks, displacements and type pairs (ref_eav: and the other atom's
// charge and, on own slots, its spin), then their energies, all G loads of
// a step issued together, so a lane waits for one chain of dependent
// loads, not one per slot.  A reverse slot's g is recomputed from that
// slot's own displacement, mask and type pair (type of its source atom i,
// type of n), and its Coulomb term from the charges of i and n, never read
// from a g in memory, so a truncated or one-sided
// list, or an atom that is its own neighbor through a periodic image (rev
// repeats that slot), gives what the reference gives.  The spin energy is
// taken on own slots alone (reverse slots carry gradients, not energy).  A
// fixed butterfly
// sums each warp's lanes; the atom's force is its two warps' own sums
// minus their reverse sums, in warp order; the block sums its warps'
// energy and virial in warp order into a partial per block, and the last
// block of each config (an integer ticket per config, which that block
// resets to 0) sums the config's partials in block order.  No
// floating-point atomics: the outputs repeat bit for bit.  One template
// gives both entry points: zbl_eav's instantiation holds none of
// ref_eav's loads or branches.
//
// Working types: zbl_eav also has a float32 instantiation (`zbl_eav_f32`,
// the streamed linear SNAP fit at float32): float32 displacements, table
// (rounded once from the float64 one), constants and cutoffs, and float32
// sums in the same fixed orders; ref_eav is float64 only.
#include "common.cuh"

namespace {

constexpr int ATOMS = 4;                 // atoms of a block (kernels/snap_kernels.py ZBL_ATOMS)
constexpr int WPA = 2;                   // warps of an atom
constexpr int WARPS = ATOMS * WPA;
constexpr int THREADS = 32 * WARPS;
constexpr int G = 2;                     // slots a lane evaluates together
constexpr int NPART = 7;                 // energy and the six virial components
__constant__ double kC[4] = {0.02817, 0.28022, 0.50986, 0.18175};
__constant__ double kD[4] = {0.20162, 0.40290, 0.94229, 3.19980};
constexpr double QQR2E = 14.399645;      // eV A (ops/refpot.py _QQR2E)

// ref_eav's scalars, (9,) f64 in device memory: coul/cut's cutoff, then
// spin/exchange/biquadratic's cutoff, a, g, d of J, a, g, d of Kb, offset
struct Extra {
  double rcq, rcs, aj, gj, dj, ak, gk, dk, off;
};

// The Bethe-Slater profile 4 a x2 (1 - g x2) exp(-x2), x2 = (r / d)^2.
__device__ __forceinline__ double bethe_slater(double r, double a, double g,
                                               double d) {
  const double x = r / d;
  const double x2 = x * x;
  return 4.0 * a * x2 * (1.0 - g * x2) * exp(-x2);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// EXTRA: ref_eav (charges, spins and their scalars read; either of the
// two arrays may be null); else zbl_eav.
template <bool EXTRA, typename F>
__global__ void __launch_bounds__(THREADS)
    ref_eav_kernel(const F* __restrict__ disp,
                   const int* __restrict__ jidx,
                   const unsigned char* __restrict__ mask,
                   const int* __restrict__ rev,
                   const int* __restrict__ types,
                   const F* __restrict__ table,
                   const double* __restrict__ charges,
                   const double* __restrict__ spins,
                   const double* __restrict__ extra, int A, int K, int R,
                   int T, int bpc, F cut_inner, F cut_outer,
                   F* __restrict__ part, unsigned* __restrict__ ticket,
                   F* __restrict__ energy, F* __restrict__ force,
                   F* __restrict__ virial) {
  static_assert(!EXTRA || sizeof(F) == 8, "ref_eav runs at float64 only");
  __shared__ F red[WARPS][NPART];
  __shared__ F fsum[WARPS][6];            // own and reverse sums of g
  __shared__ bool last;
  const int c = blockIdx.x / bpc;             // config
  const int b = blockIdx.x - c * bpc;         // block of the config
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = b * ATOMS + warp / WPA;       // atom of the config
  const int L = lane + 32 * (warp % WPA);     // the atom's lane
  const long long first = static_cast<long long>(c) * A;
  F es = F(0), v[6] = {F(0), F(0), F(0), F(0), F(0), F(0)};
  F fo[3] = {F(0), F(0), F(0)}, fr[3] = {F(0), F(0), F(0)};
  if (i < A) {
    const long long n = first + i;
    const int ti = types[n];
    Extra x{};
    double qn = 0.0, sn[3] = {0.0, 0.0, 0.0};
    if constexpr (EXTRA) {
      x = *reinterpret_cast<const Extra*>(extra);
      if (charges) qn = charges[n];
      if (spins) {
        sn[0] = spins[3 * n];
        sn[1] = spins[3 * n + 1];
        sn[2] = spins[3 * n + 2];
      }
    }
    const int uo = (K + 32 * WPA - 1) / (32 * WPA);   // own slot steps
    const int ur = (R + 32 * WPA - 1) / (32 * WPA);   // reverse slot steps
    for (int g0 = 0; g0 < uo + ur; g0 += G) {
      long long s[G];
      int src[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {      // 1. the slot: own, or reverse
        const int it = g0 + u;
        s[u] = -1;
        src[u] = 0;
        if (it < uo) {
          const int k = L + 32 * WPA * it;
          if (k < K) s[u] = n * K + k;
        } else if (it < uo + ur) {
          const int q = L + 32 * WPA * (it - uo);
          const int slot = q < R ? rev[n * R + q] : -1;
          if (slot >= 0) {
            s[u] = first * K + slot;
            src[u] = slot / K;
          }
        }
      }
      F d[G][3];
      int pt[G];
      double qo[G], so[G][3];            // ref_eav: the other atom's q, s
#pragma unroll
      for (int u = 0; u < G; ++u) {      // 2. mask, displacement, type pair
        pt[u] = -1;
        d[u][0] = d[u][1] = d[u][2] = F(0);
        if constexpr (EXTRA) qo[u] = so[u][0] = so[u][1] = so[u][2] = 0.0;
        if (s[u] >= 0 && mask[s[u]]) {
          d[u][0] = disp[3 * s[u]];
          d[u][1] = disp[3 * s[u] + 1];
          d[u][2] = disp[3 * s[u] + 2];
          const bool own = g0 + u < uo;
          const long long o = first + (own ? jidx[s[u]] : src[u]);
          pt[u] = own ? ti * T + types[o] : types[o] * T + ti;
          if constexpr (EXTRA) {
            if (charges) qo[u] = charges[o];
            if (spins && own) {
              so[u][0] = spins[3 * o];
              so[u][1] = spins[3 * o + 1];
              so[u][2] = spins[3 * o + 2];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {      // 3. e and e', then the sums
        if (pt[u] < 0) continue;
        const F* p = table + 6 * pt[u];
        const F dx = d[u][0], dy = d[u][1], dz = d[u][2];
        const F r = sqrt(dx * dx + dy * dy + dz * dz);
        const bool zon = p[5] != F(0) && r < cut_outer;
        if (!EXTRA && !zon) continue;
        const F rinv = F(1) / r;
        F e = F(0), de = F(0);
        if (zon) {
          const F pre = p[0];
          const F ainv = F(1) / p[1];
          const F xa = r * ainv;
          F phi = F(0), dphi = F(0);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const F c = static_cast<F>(kC[m]), dm = static_cast<F>(kD[m]);
            const F ex = exp(-dm * xa);
            phi += c * ex;
            dphi -= c * dm * ex;
          }
          dphi *= ainv;
          e = pre * rinv * phi + p[4];
          de = pre * rinv * (dphi - phi * rinv);
          if (r > cut_inner) {
            const F t = r - cut_inner;
            e += t * t * t * (p[2] + p[3] * t);
            de += t * t * (F(3) * p[2] + F(4) * p[3] * t);
          }
        }
        if constexpr (EXTRA) {
          if (charges && r < x.rcq) {
            const double eq = QQR2E * (qn * qo[u]) * rinv;
            e += eq;
            de -= eq * rinv;
          }
          if (spins && g0 + u < uo && r < x.rcs) {
            const double dot = sn[0] * so[u][0] + sn[1] * so[u][1] +
                               sn[2] * so[u][2];
            e -= bethe_slater(r, x.aj, x.gj, x.dj) * (dot - x.off) +
                 bethe_slater(r, x.ak, x.gk, x.dk) * (dot * dot - x.off);
          }
        }
        const F f = F(0.5) * de * rinv;
        const F gx = f * dx, gy = f * dy, gz = f * dz;
        if (g0 + u < uo) {
          es += e;
          fo[0] += gx;
          fo[1] += gy;
          fo[2] += gz;
          v[0] -= dx * gx;
          v[1] -= dy * gy;
          v[2] -= dz * gz;
          v[3] -= dy * gz;
          v[4] -= dx * gz;
          v[5] -= dx * gy;
        } else {
          fr[0] += gx;
          fr[1] += gy;
          fr[2] += gz;
        }
      }
    }
  }
  es = warp_sum(es);
#pragma unroll
  for (int d = 0; d < 6; ++d) v[d] = warp_sum(v[d]);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    fo[d] = warp_sum(fo[d]);
    fr[d] = warp_sum(fr[d]);
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      fsum[warp][d] = fo[d];
      fsum[warp][3 + d] = fr[d];
    }
    red[warp][0] = es;
#pragma unroll
    for (int d = 0; d < 6; ++d) red[warp][1 + d] = v[d];
  }
  __syncthreads();
  if (warp % WPA == 0 && lane < 3 && i < A) {
    F so = F(0), sr = F(0);
#pragma unroll
    for (int h = 0; h < WPA; ++h) {
      so += fsum[warp + h][lane];
      sr += fsum[warp + h][3 + lane];
    }
    force[3 * (first + i) + lane] = so - sr;
  }
  if (threadIdx.x < NPART) {
    F t = F(0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w][threadIdx.x];
    part[static_cast<long long>(blockIdx.x) * NPART + threadIdx.x] = t;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket + c, 1u) == static_cast<unsigned>(bpc - 1);
  __syncthreads();
  if (!last) return;
  // the last block of config c: its blocks' partials in block order
  const F* pc = part + static_cast<long long>(c) * bpc * NPART;
  for (int d = warp; d < NPART; d += WARPS) {
    F t = F(0);
    for (int q = lane; q < bpc; q += 32) t += __ldcg(pc + q * NPART + d);
    t = warp_sum(t);
    if (lane == 0) {
      if (d == 0)
        energy[c] = F(0.5) * t;
      else
        virial[6 * c + d - 1] = t;
    }
  }
  if (threadIdx.x == 0) ticket[c] = 0u;
}

template <bool EXTRA, typename F>
static int launch(const F* disp, const int* jidx,
                  const unsigned char* mask, const int* rev, const int* types,
                  const F* table, const double* charges,
                  const double* spins, const double* extra, int C, int A,
                  int K, int R, int T, double cut_inner, double cut_outer,
                  F* part, unsigned* ticket, F* energy,
                  F* force, F* virial, void* stream) {
  const int bpc = (A + ATOMS - 1) / ATOMS;
  const long long blocks = static_cast<long long>(C) * bpc;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    ref_eav_kernel<EXTRA, F><<<static_cast<unsigned>(blocks), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        disp, jidx, mask, rev, types, table, charges, spins, extra, A, K, R,
        T, bpc, static_cast<F>(cut_inner), static_cast<F>(cut_outer), part,
        ticket, energy, force, virial);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// disp (C, A, K, 3) f64, jidx (C, A, K) i32, mask (C, A, K) u8, rev
// (C, A, R) i32 flat source slots i*K + k (-1 padded), types (C, A) i32,
// table (T, T, 6) f64 rows (pre, a, sw3, sw4, sw5, active); part
// (C * ceil(A / ATOMS), 7) f64 scratch; ticket (C,) u32, zero on entry and
// left zero.  Writes energy (C,), force (C, A, 3) and virial (C, 6).
extern "C" int zbl_eav(const double* disp, const int* jidx,
                       const unsigned char* mask, const int* rev,
                       const int* types, const double* table, int C, int A,
                       int K, int R, int T, double cut_inner,
                       double cut_outer, double* part, unsigned* ticket,
                       double* energy, double* force, double* virial,
                       void* stream) {
  return launch<false, double>(disp, jidx, mask, rev, types, table, nullptr,
                               nullptr, nullptr, C, A, K, R, T, cut_inner,
                               cut_outer, part, ticket, energy, force, virial,
                               stream);
}

// The float32 instantiation of zbl_eav: disp, table, part, energy, force
// and virial f32; the cutoffs rounded to float32 here.
extern "C" int zbl_eav_f32(const float* disp, const int* jidx,
                           const unsigned char* mask, const int* rev,
                           const int* types, const float* table, int C,
                           int A, int K, int R, int T, double cut_inner,
                           double cut_outer, float* part, unsigned* ticket,
                           float* energy, float* force, float* virial,
                           void* stream) {
  return launch<false, float>(disp, jidx, mask, rev, types, table, nullptr,
                              nullptr, nullptr, C, A, K, R, T, cut_inner,
                              cut_outer, part, ticket, energy, force, virial,
                              stream);
}

// zbl_eav's arguments (a table of inactive rows where there is no zbl)
// and: charges (C, A) f64 or null (no coul/cut), spins (C, A, 3) f64 or
// null (no spin term), extra (9,) f64 the scalars of `Extra`.
extern "C" int ref_eav(const double* disp, const int* jidx,
                       const unsigned char* mask, const int* rev,
                       const int* types, const double* table,
                       const double* charges, const double* spins,
                       const double* extra, int C, int A, int K, int R,
                       int T, double cut_inner, double cut_outer,
                       double* part, unsigned* ticket, double* energy,
                       double* force, double* virial, void* stream) {
  return launch<true, double>(disp, jidx, mask, rev, types, table, charges,
                              spins, extra, C, A, K, R, T, cut_inner,
                              cut_outer, part, ticket, energy, force, virial,
                              stream);
}
