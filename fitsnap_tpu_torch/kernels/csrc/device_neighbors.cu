// K8 device_neighbors: padded periodic neighbor lists built on the card from
// positions, and K8r reverse_table: their reverse neighbor table.
//
// K8.  For config c and atom i, the candidates are pos[j] + svec[s] for
// every atom j and image shift s of the config's shift table, at flat index
// f = s * A + j.  A candidate is valid when d2 < cutoff^2, i and j are real
// atoms and it is not the self pair in the home image (the shift whose hi
// and lo vectors are zero).  The K slots take the candidates in increasing
// (d2, f) order: first the valid ones, nearest first, then (when fewer than
// K are valid) the invalid ones by index, as `jax.lax.top_k` orders the
// scores -d2 / -inf.  A valid slot holds the displacement rebuilt from the
// hi/lo parts with the TwoSum chain of the JAX code, its neighbor j and
// mask 1; an invalid slot holds (1, 0, 0), j and mask 0.
//
// K8r.  Row n of the reverse table lists the flat slots i * K + k with
// mask[i, k] and jidx[i, k] == n, in increasing slot order, padded with -1;
// this is the table K4 (pair_scatter_rows) gathers through, in the order it
// sums.  Entries past the row width R are dropped and counted per config in
// `dropped`, so the caller can refuse a truncated table (full lists are
// symmetric, so an atom's in-degree equals its own neighbor count <= K).
//
// Replaces fitsnap_tpu/parallel/fit.py `device_neighbors` (the dense
// (A, S, A) candidate tensor and `jax.lax.top_k`).  K8r has no JAX
// counterpart: there the one-hot (A, K, A) matmul of the row assembly plays
// its role; it equals ops/neighbors.py `reverse_neighbors` of the port.
//
// Bound on the H100: K8 evaluates S * A^2 candidate distances per config
// (11 flops each) and writes 29 B per slot; at the Ta shapes (S = 27,
// A = 128, K = 64) the two least times are about equal.  K8r compares
// A * A * K slot indices per config against 9 B per slot of lists and table,
// and is bound by the bytes.
//
// Design.  K8: one block per (config, atom i).  The candidate distances go
// to shared memory (8 B each) and the valid ones are listed (4 B each);
// each listed candidate's slot is its rank in the (d2, f) order, counted
// against the list, so the result does not depend on the order in which the
// list was filled.  d2 is computed with __dmul_rn / __dadd_rn in the JAX
// order, ((pos_j + svec) - pos_i) per component, then x, y, z left to right,
// so no FMA contraction changes its rounding and the order of near ties
// matches the plain version.  The block's candidates must fit in shared
// memory (the wrapper checks).  K8r: one warp per (config, atom n) scans
// the slots in order with a ballot and a prefix count.  No floating-point
// atomics: both are deterministic.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int NB_THREADS = 256;

__device__ __forceinline__ void two_sum(double a, double b, double& s,
                                        double& e) {
  s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  e = __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb));
}

__global__ void neighbors_kernel(const double* __restrict__ pos_hi,
                                 const double* __restrict__ pos_lo,
                                 const double* __restrict__ svec_hi,
                                 const double* __restrict__ svec_lo,
                                 const int* __restrict__ natoms, int A, int S,
                                 int K, double cut2,
                                 double* __restrict__ disp,
                                 int* __restrict__ jidx,
                                 unsigned char* __restrict__ mask) {
  extern __shared__ double key[];            // [S * A] d2, or inf if invalid
  __shared__ int nvalid;
  const int n = S * A;
  int* list = reinterpret_cast<int*>(key + n);  // [S * A] valid candidates
  const long long ci = blockIdx.x;           // c * A + i
  const long long c = ci / A;
  const int i = static_cast<int>(ci % A);
  const int na = natoms[c];
  const double* ph = pos_hi + c * A * 3;
  const double* pl = pos_lo + c * A * 3;
  const double* sh = svec_hi + c * S * 3;
  const double* sl = svec_lo + c * S * 3;
  const int tid = threadIdx.x;
  if (tid == 0) nvalid = 0;
  __syncthreads();

  const double xi = ph[i * 3], yi = ph[i * 3 + 1], zi = ph[i * 3 + 2];
  for (int f = tid; f < n; f += NB_THREADS) {
    const int s = f / A;
    const int j = f % A;
    const double dx = __dsub_rn(__dadd_rn(ph[j * 3], sh[s * 3]), xi);
    const double dy = __dsub_rn(__dadd_rn(ph[j * 3 + 1], sh[s * 3 + 1]), yi);
    const double dz = __dsub_rn(__dadd_rn(ph[j * 3 + 2], sh[s * 3 + 2]), zi);
    const double d2 = __dadd_rn(
        __dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)), __dmul_rn(dz, dz));
    const bool home = sh[s * 3] == 0.0 && sh[s * 3 + 1] == 0.0 &&
                      sh[s * 3 + 2] == 0.0 && sl[s * 3] == 0.0 &&
                      sl[s * 3 + 1] == 0.0 && sl[s * 3 + 2] == 0.0;
    const bool ok = d2 < cut2 && j < na && i < na && !(home && i == j);
    key[f] = ok ? d2 : CUDART_INF;
    if (ok) list[atomicAdd(&nvalid, 1)] = f;
  }
  __syncthreads();
  const int m = nvalid;
  const long long out0 = ci * K;

  // valid candidates: slot = rank in (d2, f) order
  for (int u = tid; u < m; u += NB_THREADS) {
    const int f = list[u];
    const double kf = key[f];
    int rank = 0;
    for (int v = 0; v < m; ++v) {
      const int g = list[v];
      const double kg = key[g];
      rank += (kg < kf) || (kg == kf && g < f);
    }
    if (rank >= K) continue;
    const int s = f / A;
    const int j = f % A;
    const long long o = out0 + rank;
    for (int x = 0; x < 3; ++x) {
      double s1, e1, s2, e2;
      two_sum(sh[s * 3 + x], ph[j * 3 + x], s1, e1);
      two_sum(s1, -ph[i * 3 + x], s2, e2);
      const double lo = __dsub_rn(__dadd_rn(sl[s * 3 + x], pl[j * 3 + x]),
                                  pl[i * 3 + x]);
      disp[o * 3 + x] = __dadd_rn(s2, __dadd_rn(__dadd_rn(e1, e2), lo));
    }
    jidx[o] = j;
    mask[o] = 1;
  }

  // slots m..K-1: the first K - m invalid candidates by index; they all lie
  // below K + m, since at most m candidates there are valid
  if (m < K) {
    const int lim = min(n, K + m);
    for (int f = tid; f < lim; f += NB_THREADS) {
      if (key[f] != CUDART_INF) continue;
      int r = 0;
      for (int g = 0; g < f; ++g) r += key[g] == CUDART_INF;
      if (m + r >= K) continue;
      const long long o = out0 + m + r;
      disp[o * 3] = 1.0;
      disp[o * 3 + 1] = 0.0;
      disp[o * 3 + 2] = 0.0;
      jidx[o] = f % A;
      mask[o] = 0;
    }
  }
}

__global__ void reverse_kernel(const int* __restrict__ jidx,
                               const unsigned char* __restrict__ mask, int A,
                               int K, int R, int* __restrict__ rev,
                               int* __restrict__ dropped) {
  const long long cn = blockIdx.x;           // c * A + n
  const long long c = cn / A;
  const int n = static_cast<int>(cn % A);
  const int* jc = jidx + c * A * K;
  const unsigned char* mc = mask + c * A * K;
  const int lane = threadIdx.x;
  const int total = A * K;
  int count = 0;
  for (int base = 0; base < total; base += 32) {
    const int slot = base + lane;
    const bool hit = slot < total && mc[slot] && jc[slot] == n;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int pos = count + __popc(bal & ((1u << lane) - 1u));
      if (pos < R) rev[cn * R + pos] = slot;
    }
    count += __popc(bal);
  }
  for (int r = count + lane; r < R; r += 32) rev[cn * R + r] = -1;
  if (lane == 0 && count > R) atomicAdd(dropped + c, count - R);
}

}  // namespace

// pos_hi, pos_lo (C, A, 3) f64, svec_hi, svec_lo (C, S, 3) f64, natoms (C,)
// i32.  Writes disp (C, A, K, 3) f64, jidx (C, A, K) i32, mask (C, A, K) u8.
extern "C" int device_neighbors(const double* pos_hi, const double* pos_lo,
                                const double* svec_hi, const double* svec_lo,
                                const int* natoms, int C, int A, int S, int K,
                                double cutoff, double* disp, int* jidx,
                                unsigned char* mask, void* stream) {
  const size_t smem = (sizeof(double) + sizeof(int)) *
                      static_cast<size_t>(S) * A;
  const int err = fs_allow_smem(neighbors_kernel, smem);
  if (err) return err;
  const long long blocks = static_cast<long long>(C) * A;
  if (blocks > 0) {
    neighbors_kernel<<<static_cast<unsigned>(blocks), NB_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        pos_hi, pos_lo, svec_hi, svec_lo, natoms, A, S, K, cutoff * cutoff,
        disp, jidx, mask);
  }
  return static_cast<int>(cudaGetLastError());
}

// jidx (C, A, K) i32, mask (C, A, K) u8.  Writes rev (C, A, R) i32 and adds
// the entries past R of each config to dropped (C,) i32 (zeroed by the
// caller).
extern "C" int reverse_table(const int* jidx, const unsigned char* mask,
                             int C, int A, int K, int R, int* rev,
                             int* dropped, void* stream) {
  const long long blocks = static_cast<long long>(C) * A;
  if (blocks > 0) {
    reverse_kernel<<<static_cast<unsigned>(blocks), 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(jidx, mask, A, K,
                                                          R, rev, dropped);
  }
  return static_cast<int>(cudaGetLastError());
}
