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
// A = 128, K = 64) the two least times are about equal.  K8r needs O(A K)
// integer work per config against 9 B per slot of lists and table, and is
// bound by the bytes: 0.6 MB at 8 x 128 x 64, well under a microsecond, so
// its real floor is one launch's fixed latency.
//
// Design.  K8: one block per (config, atom i).  The candidate distances go
// to shared memory (8 B each) and the valid ones are listed (4 B each);
// each listed candidate's slot is its rank in the (d2, f) order, counted
// against the list, so the result does not depend on the order in which the
// list was filled.  d2 is computed with __dmul_rn / __dadd_rn in the JAX
// order, ((pos_j + svec) - pos_i) per component, then x, y, z left to right,
// so no FMA contraction changes its rounding and the order of near ties
// matches the plain version.  The block's candidates must fit in shared
// memory (the wrapper checks).
//
// K8r places each slot by counting: the column of slot s = i K + k in row
// n = jidx[i, k] is the number of earlier live slots of its config with the
// same destination.  A block owns a range of at most RV_DEST destination
// rows of one config, the ranges sized so that about two blocks an SM run
// (a small batch still spreads over the card; one range a config once the
// batch alone fills it).  It reads the config's slots in chunks of
// RV_CHUNK, 16 consecutive slots a thread, and lists those that point into
// its range in slot order (a block-wide exclusive scan of the threads'
// counts gives each its place in the list).  Warp w then walks the list
// for rows w, w + RV_WARPS, ... of the range, 32 entries a step: a ballot
// of the entries of its row and a count of the earlier lanes give each
// entry its column, the row's count so far carried across steps and
// chunks.  Entries past R are not written; the block pads its rows with -1
// from their counts and adds what fell past R to `dropped`.  Only integer
// counts, each row's in slot order, and no floating-point atomics in
// either kernel: the table is exact and deterministic.  Each block reads
// its config's 5 B a slot once, from L2 for all but the first: the reads
// are A K per (config, range), the ranges a config about 2 x SMs / C.
#include "common.cuh"

#include <math_constants.h>

#include <algorithm>

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

constexpr int RV_THREADS = 256;
constexpr int RV_WARPS = RV_THREADS / 32;
constexpr int RV_PER = 16;                      // slots a thread reads a chunk
constexpr int RV_CHUNK = RV_THREADS * RV_PER;   // slots a chunk
constexpr int RV_DEST = 32;                     // destinations a block, at most

__global__ void __launch_bounds__(RV_THREADS)
reverse_kernel(const int* __restrict__ jidx,
               const unsigned char* __restrict__ mask, int A, int K, int R,
               int DR, int nranges, int* __restrict__ rev,
               int* __restrict__ dropped) {
  __shared__ int list[RV_CHUNK];             // the chunk's hits, in slot order
  __shared__ unsigned char lrow[RV_CHUNK];   // each hit's row in the range
  __shared__ int run[RV_DEST];               // each row's entries so far
  __shared__ int wsum[RV_WARPS + 1];
  const long long b = blockIdx.x;
  const int range = static_cast<int>(b % nranges);
  const long long c = b / nranges;
  const int d0 = range * DR, nd = min(A, d0 + DR) - d0;
  const int* jc = jidx + c * A * K;
  const unsigned char* mc = mask + c * A * K;
  const int nslot = A * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < nd) run[tid] = 0;
  const bool vec = nslot % RV_PER == 0
                   && (reinterpret_cast<size_t>(jidx) & 15) == 0
                   && (reinterpret_cast<size_t>(mask) & 15) == 0;

  for (int base = 0; base < nslot; base += RV_CHUNK) {
    // this thread's slots [s0, s0 + RV_PER) that point into the range:
    // their rows in it (-1 for the others)
    const int s0 = base + tid * RV_PER;
    int row[RV_PER];
    if (vec) {
      const int4* j4 = reinterpret_cast<const int4*>(jc + s0);
      const uint4 m = s0 < nslot ? *reinterpret_cast<const uint4*>(mc + s0)
                                 : make_uint4(0, 0, 0, 0);
      const unsigned mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 j = mw[q] ? j4[q] : make_int4(-1, -1, -1, -1);
        const int jj[4] = {j.x, j.y, j.z, j.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = jj[e] - d0;
          row[4 * q + e] = ((mw[q] >> (8 * e)) & 0xffu) && d >= 0 && d < nd
                               ? d : -1;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < RV_PER; ++q) {
        const int s = s0 + q;
        const int d = s < nslot && mc[s] ? jc[s] - d0 : -1;
        row[q] = d >= 0 && d < nd ? d : -1;
      }
    }
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < RV_PER; ++q) cnt += row[q] >= 0;
    // list them in slot order: an exclusive scan of the counts
    int incl = cnt;
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < RV_WARPS; ++w) {
        const int v = wsum[w];
        wsum[w] = acc;
        acc += v;
      }
      wsum[RV_WARPS] = acc;
    }
    __syncthreads();
    int at = wsum[warp] + incl - cnt;
    const int nhit = wsum[RV_WARPS];
#pragma unroll
    for (int q = 0; q < RV_PER; ++q) {
      if (row[q] >= 0) {
        list[at] = s0 + q;
        lrow[at] = static_cast<unsigned char>(row[q]);
        ++at;
      }
    }
    __syncthreads();

    // warp w places the hits of rows w, w + RV_WARPS, ... of the range, in
    // list order: a ballot and a count a step of 32 hits
    for (int d = warp; d < nd; d += RV_WARPS) {
      int col0 = run[d];
      for (int e0 = 0; e0 < nhit; e0 += 32) {
        const int e = e0 + lane;
        const bool mine = e < nhit && lrow[e] == d;
        const unsigned bal = __ballot_sync(0xffffffffu, mine);
        if (mine) {
          const int col = col0 + __popc(bal & ((1u << lane) - 1u));
          if (col < R) rev[(c * A + d0 + d) * R + col] = list[e];
        }
        col0 += __popc(bal);
      }
      if (lane == 0) run[d] = col0;
    }
  }
  __syncthreads();

  // pad the range's rows; count what fell past R
  for (int i = tid; i < nd * R; i += RV_THREADS) {
    const int d = i / R;
    if (i - d * R >= run[d]) rev[(c * A + d0) * R + i] = -1;
  }
  if (tid < nd && run[tid] > R) atomicAdd(dropped + c, run[tid] - R);
}

// The SMs of the current device (0 if it cannot be read).
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess) {
    return 0;
  }
  return n;
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
  if (C == 0 || A == 0) return 0;
  // destinations a block: about two blocks an SM over the launch, at most
  // RV_DEST
  const long long fill = 2LL * std::max(1, sm_count());
  const long long per = (static_cast<long long>(C) * A + fill - 1) / fill;
  const int DR = static_cast<int>(
      std::min<long long>(std::min(A, RV_DEST), std::max(1LL, per)));
  const int nranges = (A + DR - 1) / DR;
  const long long blocks = static_cast<long long>(C) * nranges;
  reverse_kernel<<<static_cast<unsigned>(blocks), RV_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      jidx, mask, A, K, R, DR, nranges, rev, dropped);
  return static_cast<int>(cudaGetLastError());
}
