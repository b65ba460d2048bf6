// K12 nn_force, its transpose K12T nn_force_t, and the force gather
// nn_pair_gather: the force contraction of the NN solver's precompute mode
// and the scatter of pair gradients into forces that the cached mode shares.
//
// K12: from dE/dB (N, A, W) and the stored descriptor jacobian
// G = dB/dD (N, A, W, K, 3) of a minibatch, the pair gradients
//   fpair[n, a, k, c] = sum_w dEdB[n, a, w] G[n, a, w, k, c].
// nn_pair_gather: forces from pair gradients g (N, A, K, 3), fpair here or
// K11's dE/ddisp in the cached mode,
//   F[n, m, c] = sum_k g[n, m, k, c] - sum_r g[n, rev[n, m, r], c]
// where rev (N, A, R) lists, per destination atom m, the flat slots a*K + k
// whose neighbor is m (increasing, padded with -1).
// K12T: the transpose of both, the cotangent of dE/dB from that of F,
//   g[n, a, w] = sum_{k, c} (gF[n, a, c] - gF[n, jidx[n, a, k], c])
//                           G[n, a, w, k, c].
//
// Replaces fitsnap_tpu/solvers/network.py `_forward_batch` (:720-742): the
// einsum "naw,nawkc->nakc" and the O(A^2 K) one-hot scatter
// -(scat - sum_k fpair), with the same scatter in `_forward_batch_cached`
// (:811-816); K12T is what JAX's autodiff takes through both for the force
// loss's gradient.
//
// Bound on the H100: bytes.  G is read once (about 2 flops per element);
// everything else is a few percent of it.  The gather reads g once.
//
// Design: no atomics, every sum in a fixed order, so a run repeats bit for
// bit.  K12 is two launches, as K8/K8r are: the contraction into an
// (N, A, K, 3) scratch, then the gather (nn_pair_gather).  K12T: one block
// per atom; the differences gF[a] - gF[jidx] go to shared memory once, then
// one warp per w runs down G's (K, 3) row and reduces with shuffles in a
// fixed order.
//
// The contraction streams G, which is all its bytes: the card's HBM rate
// needs tens of KB in flight on each SM.  One block of eight warps per atom
// (n, a), whose G is one contiguous W x 3K slab; a block takes 3K in
// chunks of 192 columns, and warp v the rows w = v, v + 8, ... of the
// chunk, two rows a step: a lane issues all its loads of the step (two
// rows x 192 / 32 columns, as 16-byte loads where 3K is even and G 16-byte
// aligned, else 8-byte ones) and the two dE/dB values before its first
// sum, so a block has 24 KB of G in flight, and the blocks of a minibatch
// (512 at 4 x 128) are resident at once, four an SM (at most 64 registers
// a thread): about 96 KB in flight on each SM.  Each warp sums its rows in
// increasing w; the eight partial sums are added in warp order through
// shared memory.  Plain loads were taken over TMA bulk copies into a ring
// of stages (the Hopper shape for a streaming kernel) on an argument, not a
// timing: they put as many bytes in flight with the same one pass over G,
// and need no alignment of a slab (3K odd) nor a producer warp.  A TMA ring
// has not been built or timed against this kernel.
//
// The gather: its bytes take 0.28 us at the NN minibatch, so its time is the
// chain of dependent loads, which the design keeps to two round trips.  One
// warp per destination atom, GATHER_WARPS atoms a block (the 512 atoms of a
// 4 x 128 x 64 minibatch fill 128 blocks).  The lanes read the atom's own row
// of 3K doubles coalesced, three loads a lane per 96 doubles (so each lane's
// three loads hit the three components, in a fixed rotation, and no row
// needs 16-byte alignment), and its R reverse entries in parallel (lane r
// takes r, r + 32, ...; a -1 adds nothing; the first 32 are read before the
// own row): rev with the own row, then the sources' g.  Each lane subtracts
// its scatter sums from its own sums; the warp adds the three components
// with an xor butterfly, a fixed tree.
//
// The gather at float32 (`nn_pair_gather_f32`, the NN solver's float32
// cached and OTF modes) is the same kernel at float: where the own row is
// 16-byte aligned (3K a multiple of 4 and g aligned) each lane reads it as
// float4 loads, four floats a load, 128 floats a warp's pass, and adds each
// float to its component's sum (float j of load v is component (v + j) mod
// 3); else one float a load as at float64.  Sums float32, a fixed order.
#include "common.cuh"

namespace {

constexpr int F_WARPS = 8;           // warps a block of the contraction
constexpr int F_ROWS = 2;            // rows of G a warp loads a step
constexpr int F_COLS = 192;          // columns a block takes a chunk
constexpr int GATHER_WARPS = 4;      // atoms a block of the gather
constexpr int T_THREADS = 256;
constexpr int WARPS = T_THREADS / 32;

// A lane's loads of G: 16 bytes (two doubles) or 8.
template <int V> struct Vec;
template <> struct Vec<1> {
  using T = double;
  static __device__ __forceinline__ T zero() { return 0.0; }
  static __device__ __forceinline__ void fma(T& acc, double d, T g) {
    acc = __fma_rn(d, g, acc);
  }
  static __device__ __forceinline__ double at(T v, int) { return v; }
};
template <> struct Vec<2> {
  using T = double2;
  static __device__ __forceinline__ T zero() { return make_double2(0.0, 0.0); }
  static __device__ __forceinline__ void fma(T& acc, double d, T g) {
    acc.x = __fma_rn(d, g.x, acc.x);
    acc.y = __fma_rn(d, g.y, acc.y);
  }
  static __device__ __forceinline__ double at(T v, int e) {
    return e ? v.y : v.x;
  }
};

// fpair[atom, j] = sum_w dedb[atom, w] G[atom, w, j], j < R = 3K: one block
// per atom, V doubles a load (V = 2 needs R even and G 16-byte aligned).
template <int V>
__global__ void __launch_bounds__(F_WARPS * 32, 4)
nn_fpair_kernel(const double* __restrict__ dedb, const double* __restrict__ G,
                int W, int R, double* __restrict__ fpair) {
  using T = typename Vec<V>::T;
  constexpr int Q = F_COLS / (32 * V);       // loads a lane a row
  __shared__ double part[F_WARPS][F_COLS];
  const long long atom = blockIdx.x;
  const double* g = G + atom * W * R;
  const double* d = dedb + atom * W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int c0 = 0; c0 < R; c0 += F_COLS) {
    T acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = Vec<V>::zero();
    for (int w0 = warp; w0 < W; w0 += F_WARPS * F_ROWS) {
      double dw[F_ROWS];
      T x[F_ROWS][Q];
#pragma unroll
      for (int u = 0; u < F_ROWS; ++u) {
        const int w = w0 + u * F_WARPS;
        dw[u] = w < W ? d[w] : 0.0;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int col = c0 + (q * 32 + lane) * V;
          x[u][q] = w < W && col < R
                        ? *reinterpret_cast<const T*>(
                              g + static_cast<long long>(w) * R + col)
                        : Vec<V>::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < F_ROWS; ++u)
#pragma unroll
        for (int q = 0; q < Q; ++q) Vec<V>::fma(acc[q], dw[u], x[u][q]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < V; ++e)
        part[warp][(q * 32 + lane) * V + e] = Vec<V>::at(acc[q], e);
    __syncthreads();
    for (int t = threadIdx.x; t < F_COLS && c0 + t < R; t += F_WARPS * 32) {
      double sum = part[0][t];
#pragma unroll
      for (int v = 1; v < F_WARPS; ++v) sum += part[v][t];
      fpair[atom * R + c0 + t] = sum;
    }
    __syncthreads();
  }
}

template <typename T, bool VEC4>
__global__ void __launch_bounds__(GATHER_WARPS * 32) nn_gather_kernel(
    const T* __restrict__ g, const int* __restrict__ rev,
    long long atoms, int A, int K, int R, T* __restrict__ force) {
  const long long m = blockIdx.x * static_cast<long long>(GATHER_WARPS)
                      + threadIdx.x / 32;        // n * A + local atom
  if (m >= atoms) return;                        // the whole warp
  const int lane = threadIdx.x % 32;
  const int n = 3 * K;
  const T* row = g + m * n;
  // the slots whose neighbor is m, flat a * K + k within m's config; the
  // first 32 are read before the own row, so that both loads are in flight
  const int* rv = rev + m * R;
  int slot = lane < R ? rv[lane] : -1;
  // own sums: row[i], i = lane + 32 j, has component (lane + 2 j) % 3, so
  // o[0], o[1], o[2] take components lane % 3, (lane + 2) % 3, (lane + 1) % 3
  // (VEC4: o[c] takes component c itself)
  T o[3] = {T(0), T(0), T(0)};
  if constexpr (VEC4) {
    // float4 v holds floats 4 v .. 4 v + 3, components (v + j) % 3
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int v = lane; v < n / 4; v += 32) {
      const float4 x = r4[v];
      const int c = v % 3;
      const float a0 = x.x + x.w, a1 = x.y, a2 = x.z;
      o[c] += a0;
      o[c == 2 ? 0 : c + 1] += a1;
      o[c == 0 ? 2 : c - 1] += a2;
    }
  } else {
    for (int i = lane; i < n; i += 96) {
      o[0] += row[i];
      if (i + 32 < n) o[1] += row[i + 32];
      if (i + 64 < n) o[2] += row[i + 64];
    }
  }
  const T* cfg = g + (m / A) * A * n;
  T sc[3] = {T(0), T(0), T(0)};
  for (int r = lane; r < R; r += 32) {
    if (r > lane) slot = rv[r];
    if (slot >= 0) {
      const T* src = cfg + 3LL * slot;
      for (int c = 0; c < 3; ++c) sc[c] += src[c];
    }
  }
  const int c0 = lane % 3;
  T v[3];
  for (int c = 0; c < 3; ++c) {
    // o[j] holds component (c0 + 2 j) % 3: j = 2 (c - c0) mod 3
    const int j = VEC4 ? c : (2 * (c - c0) + 6) % 3;
    v[c] = (j == 0 ? o[0] : j == 1 ? o[1] : o[2]) - sc[c];
  }
  for (int off = 16; off > 0; off /= 2)
    for (int c = 0; c < 3; ++c) v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
  if (lane < 3) force[m * 3 + lane] = lane == 0 ? v[0] : lane == 1 ? v[1] : v[2];
}

__global__ void nn_force_t_kernel(const double* __restrict__ gF,
                                  const double* __restrict__ G,
                                  const int* __restrict__ jidx, int A, int W,
                                  int K, double* __restrict__ out) {
  extern __shared__ double gd[];             // (K, 3)
  const long long atom = blockIdx.x;
  const long long first = (atom / A) * A;
  const int row = 3 * K;
  for (int j = threadIdx.x; j < row; j += blockDim.x) {
    const int k = j / 3;
    const int c = j % 3;
    const long long src = first + jidx[atom * K + k];
    gd[j] = gF[atom * 3 + c] - gF[src * 3 + c];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const double* g = G + atom * W * row;
  for (int w = threadIdx.x / 32; w < W; w += WARPS) {
    const double* gw = g + static_cast<long long>(w) * row;
    double acc = 0.0;
    for (int j = lane; j < row; j += 32) acc += gd[j] * gw[j];
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[atom * W + w] = acc;
  }
}

}  // namespace

// dedb (N, A, W), G (N, A, W, K, 3).  Writes fpair (N, A, K, 3).
extern "C" int nn_force(const double* dedb, const double* G, int N, int A,
                        int W, int K, double* fpair, void* stream) {
  const long long atoms = static_cast<long long>(N) * A;
  if (atoms > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int R = 3 * K;
    if (R % 2 == 0 && reinterpret_cast<size_t>(G) % 16 == 0) {
      nn_fpair_kernel<2><<<static_cast<unsigned>(atoms), F_WARPS * 32, 0,
                           st>>>(dedb, G, W, R, fpair);
    } else {
      nn_fpair_kernel<1><<<static_cast<unsigned>(atoms), F_WARPS * 32, 0,
                           st>>>(dedb, G, W, R, fpair);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// g (N, A, K, 3), rev (N, A, R) i32.  Writes force (N, A, 3).
extern "C" int nn_pair_gather(const double* g, const int* rev, int N, int A,
                              int K, int R, double* force, void* stream) {
  const long long atoms = static_cast<long long>(N) * A;
  if (atoms > 0) {
    const unsigned blocks =
        static_cast<unsigned>((atoms + GATHER_WARPS - 1) / GATHER_WARPS);
    nn_gather_kernel<double, false><<<blocks, GATHER_WARPS * 32, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        g, rev, atoms, A, K, R, force);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float32 instantiation: g and force f32; float4 loads of the own rows
// where 3K is a multiple of 4 and g is 16-byte aligned.
extern "C" int nn_pair_gather_f32(const float* g, const int* rev, int N,
                                  int A, int K, int R, float* force,
                                  void* stream) {
  const long long atoms = static_cast<long long>(N) * A;
  if (atoms > 0) {
    const unsigned blocks =
        static_cast<unsigned>((atoms + GATHER_WARPS - 1) / GATHER_WARPS);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((3 * K) % 4 == 0 && reinterpret_cast<size_t>(g) % 16 == 0) {
      nn_gather_kernel<float, true><<<blocks, GATHER_WARPS * 32, 0, st>>>(
          g, rev, atoms, A, K, R, force);
    } else {
      nn_gather_kernel<float, false><<<blocks, GATHER_WARPS * 32, 0, st>>>(
          g, rev, atoms, A, K, R, force);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// gF (N, A, 3), G (N, A, W, K, 3), jidx (N, A, K) i32.  Writes out
// (N, A, W).
extern "C" int nn_force_t(const double* gF, const double* G, const int* jidx,
                          int N, int A, int W, int K, double* out,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long atoms = static_cast<long long>(N) * A;
  if (atoms == 0) return 0;
  const size_t smem = static_cast<size_t>(3) * K * sizeof(double);
  const int err = fs_allow_smem(nn_force_t_kernel, smem);
  if (err) return err;
  nn_force_t_kernel<<<static_cast<unsigned>(atoms), T_THREADS, smem, st>>>(
      gF, G, jidx, A, W, K, out);
  return static_cast<int>(cudaGetLastError());
}
