// K6q quad_chain: the quadratic extension of the descriptors and of their
// pair jacobian by the product rule,
//   B_ext[a, W + q]        = qc[q] * B[a, i1] * B[a, i2]      (as JAX orders it:
//                            (B[i1] * B[i2]) * qc)
//   dBdD_ext[a, W + q, e]  = qc[q] * (B[a, i1] * dBdD[a, i2, e]
//                                     + B[a, i2] * dBdD[a, i1, e]),
// with the base columns copied first (e runs over the K x 3 pair entries;
// i1 = iq1[q] <= i2 = iq2[q], qc 0.5 on the diagonal, else 1).
//
// Replaces fitsnap_tpu/ops/snap.py `_quad_chain` (ops/snap.py:1097-1113),
// which `descriptors_with_jacobian` applies after contracting with the pair
// tangents at the base width (ops/snap.py:968-974, 983-988).
//
// Bound on the H100: bytes.  Per atom it reads the base dB/dD (W x K x 3
// doubles, 84 KB at twojmax 8, K = 64) and writes the extended one ((W + nq)
// x K x 3, 2.45 MB there); 3 flops per written double.
//
// Design: a pure stream.  One block per (atom, chunk of COLS output
// columns), with the chunks of an atom on neighbouring block indices so that
// the atom's base rows, re-read by every chunk, come from L2.  Threads walk
// the chunk's (column, entry) pairs in memory order: every warp reads the
// two base rows of its column coalesced and writes the output coalesced.
#include "common.cuh"

namespace {

constexpr int COLS = 64;  // output columns per block

__global__ void quad_chain_kernel(const double* __restrict__ B,
                                  const double* __restrict__ dB,
                                  const int* __restrict__ iq1,
                                  const int* __restrict__ iq2,
                                  const double* __restrict__ qc, int W,
                                  int nq, int E, int nchunks,
                                  double* __restrict__ Bx,
                                  double* __restrict__ dBx) {
  const long long a = blockIdx.x / nchunks;
  const int X = W + nq;
  const int c0 = (blockIdx.x % nchunks) * COLS;
  const int c1 = min(X, c0 + COLS);
  const double* Ba = B + a * W;
  const double* dBa = dB + a * W * E;
  for (int col = c0 + threadIdx.x; col < c1; col += blockDim.x) {
    double v;
    if (col < W) {
      v = Ba[col];
    } else {
      const int q = col - W;
      v = (Ba[iq1[q]] * Ba[iq2[q]]) * qc[q];
    }
    Bx[a * X + col] = v;
  }
  double* out = dBx + (a * X + c0) * E;
  const int n = (c1 - c0) * E;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int col = c0 + idx / E;
    const int e = idx % E;
    double v;
    if (col < W) {
      v = dBa[col * E + e];
    } else {
      const int q = col - W;
      const int i1 = iq1[q];
      const int i2 = iq2[q];
      v = qc[q] * (Ba[i1] * dBa[i2 * E + e] + Ba[i2] * dBa[i1 * E + e]);
    }
    out[idx] = v;
  }
}

}  // namespace

// B (N, W), dB (N, W, E) f64 (E = K * 3); iq1, iq2 (nq,) i32; qc (nq,) f64.
// Writes Bx (N, W + nq) and dBx (N, W + nq, E).
extern "C" int quad_chain(const double* B, const double* dB, const int* iq1,
                          const int* iq2, const double* qc, long long natoms,
                          int W, int nq, int E, double* Bx, double* dBx,
                          void* stream) {
  const int nchunks = (W + nq + COLS - 1) / COLS;
  if (natoms > 0 && nchunks > 0) {
    quad_chain_kernel<<<static_cast<unsigned>(natoms * nchunks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        B, dB, iq1, iq2, qc, W, nq, E, nchunks, Bx, dBx);
  }
  return static_cast<int>(cudaGetLastError());
}
