// K10 nn_dedu_vg and its transpose K10T nn_dedu_vg_t: dE/dB of the NN
// solver's cached mode taken back to the pair grid, per atom.
//
// K10: from dE/dB (W,) and the atom's z-lists (computed from its cached ut
//   by K2 zlist),
//     dEdu[u]   = sum over y entries (t, src, fac) of u
//                 dEdB[t] fac (z_r[src], z_i[src])        (real, imag parts)
//     vg[d, e]  = sum_u dEdu[u] Lg[d, e, u].
//   This is LAMMPS's compute_yi with a per-atom beta = dE/dB, followed by
//   the change of basis to the grid.  Replaces fitsnap_tpu/ops/snap.py
//   `nn_dEdu` (the block-restricted y plan of `_y_block_plan`) and `nn_vg`.
// K10T: the transpose, dE/dB's cotangent from vg's,
//     du[u]     = sum_(d, e) vgc[d, e] Lg[d, e, u]
//     dEdBc[t]  = sum over y entries (u, src, fac) of t
//                 fac (z_r[src] du[u] + z_i[src] du[U + u]),
//   reading the z-lists that the forward pass formed (K2 does not run twice
//   in a step).  What JAX's autodiff takes through the same lines.
//
// Bound on the H100: bytes.  Per atom K10 reads dE/dB and the z entries
// the y tables reference (2 x 1,388 of the 3,136 z entries at twojmax 6)
// and writes n_t^2 doubles, for about 2 x 2,012 y entries and 2 x 1,835 Lg
// entries of multiply-adds; K10T the same traffic with n_t^2 read and W
// written.
//
// Design of K10: one block per atom.  The y entries and Lg come as
// host-built CSR tables (the y entries by U column, Lg by grid row), read
// through the read-only cache; the 2U-wide intermediate stays in shared
// memory.  Each output is one thread's sum in table order.
//
// Design of K10T: one atom a block, its time the block's chain of loads
// and sums.  (1) At the start, everything the block reads is put in flight
// at once: each thread's first K10T_REGS y entries into registers, and by
// asynchronous copies the atom's vgc, the Lg table and the z entries the y
// tables reference (yz_src, a sorted list built on the host, its indices
// loaded K10T_ZR at a time ahead of their copies; the y entries index this
// compact z, 22 KB an atom at twojmax 6, 70 KB at 8).
// Where they would not fit a block (twojmax 10 and 12), the second launch
// shape reads z and Lg from L2 instead.  (2) du = vgc . Lg, a thread a
// column.  (3) The y entries, in a host-built schedule (ops/snap.py
// `k10t_schedule`), go to every thread of the block: each descriptor's
// entries, in compact z order, are dealt round-robin to segments of at
// most `per` (8 at twojmax 6), one a thread, laid out [entry][thread]; so
// no thread holds more than `per` entries in series (a descriptor has up
// to 147 at twojmax 6), and at each step a descriptor's threads read
// neighboring z in shared memory.
// (4) A descriptor's output sums its segments' partial sums in order.  At
// twojmax 6 the block is 288 threads at 56 registers, four blocks an SM,
// so the Ta minibatch's 512 atoms run in one wave.  Measured on the H100
// and not kept: two atoms a block (each table entry read once for both;
// slower at both minibatch shapes), 256 threads (slower), the pairs (z_r,
// z_i) and (du_r, du_i) as 16-byte loads (slower), Lg read from L2 in
// place of staged (as fast at 4 x 128 x 64, slower at 4 x 8 x 64).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) nn_dedu_vg_kernel(
    const double* __restrict__ dedb, const double* __restrict__ zr,
    const double* __restrict__ zi, int W, int nz, int two_u,
    const int* __restrict__ yu_ptr, const int* __restrict__ yu_t,
    const int* __restrict__ yu_src, const double* __restrict__ yu_fac,
    int nt2, const int* __restrict__ lgr_ptr,
    const int* __restrict__ lgr_col, const double* __restrict__ lgr_val,
    double* __restrict__ vg) {
  extern __shared__ double sm[];
  double* sd = sm;          // [W] this atom's dE/dB
  double* du = sm + W;      // [2U] dE/dutot
  const long long a = blockIdx.x;
  const int U = two_u / 2;
  const double* zra = zr + a * nz;
  const double* zia = zi + a * nz;
  for (int t = threadIdx.x; t < W; t += blockDim.x) sd[t] = dedb[a * W + t];
  __syncthreads();
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    double r = 0.0, i = 0.0;
    for (int q = yu_ptr[u]; q < yu_ptr[u + 1]; ++q) {
      const double w = sd[yu_t[q]] * yu_fac[q];
      const int src = yu_src[q];
      r += w * zra[src];
      i += w * zia[src];
    }
    du[u] = r;
    du[U + u] = i;
  }
  __syncthreads();
  for (int de = threadIdx.x; de < nt2; de += blockDim.x) {
    double acc = 0.0;
    for (int q = lgr_ptr[de]; q < lgr_ptr[de + 1]; ++q)
      acc += du[lgr_col[q]] * lgr_val[q];
    vg[a * nt2 + de] = acc;
  }
}

// K10T.  Entries a thread held in registers (the rest, where a thread has
// more, read in turn).
constexpr int K10T_REGS = 8;
constexpr int K10T_ZR = 8;                   // z gathers a thread a round

// Shared doubles of K10T's block: the atom's vgc, du and the threads'
// partial sums and, in the staged shape, its referenced z entries and the
// Lg table (nlg values and, as ints, nlg rows and 2U + 1 column starts).
__host__ __device__ inline size_t k10t_doubles(int nt2, int two_u,
                                               int threads, int nzr, int nlg,
                                               bool staged) {
  const size_t base = static_cast<size_t>(nt2) + two_u + threads;
  return staged ? base + 2 * nzr + nlg + (nlg + two_u + 2) / 2 : base;
}

// K10T's narrow block: up to K10T_NARROW threads, four blocks an SM
// (ops/snap.py K10T_BLOCK sizes the schedule to it).
constexpr int K10T_NARROW = 288;

template <bool STAGED, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nn_dedu_vg_t_kernel(
    const double* __restrict__ vgc, const double* __restrict__ zr,
    const double* __restrict__ zi, int W, int nz, int two_u, int nlg,
    const int* __restrict__ lgc_ptr, const int* __restrict__ lgc_row,
    const double* __restrict__ lgc_val, int nt2, int nzr,
    const int* __restrict__ yz_src, int per, int key_bits,
    const int* __restrict__ ys_key,
    const double* __restrict__ ys_fac, const int* __restrict__ ys_seg,
    double* __restrict__ out) {
  extern __shared__ double sm[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int U = two_u / 2;
  double* sv = sm;                   // [nt2] the grid cotangent
  double* du = sv + nt2;             // [2U] its image on utot
  double* part = du + two_u;         // [T] the threads' partial sums
  double* zc = part + T;             // staged: [2][nzr] z entries
  double* lv = zc + 2 * nzr;         // staged: [nlg] Lg by column
  int* lr = reinterpret_cast<int*>(lv + nlg);    // staged: [nlg]
  int* lp = lr + nlg;                            // staged: [2U + 1]
  const long long a = blockIdx.x;
  const double* zra = zr + a * nz;
  const double* zia = zi + a * nz;

  // this thread's first K10T_REGS y entries and its descriptor's segments,
  // then the copies: the atom's vgc and (staged) its referenced z entries
  // and Lg, all in flight at once
  int key[K10T_REGS];
  double fac[K10T_REGS];
#pragma unroll
  for (int j = 0; j < K10T_REGS; ++j) {
    key[j] = j < per ? ys_key[j * T + tid] : 0;
    fac[j] = j < per ? ys_fac[j * T + tid] : 0.0;
  }
  const int s0 = tid < W ? ys_seg[tid] : 0;
  const int s1 = tid < W ? ys_seg[tid + 1] : 0;
  for (int i = tid; i < nt2; i += T) fs_cp_async8(sv + i, vgc + a * nt2 + i);
  if (STAGED) {
    for (int i = tid; i < nlg; i += T) {
      fs_cp_async8(lv + i, lgc_val + i);
      fs_cp_async4(lr + i, lgc_row + i);
    }
    for (int i = tid; i <= two_u; i += T) fs_cp_async4(lp + i, lgc_ptr + i);
    // the z gathers: K10T_ZR indices a round, loaded before their copies
    for (int i0 = tid; i0 < nzr; i0 += K10T_ZR * T) {
      int src[K10T_ZR];
#pragma unroll
      for (int r = 0; r < K10T_ZR; ++r)
        src[r] = i0 + r * T < nzr ? yz_src[i0 + r * T] : -1;
#pragma unroll
      for (int r = 0; r < K10T_ZR; ++r) {
        if (src[r] < 0) continue;
        fs_cp_async8(zc + i0 + r * T, zra + src[r]);
        fs_cp_async8(zc + nzr + i0 + r * T, zia + src[r]);
      }
    }
  }
  fs_cp_async_wait_all();
  __syncthreads();

  // du = vgc . Lg, a thread a column
  const int* cp = STAGED ? lp : lgc_ptr;
  const int* cr = STAGED ? lr : lgc_row;
  const double* cv = STAGED ? lv : lgc_val;
  for (int u = tid; u < two_u; u += T) {
    double acc = 0.0;
    for (int q = cp[u]; q < cp[u + 1]; ++q) acc += sv[cr[q]] * cv[q];
    du[u] = acc;
  }
  __syncthreads();

  // the y entries: thread i sums its segment's `per` entries (zero factors
  // past its end) in order
  auto entry = [&](int kk, double f) {
    const int u = kk & ((1 << key_bits) - 1);
    const int z = kk >> key_bits;
    double r, im;
    if (STAGED) {
      r = zc[z];
      im = zc[nzr + z];
    } else {
      const int src = yz_src[z];
      r = zra[src];
      im = zia[src];
    }
    return f * (r * du[u] + im * du[U + u]);
  };
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < K10T_REGS; ++j) acc += entry(key[j], fac[j]);
  for (int j = K10T_REGS; j < per; ++j)
    acc += entry(ys_key[j * T + tid], ys_fac[j * T + tid]);
  part[tid] = acc;
  __syncthreads();

  // a descriptor: its segments' sums in order
  if (tid < W) {
    double s = 0.0;
    for (int q = s0; q < s1; ++q) s += part[q];
    out[a * W + tid] = s;
  }
}

}  // namespace

// dedb (N, W) f64, zr, zi (N, nz) f64 (K2's z-lists of the atoms' ut); the
// y entries by U column (yu_ptr (U + 1,), yu_t, yu_src i32, yu_fac f64) and
// Lg by grid row (lgr_ptr (n_t^2 + 1,), lgr_col i32, lgr_val f64).  Writes
// vg (N, n_t^2).
extern "C" int nn_dedu_vg(const double* dedb, const double* zr,
                          const double* zi, long long natoms, int W, int nz,
                          int two_u, const int* yu_ptr, const int* yu_t,
                          const int* yu_src, const double* yu_fac, int nt2,
                          const int* lgr_ptr, const int* lgr_col,
                          const double* lgr_val, double* vg, void* stream) {
  const size_t smem = sizeof(double) * (W + two_u);
  const int err = fs_allow_smem(nn_dedu_vg_kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    nn_dedu_vg_kernel<<<static_cast<unsigned>(natoms), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        dedb, zr, zi, W, nz, two_u, yu_ptr, yu_t, yu_src, yu_fac, nt2,
        lgr_ptr, lgr_col, lgr_val, vg);
  }
  return static_cast<int>(cudaGetLastError());
}

// vgc (N, n_t^2) f64, zr, zi (N, nz) f64; Lg by U column (nlg entries:
// lgc_ptr (2U + 1,), lgc_row i32, lgc_val f64); the nzr z entries the y
// tables reference (yz_src i32, sorted) and the y entries' schedule
// (ops/snap.py `k10t_schedule`: `per` entries a thread of `threads` (at
// least W), ys_key i32 u | zc << key_bits, ys_fac f64, ys_seg (W + 1,)
// i32).  Writes out (N, W).
extern "C" int nn_dedu_vg_t(const double* vgc, const double* zr,
                            const double* zi, long long natoms, int W, int nz,
                            int two_u, int nlg, const int* lgc_ptr,
                            const int* lgc_row, const double* lgc_val,
                            int nt2, int nzr, const int* yz_src, int threads,
                            int per, int key_bits, const int* ys_key,
                            const double* ys_fac, const int* ys_seg,
                            double* out, void* stream) {
  if (threads % 32 != 0 || threads > 1024 || threads < W
      || key_bits < 1 || key_bits > 30 || two_u / 2 > 1 << key_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged shape while the atom's z entries and Lg fit a block, else
  // both read from L2
  const bool staged = k10t_doubles(nt2, two_u, threads, nzr, nlg, true)
                      * sizeof(double) <= FS_SMEM_LIMIT;
  const size_t smem = sizeof(double)
                      * k10t_doubles(nt2, two_u, threads, nzr, nlg, staged);
  const auto kernel = !staged ? nn_dedu_vg_t_kernel<false, 1024, 1>
                       : threads <= K10T_NARROW
                           ? nn_dedu_vg_t_kernel<true, K10T_NARROW, 4>
                           : nn_dedu_vg_t_kernel<true, 1024, 1>;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        vgc, zr, zi, W, nz, two_u, nlg, lgc_ptr, lgc_row, lgc_val, nt2, nzr,
        yz_src, per, key_bits, ys_key, ys_fac, ys_seg, out);
  }
  return static_cast<int>(cudaGetLastError());
}
