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
// Both kernels: one atom a block, its time the block's chain of loads and
// sums.  (1) At the start, everything the block reads is put in flight at
// once: each thread's first few y entries into registers, and by
// asynchronous copies the atom's own input (K10 dE/dB, K10T vgc), the Lg
// table (K10 by grid row, K10T by U column) and the z entries the y tables
// reference (yz_src, a sorted list built on the host, its indices loaded
// ZR at a time ahead of their copies; the y entries index this compact z,
// 22 KB an atom at twojmax 6, 70 KB at 8).  Where they would not fit a
// block (twojmax 10 and up), the second launch shape reads z and Lg from
// L2 instead.  (2) The y entries, in a host-built schedule (ops/snap.py
// `deal`: K10's by U column, K10T's by descriptor), go to every thread of
// the block: each group's entries, in compact z order, are dealt
// round-robin to segments of at most `per` (K10 9, K10T 8 at twojmax 6),
// one a thread, laid out [entry][thread]; so no thread holds more than
// `per` entries in series (a U column has up to 17 at twojmax 6, a
// descriptor 147), and at each step a group's threads read neighboring z
// in shared memory.  (3) A group's output sums its segments' partial sums
// in order.  K10 then forms vg = Lg . du a thread a nonzero row of Lg,
// the longest rows first (574 of the 784 rows are empty at twojmax 6, and
// a warp of consecutive rows waited on its longest, 16 entries), over
// zeros stored while the copies were in flight; K10T forms du = vgc . Lg
// first, a thread a column, and its descriptors last.  The block is the
// schedule's `threads` (288 at twojmax 6: 56 registers, four blocks an SM,
// so the Ta minibatch's 512 atoms run in one wave).  K10's time is mostly
// its z gathers (measured on the H100): the 928 32-byte sectors of an
// atom's z that hold a referenced entry, read well under the HBM rate.
// Measured on the H100 and not kept: for K10T two atoms a block (each table
// entry read once for both; slower at both minibatch shapes), 256 threads
// (slower), the pairs (z_r, z_i) and (du_r, du_i) as 16-byte loads
// (slower), Lg read from L2 in place of staged (as fast at 4 x 128 x 64,
// slower at 4 x 8 x 64); for K10 more entries in registers (spills;
// slower), z staged as 16-byte pairs (its copies barely faster, the whole
// slower with its larger block), Lg read from L2 (faster at 4 x 128 x 64,
// slower at 4 x 8 x 64), vg gathered in shared memory and stored coalesced
// (slower).
//
// Float32 (the `_f32` entry points, the NN solver's float32 cached and OTF
// modes): both kernels are templates on the working type T, with the same
// schedules, staging and order of sums at T: z from K2's float32 output,
// the y factors and Lg from the float32 plan (each rounded once from
// float64), every sum float32.  The staged shape's shared memory halves,
// so it reaches further up in twojmax.
#include "common.cuh"

namespace {

// Entries a thread holds in registers (the rest, where a thread has more,
// read in turn: K10's 9 at twojmax 6 spill past the narrow bounds' 56
// registers, which costs more than reading 5 in turn), and the z gathers a
// thread issues a round.
constexpr int K10T_REGS = 8;
constexpr int K10_REGS = 4;
constexpr int ZR = 8;

// The narrow launch bounds: blocks of up to 12 warps at 56 registers, so
// that four blocks of 9 warps (ops/snap.py `deal`'s block where it can)
// share an SM; wider blocks take the bounds of 1,024 threads, one block an
// SM.
constexpr int NARROW_THREADS = 384;
constexpr int NARROW_BLOCKS = 3;

// The compact z entries of atom a (zra, zia its rows), K10's and K10T's
// gathers: ZR indices a round, loaded before their copies.
template <typename T>
__device__ __forceinline__ void stage_z(const T* __restrict__ zra,
                                        const T* __restrict__ zia,
                                        int nzr,
                                        const int* __restrict__ yz_src,
                                        T* zc) {
  const int nth = blockDim.x;
  for (int i0 = threadIdx.x; i0 < nzr; i0 += ZR * nth) {
    int src[ZR];
#pragma unroll
    for (int r = 0; r < ZR; ++r)
      src[r] = i0 + r * nth < nzr ? yz_src[i0 + r * nth] : -1;
#pragma unroll
    for (int r = 0; r < ZR; ++r) {
      if (src[r] < 0) continue;
      fs_cp_async_elem(zc + i0 + r * nth, zra + src[r]);
      fs_cp_async_elem(zc + nzr + i0 + r * nth, zia + src[r]);
    }
  }
}

// Shared values (at the working type) of K10's block: dE/dB, du, the
// slots' partial sums (real and imaginary) and, in the staged shape, the
// referenced z entries and the Lg row table (nlg values and, as ints, nlg
// columns, nlr + 1 row starts and the nlr rows; `ipv` ints a value).
__host__ __device__ inline size_t k10_doubles(int W, int two_u, int stride,
                                              int nzr, int nlg, int nlr,
                                              bool staged, int ipv = 2) {
  const size_t base = static_cast<size_t>(W) + two_u + 2 * stride;
  return staged ? base + 2 * nzr + nlg + (nlg + 2 * nlr + ipv) / ipv : base;
}

template <typename T, bool STAGED, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nn_dedu_vg_kernel(
    const T* __restrict__ dedb, const T* __restrict__ zr,
    const T* __restrict__ zi, int W, int nz, int two_u, int nt2,
    int nlr, int nlg, const int* __restrict__ lgr_row,
    const int* __restrict__ lgr_ptr, const int* __restrict__ lgr_col,
    const T* __restrict__ lgr_val, int nzr,
    const int* __restrict__ yz_src, int per, int stride, int key_bits,
    const int* __restrict__ yc_key, const T* __restrict__ yc_fac,
    const int* __restrict__ yc_seg, T* __restrict__ vg) {
  extern __shared__ __align__(16) unsigned char smem_k10[];
  T* sm = reinterpret_cast<T*>(smem_k10);
  const int nth = blockDim.x, tid = threadIdx.x;
  const int U = two_u / 2;
  T* sd = sm;                        // [W] this atom's dE/dB
  T* du = sd + W;                    // [2U] dE/dutot
  T* part = du + two_u;              // [2][stride] the slots' partial sums
  T* zc = part + 2 * stride;         // staged: [2][nzr] z entries
  T* lv = zc + 2 * nzr;              // staged: [nlg] Lg by row
  int* lc = reinterpret_cast<int*>(lv + nlg);    // staged: [nlg]
  int* lp = lc + nlg;                            // staged: [nlr + 1]
  int* lr = lp + nlr + 1;                        // staged: [nlr]
  const long long a = blockIdx.x;
  const T* zra = zr + a * nz;
  const T* zia = zi + a * nz;

  // this thread's first K10_REGS y entries and its column's segments, then
  // the copies: the atom's dE/dB and (staged) its referenced z entries and
  // the Lg rows, all in flight at once; vg zeroed meanwhile (most of its
  // rows are: Lg's empty ones)
  int key[K10_REGS];
  T fac[K10_REGS];
#pragma unroll
  for (int j = 0; j < K10_REGS; ++j) {
    key[j] = j < per ? yc_key[j * stride + tid] : 0;
    fac[j] = j < per ? yc_fac[j * stride + tid] : T(0);
  }
  const int s0 = tid < U ? yc_seg[tid] : 0;
  const int s1 = tid < U ? yc_seg[tid + 1] : 0;
  for (int i = tid; i < W; i += nth)
    fs_cp_async_elem(sd + i, dedb + a * W + i);
  if (STAGED) {
    for (int i = tid; i < nlg; i += nth) {
      fs_cp_async_elem(lv + i, lgr_val + i);
      fs_cp_async4(lc + i, lgr_col + i);
    }
    for (int i = tid; i <= nlr; i += nth) {
      fs_cp_async4(lp + i, lgr_ptr + i);
      if (i < nlr) fs_cp_async4(lr + i, lgr_row + i);
    }
    stage_z(zra, zia, nzr, yz_src, zc);
  }
  for (int de = tid; de < nt2; de += nth) vg[a * nt2 + de] = T(0);
  fs_cp_async_wait_all();
  __syncthreads();

  // the y entries: slot s sums its segment's `per` entries (zero factors
  // past its end) in order, real and imaginary parts apart
  const int mask = (1 << key_bits) - 1;
  auto entry = [&](int kk, T f, T& r, T& im) {
    const T w = sd[kk & mask] * f;
    const int z = kk >> key_bits;
    if (STAGED) {
      r += w * zc[z];
      im += w * zc[nzr + z];
    } else {
      const int src = yz_src[z];
      r += w * zra[src];
      im += w * zia[src];
    }
  };
  for (int sl = tid; sl < stride; sl += nth) {
    T r = T(0), im = T(0);
    if (sl == tid) {
#pragma unroll
      for (int j = 0; j < K10_REGS; ++j) entry(key[j], fac[j], r, im);
      for (int j = K10_REGS; j < per; ++j)
        entry(yc_key[j * stride + sl], yc_fac[j * stride + sl], r, im);
    } else {
      for (int j = 0; j < per; ++j)
        entry(yc_key[j * stride + sl], yc_fac[j * stride + sl], r, im);
    }
    part[sl] = r;
    part[stride + sl] = im;
  }
  __syncthreads();

  // a U column: its segments' sums in order
  for (int u = tid; u < U; u += nth) {
    const int q0 = u == tid ? s0 : yc_seg[u];
    const int q1 = u == tid ? s1 : yc_seg[u + 1];
    T r = T(0), im = T(0);
    for (int q = q0; q < q1; ++q) {
      r += part[q];
      im += part[stride + q];
    }
    du[u] = r;
    du[U + u] = im;
  }
  __syncthreads();

  // vg = Lg . du, a thread a nonzero row (the longest first, so that a
  // warp's rows are of like length), over the zeros stored above
  const int* rr = STAGED ? lr : lgr_row;
  const int* rp = STAGED ? lp : lgr_ptr;
  const int* rc = STAGED ? lc : lgr_col;
  const T* rv = STAGED ? lv : lgr_val;
  for (int r = tid; r < nlr; r += nth) {
    T acc = T(0);
    for (int q = rp[r]; q < rp[r + 1]; ++q) acc += du[rc[q]] * rv[q];
    vg[a * nt2 + rr[r]] = acc;
  }
}

// K10T.  Shared values (at the working type) of K10T's block: the atom's
// vgc, du and the threads' partial sums and, in the staged shape, its
// referenced z entries and the Lg table (nlg values and, as ints, nlg rows
// and 2U + 1 column starts; `ipv` ints a value).
__host__ __device__ inline size_t k10t_doubles(int nt2, int two_u,
                                               int threads, int nzr, int nlg,
                                               bool staged, int ipv = 2) {
  const size_t base = static_cast<size_t>(nt2) + two_u + threads;
  return staged ? base + 2 * nzr + nlg + (nlg + two_u + ipv) / ipv : base;
}

template <typename T, bool STAGED, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) nn_dedu_vg_t_kernel(
    const T* __restrict__ vgc, const T* __restrict__ zr,
    const T* __restrict__ zi, int W, int nz, int two_u, int nlg,
    const int* __restrict__ lgc_ptr, const int* __restrict__ lgc_row,
    const T* __restrict__ lgc_val, int nt2, int nzr,
    const int* __restrict__ yz_src, int per, int key_bits,
    const int* __restrict__ ys_key,
    const T* __restrict__ ys_fac, const int* __restrict__ ys_seg,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_k10t[];
  T* sm = reinterpret_cast<T*>(smem_k10t);
  const int nth = blockDim.x, tid = threadIdx.x;
  const int U = two_u / 2;
  T* sv = sm;                        // [nt2] the grid cotangent
  T* du = sv + nt2;                  // [2U] its image on utot
  T* part = du + two_u;              // [threads] the threads' partial sums
  T* zc = part + nth;                // staged: [2][nzr] z entries
  T* lv = zc + 2 * nzr;              // staged: [nlg] Lg by column
  int* lr = reinterpret_cast<int*>(lv + nlg);    // staged: [nlg]
  int* lp = lr + nlg;                            // staged: [2U + 1]
  const long long a = blockIdx.x;
  const T* zra = zr + a * nz;
  const T* zia = zi + a * nz;

  // this thread's first K10T_REGS y entries and its descriptor's segments,
  // then the copies: the atom's vgc and (staged) its referenced z entries
  // and Lg, all in flight at once
  int key[K10T_REGS];
  T fac[K10T_REGS];
#pragma unroll
  for (int j = 0; j < K10T_REGS; ++j) {
    key[j] = j < per ? ys_key[j * nth + tid] : 0;
    fac[j] = j < per ? ys_fac[j * nth + tid] : T(0);
  }
  const int s0 = tid < W ? ys_seg[tid] : 0;
  const int s1 = tid < W ? ys_seg[tid + 1] : 0;
  for (int i = tid; i < nt2; i += nth)
    fs_cp_async_elem(sv + i, vgc + a * nt2 + i);
  if (STAGED) {
    for (int i = tid; i < nlg; i += nth) {
      fs_cp_async_elem(lv + i, lgc_val + i);
      fs_cp_async4(lr + i, lgc_row + i);
    }
    for (int i = tid; i <= two_u; i += nth)
      fs_cp_async4(lp + i, lgc_ptr + i);
    stage_z(zra, zia, nzr, yz_src, zc);
  }
  fs_cp_async_wait_all();
  __syncthreads();

  // du = vgc . Lg, a thread a column
  const int* cp = STAGED ? lp : lgc_ptr;
  const int* cr = STAGED ? lr : lgc_row;
  const T* cv = STAGED ? lv : lgc_val;
  for (int u = tid; u < two_u; u += nth) {
    T acc = T(0);
    for (int q = cp[u]; q < cp[u + 1]; ++q) acc += sv[cr[q]] * cv[q];
    du[u] = acc;
  }
  __syncthreads();

  // the y entries: thread i sums its segment's `per` entries (zero factors
  // past its end) in order
  auto entry = [&](int kk, T f) {
    const int u = kk & ((1 << key_bits) - 1);
    const int z = kk >> key_bits;
    T r, im;
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
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < K10T_REGS; ++j) acc += entry(key[j], fac[j]);
  for (int j = K10T_REGS; j < per; ++j)
    acc += entry(ys_key[j * nth + tid], ys_fac[j * nth + tid]);
  part[tid] = acc;
  __syncthreads();

  // a descriptor: its segments' sums in order
  if (tid < W) {
    T s = T(0);
    for (int q = s0; q < s1; ++q) s += part[q];
    out[a * W + tid] = s;
  }
}

template <typename T>
int nn_dedu_vg_launch(const T* dedb, const T* zr, const T* zi,
                      long long natoms, int W, int nz, int two_u, int nt2,
                      int nlr, int nlg, const int* lgr_row,
                      const int* lgr_ptr, const int* lgr_col,
                      const T* lgr_val, int nzr, const int* yz_src,
                      int threads, int per, int stride, int key_bits,
                      const int* yc_key, const T* yc_fac, const int* yc_seg,
                      T* vg, void* stream) {
  if (threads % 32 != 0 || threads > 1024 || stride < threads
      || key_bits < 1 || key_bits > 30 || W > 1 << key_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged shape while the atom's z entries and Lg fit a block, else
  // both read from L2
  const int ipv = sizeof(T) / sizeof(int);
  const bool staged = k10_doubles(W, two_u, stride, nzr, nlg, nlr, true, ipv)
                      * sizeof(T) <= FS_SMEM_LIMIT;
  const size_t smem = sizeof(T) * k10_doubles(W, two_u, stride, nzr, nlg,
                                              nlr, staged, ipv);
  const auto kernel =
      !staged ? nn_dedu_vg_kernel<T, false, 1024, 1>
      : threads <= NARROW_THREADS
          ? nn_dedu_vg_kernel<T, true, NARROW_THREADS, NARROW_BLOCKS>
          : nn_dedu_vg_kernel<T, true, 1024, 1>;
  const int err = fs_allow_smem(kernel, smem);
  if (err) return err;
  if (natoms > 0) {
    kernel<<<static_cast<unsigned>(natoms), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        dedb, zr, zi, W, nz, two_u, nt2, nlr, nlg, lgr_row, lgr_ptr, lgr_col,
        lgr_val, nzr, yz_src, per, stride, key_bits, yc_key, yc_fac, yc_seg,
        vg);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int nn_dedu_vg_t_launch(const T* vgc, const T* zr, const T* zi,
                        long long natoms, int W, int nz, int two_u, int nlg,
                        const int* lgc_ptr, const int* lgc_row,
                        const T* lgc_val, int nt2, int nzr,
                        const int* yz_src, int threads, int per,
                        int key_bits, const int* ys_key, const T* ys_fac,
                        const int* ys_seg, T* out, void* stream) {
  if (threads % 32 != 0 || threads > 1024 || threads < W
      || key_bits < 1 || key_bits > 30 || two_u / 2 > 1 << key_bits)
    return static_cast<int>(cudaErrorInvalidValue);
  // the staged shape while the atom's z entries and Lg fit a block, else
  // both read from L2
  const int ipv = sizeof(T) / sizeof(int);
  const bool staged = k10t_doubles(nt2, two_u, threads, nzr, nlg, true, ipv)
                      * sizeof(T) <= FS_SMEM_LIMIT;
  const size_t smem = sizeof(T) * k10t_doubles(nt2, two_u, threads, nzr, nlg,
                                               staged, ipv);
  const auto kernel =
      !staged ? nn_dedu_vg_t_kernel<T, false, 1024, 1>
      : threads <= NARROW_THREADS
          ? nn_dedu_vg_t_kernel<T, true, NARROW_THREADS, NARROW_BLOCKS>
          : nn_dedu_vg_t_kernel<T, true, 1024, 1>;
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

}  // namespace

// dedb (N, W) f64, zr, zi (N, nz) f64 (K2's z-lists of the atoms' ut); Lg
// by grid row (its nlr nonzero rows lgr_row i32, longest first, and their
// nlg entries: lgr_ptr (nlr + 1,), lgr_col i32, lgr_val f64); the nzr z
// entries the y tables reference (yz_src i32, sorted) and
// the y entries' schedule by U column (ops/snap.py `deal`: `per` entries a
// slot, `stride` slots, `threads` threads, yc_key i32 t | zc << key_bits,
// yc_fac f64, yc_seg (U + 1,) i32).  Writes vg (N, n_t^2).
extern "C" int nn_dedu_vg(const double* dedb, const double* zr,
                          const double* zi, long long natoms, int W, int nz,
                          int two_u, int nt2, int nlr, int nlg,
                          const int* lgr_row, const int* lgr_ptr,
                          const int* lgr_col, const double* lgr_val, int nzr,
                          const int* yz_src, int threads, int per,
                          int stride, int key_bits, const int* yc_key,
                          const double* yc_fac, const int* yc_seg,
                          double* vg, void* stream) {
  return nn_dedu_vg_launch<double>(
      dedb, zr, zi, natoms, W, nz, two_u, nt2, nlr, nlg, lgr_row, lgr_ptr,
      lgr_col, lgr_val, nzr, yz_src, threads, per, stride, key_bits, yc_key,
      yc_fac, yc_seg, vg, stream);
}

// The float32 instantiation: dedb, zr, zi, lgr_val, yc_fac and vg f32 (a
// float32 plan's tables).
extern "C" int nn_dedu_vg_f32(const float* dedb, const float* zr,
                              const float* zi, long long natoms, int W,
                              int nz, int two_u, int nt2, int nlr, int nlg,
                              const int* lgr_row, const int* lgr_ptr,
                              const int* lgr_col, const float* lgr_val,
                              int nzr, const int* yz_src, int threads,
                              int per, int stride, int key_bits,
                              const int* yc_key, const float* yc_fac,
                              const int* yc_seg, float* vg, void* stream) {
  return nn_dedu_vg_launch<float>(
      dedb, zr, zi, natoms, W, nz, two_u, nt2, nlr, nlg, lgr_row, lgr_ptr,
      lgr_col, lgr_val, nzr, yz_src, threads, per, stride, key_bits, yc_key,
      yc_fac, yc_seg, vg, stream);
}

// vgc (N, n_t^2) f64, zr, zi (N, nz) f64; Lg by U column (nlg entries:
// lgc_ptr (2U + 1,), lgc_row i32, lgc_val f64); the nzr z entries the y
// tables reference (yz_src i32, sorted) and the y entries' schedule by
// descriptor (ops/snap.py `deal`: `per` entries a thread of `threads` (at
// least W, one slot each), ys_key i32 u | zc << key_bits, ys_fac f64,
// ys_seg (W + 1,) i32).  Writes out (N, W).
extern "C" int nn_dedu_vg_t(const double* vgc, const double* zr,
                            const double* zi, long long natoms, int W, int nz,
                            int two_u, int nlg, const int* lgc_ptr,
                            const int* lgc_row, const double* lgc_val,
                            int nt2, int nzr, const int* yz_src, int threads,
                            int per, int key_bits, const int* ys_key,
                            const double* ys_fac, const int* ys_seg,
                            double* out, void* stream) {
  return nn_dedu_vg_t_launch<double>(
      vgc, zr, zi, natoms, W, nz, two_u, nlg, lgc_ptr, lgc_row, lgc_val, nt2,
      nzr, yz_src, threads, per, key_bits, ys_key, ys_fac, ys_seg, out,
      stream);
}

// The float32 instantiation: vgc, zr, zi, lgc_val, ys_fac and out f32.
extern "C" int nn_dedu_vg_t_f32(const float* vgc, const float* zr,
                                const float* zi, long long natoms, int W,
                                int nz, int two_u, int nlg,
                                const int* lgc_ptr, const int* lgc_row,
                                const float* lgc_val, int nt2, int nzr,
                                const int* yz_src, int threads, int per,
                                int key_bits, const int* ys_key,
                                const float* ys_fac, const int* ys_seg,
                                float* out, void* stream) {
  return nn_dedu_vg_t_launch<float>(
      vgc, zr, zi, natoms, W, nz, two_u, nlg, lgc_ptr, lgc_row, lgc_val, nt2,
      nzr, yz_src, threads, per, key_bits, ys_key, ys_fac, ys_seg, out,
      stream);
}
