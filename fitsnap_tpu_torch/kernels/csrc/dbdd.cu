// K3 dbdd: per atom, dB/dutot from the three y-layers of the z-lists, the
// bispectrum B from the first layer, and the pair jacobian
//   dBdD[a, w, k, c] = sum_u y[a, w, ch(a, k), u] * J[c, a, k, u],
// where ch(a, k) is the utot channel of neighbor k: 0 with one channel, the
// neighbor's element in the chemflag mode (nc > 1 channels, y resolved by
// channel; a neighbor whose element is no channel gets zeros).
//
// Replaces fitsnap_tpu/ops/snap.py `_dbdu_ylist` and the contractions of
// `descriptors_with_jacobian` (the Bbase einsums and
// einsum("awu,caku->awkc") at ops/snap.py:956-971); in the chemflag mode
// `_chem_b_and_dbdu` (ops/snap.py:992-1058) and the contraction
// einsum("awnu,akn,caku->awkc") at :981-982.
//
// Bound on the H100: bytes, in all three modes.  The kernel must read J
// (3 x K x 2U doubles per atom, 430 KB at K = 64, twojmax 6) once and
// write dB/dD; its FP64 work, counted over y's nonzero entries (a row holds
// only the u levels of its triple's three layers and, in the chemflag mode,
// only the layers of the neighbor's channel), is 20 flops per J double at
// twojmax 6, 31 at twojmax 8 and 96 with InP's two channels (dense: 60,
// 110, 480), under the 160 a double that the FP64 tensor cores (67 T/s) do
// in the time HBM (3.35 TB/s) delivers one.
//
// Design: the per-atom product of atom_gemm.cuh, L = the atom's y rows.
// One block per (atom, tile of W), W split evenly over the tiles of at most
// MT (16 or 32) rows, planned by the wrapper (`dbdd_tiles`) so that two
// blocks share an SM where one channel's y rows (MT x 2U doubles) and the
// product's epilogue stage fit half its shared memory: one tile of 30 rows at twojmax 6, four of 14 at
// twojmax 8, eight of 30 with InP's two channels; the tiles of an atom have
// neighbouring block indices, so their J reads after the first hit L2.
//   1. y rows and the zero-block flags are cleared; warp 0 lists the
//      neighbors of channel ch by ballot, in slot order (one channel: all
//      of them), and those of no channel;
//   2. a warp per row forms B (first pass only: the fac-0 layer of the
//      row's channel against utot, lanes over u, a fixed butterfly), then
//      writes the row's nonzero y entries for channel ch from the host's
//      compact target list (the (triple, u) with a nonzero y_fac, each with
//      its three layers' sources and factors, summed in layer order as the
//      plain version does) and flags the (row tile, k-step) blocks it
//      touches;
//   3. the product runs over the columns (neighbor, direction) of channel
//      ch's neighbors only, so a neighbor meets its own channel's y rows
//      alone, skipping zero blocks; 1-3 repeat per channel;
//   4. the neighbors of no channel get zeros.
// Past twojmax 12, 16 whole y rows (2U doubles each) exceed a block's shared
// memory: the slab shape (`dbdd_slab_kernel`, the wrapper's `dbdd_plan`)
// takes rows of 32 and builds y a slab of u columns at a time, the
// accumulators carried across the slabs in inner order.
// Padding slots carry J = 0 and come out exactly 0.  No atomics: the
// output repeats bit for bit.
// Working types: the whole-row shape also has a float32 instantiation
// (`dbdd_f32`, the streamed linear SNAP fit at float32: float32 utot,
// z-lists, J and tables, y rows of float32 in shared memory), whose product
// is atom_gemm.cuh's float32 FMA path; the slab shape is float64 only.
#include "atom_gemm.cuh"

namespace {

template <typename T>
struct Args {
  const T* ut;               // (N, nc 2U)
  const T* zr;               // (N, nc^2, nz)
  const T* zi;
  const T* J;                // (3, N, K, 2U)
  const int* jelem;          // (N, K), read when nc > 1
  const int* tg_ptr;         // (ntrip + 1,) targets of triple t
  const int* tg_u;           // (nT,) u of each target
  const int* tg_src;         // (nT, 3) z index of each layer
  const T* tg_fac;           // (nT, 3) factor of each layer (0: none)
  const int4* tg_slab;       // slab shape: (ntrip, nslab) target ranges
  const int* y_src;          // (3, ntrip, U): layer 0 forms B
  const T* y_fac;
  const int* blk_chan;       // (nc^3, 3) channel of each layer
  const int* blk_pair;       // (nc^3, 3) z channel pair it reads
  const T* bzero;            // (W,)
  int W, ntrip, U, nz, nc, K, MT, ntiles;
  long long N;
};

template <int IW, typename T>
__global__ void __launch_bounds__(AG_THREADS, 2)
    dbdd_kernel(Args<T> p, T* __restrict__ B, T* __restrict__ dBdD) {
  extern __shared__ __align__(16) unsigned char smem_y[];
  const int two_u = 2 * p.U;
  const int ldl = ag_ldl(two_u);
  const int nks = ldl / 8;                   // k-steps of a y row
  T* y = reinterpret_cast<T*>(smem_y);       // [MT][ldl]
  T* stage = y + p.MT * ldl;                 // [AG_STAGE]
  int* slot = reinterpret_cast<int*>(stage + AG_STAGE);  // [K]
  int* none = slot + p.K;                    // [K] neighbors of no channel
  int* count = none + p.K;                   // [2]
  unsigned char* nzf = reinterpret_cast<unsigned char*>(count + 2);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long a = blockIdx.x / p.ntiles;
  const int per = (p.W + p.ntiles - 1) / p.ntiles;   // <= MT
  const int w0 = (blockIdx.x % p.ntiles) * per;
  const int rows = min(per, p.W - w0);
  const long long zrow = static_cast<long long>(p.nc) * p.nc * p.nz;
  const T* za_r = p.zr + a * zrow;
  const T* za_i = p.zi + a * zrow;
  const int* jel = p.nc > 1 ? p.jelem + a * p.K : nullptr;

  for (int idx = tid; idx < p.MT * ldl * static_cast<int>(sizeof(T)) / 16;
       idx += AG_THREADS)
    reinterpret_cast<uint4*>(y)[idx] = make_uint4(0u, 0u, 0u, 0u);

  AtomGemmT<T> g{y, ldl, rows, nzf, p.J + a * p.K * two_u,
                 p.N * p.K * two_u, two_u, slot, 0,
                 dBdD + (a * p.W + w0) * p.K * 3, 3LL * p.K, stage};
  for (int ch = 0; ch < p.nc; ++ch) {
    // 1.
    for (int idx = tid; idx < IW * nks; idx += AG_THREADS) nzf[idx] = 0;
    if (warp == 0) {
      int n = 0, nn = 0;
      for (int k0 = 0; k0 < p.K; k0 += 32) {
        const int k = k0 + lane;
        const int e = k < p.K ? (p.nc > 1 ? jel[k] : 0) : -1;
        const unsigned below = (1u << lane) - 1u;
        const unsigned in = __ballot_sync(0xffffffffu, e == ch);
        if (e == ch) slot[n + __popc(in & below)] = k;
        n += __popc(in);
        if (ch == 0) {
          const bool out = k < p.K && (e < 0 || e >= p.nc);
          const unsigned bad = __ballot_sync(0xffffffffu, out);
          if (out) none[nn + __popc(bad & below)] = k;
          nn += __popc(bad);
        }
      }
      if (lane == 0) {
        count[0] = n;
        if (ch == 0) count[1] = nn;
      }
    }
    __syncthreads();
    g.ncols = 3 * count[0];

    // 2.
    for (int r = warp; r < rows; r += AG_THREADS / 32) {
      const int w = w0 + r;
      const int blk = w / p.ntrip;
      const int t = w % p.ntrip;
      if (ch == 0) {
        const T* ua = p.ut + (a * p.nc + p.blk_chan[blk * 3]) * two_u;
        const long long zoff =
            static_cast<long long>(p.blk_pair[blk * 3]) * p.nz;
        // four u a lane at a time: their loads are in flight together
        T s = T(0);
        for (int u0 = lane; u0 < p.U; u0 += 128) {
          T f[4];
          long long src[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            f[k] = u0 + 32 * k < p.U ? p.y_fac[t * p.U + u] : T(0);
            src[k] = zoff + p.y_src[t * p.U + u];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            s += ua[u] * (f[k] * za_r[src[k]]) +
                 ua[p.U + u] * (f[k] * za_i[src[k]]);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) B[a * p.W + w] = s - p.bzero[w];
      }
      if (g.ncols == 0) continue;
      int chan[3];
      long long pair[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        chan[l] = p.blk_chan[blk * 3 + l];
        pair[l] = static_cast<long long>(p.blk_pair[blk * 3 + l]) * p.nz;
      }
      T* yw = y + r * ldl;
      const int q1 = p.tg_ptr[t + 1];
      // two targets a lane at a time: their loads are in flight together
      for (int q0 = p.tg_ptr[t] + lane; q0 < q1; q0 += 64) {
        T yr[2] = {T(0), T(0)}, yi[2] = {T(0), T(0)};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = min(q0 + 32 * k, q1 - 1);
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            if (chan[l] != ch) continue;
            const T f = p.tg_fac[q * 3 + l];
            const long long src = pair[l] + p.tg_src[q * 3 + l];
            yr[k] += f * za_r[src];
            yi[k] += f * za_i[src];
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (q0 + 32 * k >= q1) break;
          const int u = p.tg_u[q0 + 32 * k];
          yw[u] = yr[k];
          yw[p.U + u] = yi[k];
          if (yr[k] != T(0)) nzf[r / 16 * nks + u / 8] = 1;
          if (yi[k] != T(0)) nzf[r / 16 * nks + (p.U + u) / 8] = 1;
        }
      }
    }

    // 3.
    if (g.ncols > 0)
      ag_run<IW>(g);
    else
      __syncthreads();     // count is rewritten by the next pass
  }

  // 4.
  const int nbad = count[1];
  for (int idx = tid; idx < rows * nbad * 3; idx += AG_THREADS) {
    const int r = idx / (nbad * 3);
    const int k = none[(idx / 3) % nbad];
    dBdD[((a * p.W + w0 + r) * p.K + k) * 3 + idx % 3] = T(0);
  }
}

// The slab shape, for y rows past a block's shared memory (twojmax 13 and
// up): rows of MT = 16 IW, and y built `slab` columns at a time into
// [MT][ldl] (ldl = ag_ldl(slab)) for each sweep of the product's columns
// (ag_run_slabs), from the same compact targets: those whose real or
// imaginary column falls in the slab, a range of the triple's u-sorted
// targets for each part (`snap_kernels.dbdd_slab_ranges`), the part alone
// summed; B is formed once, before the product.  The product's chains are ag_run's, so the output equals the
// whole-row shape's bit for bit.
template <int IW>
__global__ void __launch_bounds__(AG_THREADS, 2)
    dbdd_slab_kernel(Args<double> p, int slab, double* __restrict__ B,
                     double* __restrict__ dBdD) {
  using T = double;
  extern __shared__ __align__(16) double smem[];
  const int two_u = 2 * p.U;
  const int ldl = ag_ldl(slab);
  const int nks = ldl / 8;                   // flags of a row tile
  const int nslab = (two_u + slab - 1) / slab;
  double* y = smem;                          // [MT][ldl]
  double* stage = y + p.MT * ldl;            // [AG_STAGE]
  int* slot = reinterpret_cast<int*>(stage + AG_STAGE);  // [K]
  int* none = slot + p.K;                    // [K] neighbors of no channel
  int* count = none + p.K;                   // [2]
  unsigned char* nzf = reinterpret_cast<unsigned char*>(count + 2);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long a = blockIdx.x / p.ntiles;
  const int per = (p.W + p.ntiles - 1) / p.ntiles;   // <= MT
  const int w0 = (blockIdx.x % p.ntiles) * per;
  const int rows = min(per, p.W - w0);
  const long long zrow = static_cast<long long>(p.nc) * p.nc * p.nz;
  const double* za_r = p.zr + a * zrow;
  const double* za_i = p.zi + a * zrow;
  const int* jel = p.nc > 1 ? p.jelem + a * p.K : nullptr;

  AtomGemm g{y, ldl, rows, nzf, p.J + a * p.K * two_u, p.N * p.K * two_u,
             two_u, slot, 0, dBdD + (a * p.W + w0) * p.K * 3, 3LL * p.K,
             stage};
  for (int ch = 0; ch < p.nc; ++ch) {
    // the neighbors of channel ch, and those of no channel
    if (warp == 0) {
      int n = 0, nn = 0;
      for (int k0 = 0; k0 < p.K; k0 += 32) {
        const int k = k0 + lane;
        const int e = k < p.K ? (p.nc > 1 ? jel[k] : 0) : -1;
        const unsigned below = (1u << lane) - 1u;
        const unsigned in = __ballot_sync(0xffffffffu, e == ch);
        if (e == ch) slot[n + __popc(in & below)] = k;
        n += __popc(in);
        if (ch == 0) {
          const bool out = k < p.K && (e < 0 || e >= p.nc);
          const unsigned bad = __ballot_sync(0xffffffffu, out);
          if (out) none[nn + __popc(bad & below)] = k;
          nn += __popc(bad);
        }
      }
      if (lane == 0) {
        count[0] = n;
        if (ch == 0) count[1] = nn;
      }
    }
    // B, a warp a row, as the whole-row shape's
    if (ch == 0) {
      for (int r = warp; r < rows; r += AG_THREADS / 32) {
        const int w = w0 + r;
        const int blk = w / p.ntrip;
        const int t = w % p.ntrip;
        const T* ua = p.ut + (a * p.nc + p.blk_chan[blk * 3]) * two_u;
        const long long zoff =
            static_cast<long long>(p.blk_pair[blk * 3]) * p.nz;
        T s = T(0);
        for (int u0 = lane; u0 < p.U; u0 += 128) {
          T f[4];
          long long src[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            f[k] = u0 + 32 * k < p.U ? p.y_fac[t * p.U + u] : T(0);
            src[k] = zoff + p.y_src[t * p.U + u];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = min(u0 + 32 * k, p.U - 1);
            s += ua[u] * (f[k] * za_r[src[k]]) +
                 ua[p.U + u] * (f[k] * za_i[src[k]]);
          }
        }
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) B[a * p.W + w] = s - p.bzero[w];
      }
    }
    __syncthreads();
    g.ncols = 3 * count[0];
    if (g.ncols == 0) {
      __syncthreads();     // count is rewritten by the next pass
      continue;
    }
    // y's columns [i0, i1) of channel ch and their zero flags
    auto build = [&](int i0, int i1) {
      for (int idx = tid; idx < p.MT * ldl / 2; idx += AG_THREADS)
        reinterpret_cast<double2*>(y)[idx] = make_double2(0.0, 0.0);
      for (int idx = tid; idx < IW * nks; idx += AG_THREADS) nzf[idx] = 0;
      __syncthreads();
      for (int r = warp; r < rows; r += AG_THREADS / 32) {
        const int w = w0 + r;
        const int blk = w / p.ntrip;
        const int t = w % p.ntrip;
        int chan[3];
        long long pair[3];
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          chan[l] = p.blk_chan[blk * 3 + l];
          pair[l] = static_cast<long long>(p.blk_pair[blk * 3 + l]) * p.nz;
        }
        double* yw = y + r * ldl - i0;
        // the targets whose real column (part 0) or imaginary column (part
        // 1, at U + u) falls in the slab: a range of the triple's u-sorted
        // targets each (the host's table); the part alone is summed
        const int4 rg = p.tg_slab[t * nslab + i0 / slab];
        for (int part = 0; part < 2; ++part) {
          const int qa = part ? rg.z : rg.x, qb = part ? rg.w : rg.y;
          const double* za = part ? za_i : za_r;
          for (int q = qa + lane; q < qb; q += 32) {
            const int col = part * p.U + p.tg_u[q];
            double v = 0.0;
#pragma unroll
            for (int l = 0; l < 3; ++l) {
              if (chan[l] != ch) continue;
              v += p.tg_fac[q * 3 + l] * za[pair[l] + p.tg_src[q * 3 + l]];
            }
            yw[col] = v;
            if (v != 0.0) nzf[r / 16 * nks + (col - i0) / 8] = 1;
          }
        }
      }
    };
    ag_run_slabs<IW>(g, slab, build);
  }

  // the neighbors of no channel get zeros
  const int nbad = count[1];
  for (int idx = tid; idx < rows * nbad * 3; idx += AG_THREADS) {
    const int r = idx / (nbad * 3);
    const int k = none[(idx / 3) % nbad];
    dBdD[((a * p.W + w0 + r) * p.K + k) * 3 + idx % 3] = 0.0;
  }
}

template <int IW>
int launch_slab(const Args<double>& p, int slab, size_t smem, double* B,
                double* dBdD, cudaStream_t stream) {
  const int err = fs_allow_smem(dbdd_slab_kernel<IW>, smem);
  if (err) return err;
  if (p.N > 0)
    dbdd_slab_kernel<IW><<<static_cast<unsigned>(p.N * p.ntiles),
                           AG_THREADS, smem, stream>>>(p, slab, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

template <int IW, typename T>
int launch(const Args<T>& p, size_t smem, T* B, T* dBdD,
           cudaStream_t stream) {
  const int err = fs_allow_smem(dbdd_kernel<IW, T>, smem);
  if (err) return err;
  if (p.N > 0)
    dbdd_kernel<IW, T><<<static_cast<unsigned>(p.N * p.ntiles), AG_THREADS,
                         smem, stream>>>(p, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

// The whole-row shape at either type.
template <typename T>
int launch_rows(const Args<T>& p, int MT, T* B, T* dBdD,
                cudaStream_t stream) {
  const int ldl = ag_ldl(2 * p.U);
  const size_t smem = sizeof(T) * (MT * ldl + AG_STAGE) +
                      sizeof(int) * (2 * static_cast<size_t>(p.K) + 2) +
                      MT / 16 * (ldl / 8);
  if (smem > FS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (MT == 16) return launch<1, T>(p, smem, B, dBdD, stream);
  if (MT == 32) return launch<2, T>(p, smem, B, dBdD, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The level shape (one channel, past whole rows: twojmax 13 and up).  The
// inner dimension runs by level: a row's y is nonzero on the levels of its
// triple's three layers only, so that for each level l the product is the
// dense y[R_l, l] . J[l, columns] over the rows R_l whose triple touches l
// (the host's lists, `snap_kernels.dbdd_levels`; at most 64 rows a group,
// a level with more runs in several groups).
//   * A block is (atom, tile of KB neighbor slots: its 3 KB columns
//     (direction, neighbor), at most 128): it reads its columns of the
//     atom's J once, and every row of W meets them there.
//   * A level's columns pass in chunks of 16 (their real and imaginary
//     parts: 32 inner); each chunk of J is staged into shared memory by
//     16-byte asynchronous copies (cp.async, every thread a share, one
//     commit group a chunk), from the even column at or below the chunk's
//     first (the part's shift), LV_STAGES - 1 chunks in flight beyond the
//     one in use.  (The copy engine's bulk copies, one a column row and
//     part, 192 a chunk, were this shape's largest cost on the H100, and
//     its tiled tensor copies raised an illegal instruction there.)
//   * y of a chunk (the group's rows x 32 inner) is built into one of two
//     buffers from the host's records (position, z index, factor; each
//     target's nonzero layers in layer order, on one thread), while the
//     product of the chunk before runs on the other: one barrier a chunk.
//     A thread's records are loaded into registers two chunks ahead and
//     their z values one chunk ahead, so that their latency passes under
//     the product.
//   * The product: mma.sync m16n8k8 f64, warp w the n-tiles w and w + 8 of
//     the tile, every row tile of the group, the accumulators in registers
//     across the level's chunks; at the level's end they are added into
//     dB/dD (written at a row's first level, read and added at its later
//     ones: the block owns its outputs, no atomics), so that each output
//     is the sum of its levels' chains in level order.
//   * B (the first tile's block): a warp a row over the row's layer-0
//     terms, row w + 8 i in chunk iteration i, its loads issued early in
//     the iteration and summed (a fixed butterfly) at its end.
//   * The chunk table, the groups' row lists, B's row pointers and the
//     tile's J row offsets are staged in shared memory first.
// Padding slots carry J = 0 and come out exactly 0.  The output repeats bit
// for bit.
constexpr int LV_STAGES = 4;    // J chunks in shared memory
constexpr int LV_SEG = 24;      // doubles of a stage row's part: shift + 16
constexpr int LV_LDJ = 52;      // stage row stride: two parts, 4 mod 16
constexpr int LV_LDY = 36;      // y row stride: 32 inner, 4 mod 16
constexpr int LV_RT = 4;        // row tiles of 16 of a group at the most
constexpr int LV_REC = 256;     // threads the records are dealt to
constexpr int LV_PRE = 8;       // records a thread keeps in registers
constexpr int LV_UNITS = 18;    // 16-byte units of a stage row: 9 a part
constexpr int LV_MAXKB = 32;    // slots of a tile at the most

// Doubles of a stage slot (the tile's 3 KB rows padded to whole n-tiles)
// and of a y buffer.
__host__ __device__ inline int lv_slot(int KB) {
  return (3 * KB + 7) / 8 * 8 * LV_LDJ;
}
constexpr int LV_YBUF = 16 * LV_RT * LV_LDY;

struct LevelPlan {
  const int* chunk;     // (nch, 8): first row of the group's list, row
                        // tiles, first column (level offset + c0), columns
                        // L, first record, record rows, flush, 0
  const int* rows;      // the groups' rows: w | first << 30; -1 padding
  const int4* rec;      // (pos | set << 30, z index, the factor's low
                        // and high words); pos -1: none, index -1: zero
  const int* b_ptr;     // (W + 1,): B's layer-0 terms by row
  const int* b_u;
  const int* b_src;
  const double* b_fac;
  int nch, nrows, KB, CT;
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int NTW>
__global__ void __launch_bounds__(AG_THREADS, 1)
    dbdd_level_kernel(Args<double> p, LevelPlan lp, double* __restrict__ B,
                      double* __restrict__ dBdD) {
  extern __shared__ __align__(16) double smem_l[];
  const int slot = lv_slot(lp.KB);
  double* stage = smem_l;                               // [S][rows][LDJ]
  double* ybuf = stage + LV_STAGES * slot;              // [2][64][LDY]
  // the tile's J rows: stage row r = direction r / KB, slot k0 + r % KB
  long long* jrow = reinterpret_cast<long long*>(ybuf + 2 * LV_YBUF);
  int* chunk = reinterpret_cast<int*>(jrow + 3 * LV_MAXKB);  // [nch][8]
  int* rows = chunk + 8 * lp.nch;                       // [nrows]
  int* bptr = rows + lp.nrows;                          // [W + 1]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const long long a = blockIdx.x / lp.CT;
  const int KB = lp.KB;
  const int k0 = (blockIdx.x % lp.CT) * KB;
  const int ntl = (3 * KB + 7) / 8;           // n-tiles of the tile
  const double* za_r = p.zr + a * p.nz;
  const double* za_i = p.zi + a * p.nz;

  for (int i = tid; i < (LV_STAGES * slot + 2 * LV_YBUF) / 2;
       i += AG_THREADS)
    reinterpret_cast<double2*>(stage)[i] = make_double2(0.0, 0.0);
  for (int i = tid; i < 8 * lp.nch; i += AG_THREADS) chunk[i] = lp.chunk[i];
  for (int i = tid; i < lp.nrows; i += AG_THREADS) rows[i] = lp.rows[i];
  for (int i = tid; i <= p.W; i += AG_THREADS) bptr[i] = lp.b_ptr[i];
  for (int r = tid; r < 3 * LV_MAXKB; r += AG_THREADS)
    jrow[r] = r < 3 * KB && k0 + r % KB < p.K
                  ? ((static_cast<long long>(r / KB) * p.N + a) * p.K + k0 +
                     r % KB) * 2 * p.U
                  : -1;
  __syncthreads();

  // chunk i of J into its stage slot, every thread a share of the 16-byte
  // units: stage row r = direction r / KB, slot k0 + r % KB (slots past K
  // stay zero); a commit group a call, empty past the last chunk
  auto issue = [&](int i) {
    if (i < lp.nch) {
      const int g = chunk[i * 8 + 2], L = chunk[i * 8 + 3];
      const int gr = g & ~1, gi = (p.U + g) & ~1;
      const int nre = (((g + L + 1) & ~1) - gr) / 2;   // 16-byte units
      const int nim = (((p.U + g + L + 1) & ~1) - gi) / 2;
      double* st = stage + (i % LV_STAGES) * slot;
      // unit e of row r at q = r LV_UNITS + e (a constant divisor)
      for (int q = tid; q < 3 * KB * LV_UNITS; q += AG_THREADS) {
        const int r = q / LV_UNITS, e = q % LV_UNITS;
        const long long jr = jrow[r];
        if (jr < 0 || e >= nre + nim) continue;
        const double* row = p.J + jr;
        if (e < nre)
          cp_async16(st + r * LV_LDJ + 2 * e, row + gr + 2 * e);
        else
          cp_async16(st + r * LV_LDJ + LV_SEG + 2 * (e - nre),
                     row + gi + 2 * (e - nre));
      }
    }
    cp_commit();
  };
  // y of a chunk from this thread's records, in order: the first LV_PRE
  // in registers (`load_recs`, then their z values, `load_z`, each a step
  // ahead of the product), written into buffer i & 1 by `store_y`, which
  // reads and applies any further ones itself
  auto load_recs = [&](int i, int2 (&r)[LV_PRE], double (&f)[LV_PRE]) {
    const int* ck = chunk + i * 8;
    const int4* rec = lp.rec + ck[4] + tid;
#pragma unroll
    for (int k = 0; k < LV_PRE; ++k) {
      const int4 q = k < ck[5] ? rec[k * LV_REC] : make_int4(-1, -1, 0, 0);
      r[k] = make_int2(q.x, q.y);
      f[k] = __hiloint2double(q.w, q.z);
    }
  };
  // (the z values alone: their products wait for them, in store_y)
  auto load_z = [&](const int2 (&r)[LV_PRE], double (&vr)[LV_PRE],
                    double (&vi)[LV_PRE]) {
#pragma unroll
    for (int k = 0; k < LV_PRE; ++k) {
      vr[k] = za_r[max(r[k].y, 0)];
      vi[k] = za_i[max(r[k].y, 0)];
    }
  };
  auto put = [](double* yb, int x, int lp8, double vr, double vi) {
    const int pos = x & 0x3fffffff;
    if (x >> 30) {
      yb[pos] = vr;
      yb[pos + lp8] = vi;
    } else {
      yb[pos] += vr;
      yb[pos + lp8] += vi;
    }
  };
  auto store_y = [&](int i, const int2 (&r)[LV_PRE],
                     const double (&f)[LV_PRE], const double (&vr)[LV_PRE],
                     const double (&vi)[LV_PRE]) {
    const int* ck = chunk + i * 8;
    const int lp8 = (ck[3] + 7) & ~7;
    double* yb = ybuf + (i & 1) * LV_YBUF;
#pragma unroll
    for (int k = 0; k < LV_PRE; ++k)
      if (r[k].x >= 0)
        put(yb, r[k].x, lp8, r[k].y >= 0 ? f[k] * vr[k] : 0.0,
            r[k].y >= 0 ? f[k] * vi[k] : 0.0);
    const int4* rec = lp.rec + ck[4] + tid;
    for (int m = LV_PRE; m < ck[5]; ++m) {
      const int4 q = rec[m * LV_REC];
      const double fq = __hiloint2double(q.w, q.z);
      if (q.x >= 0)
        put(yb, q.x, lp8, q.y >= 0 ? fq * za_r[q.y] : 0.0,
            q.y >= 0 ? fq * za_i[q.y] : 0.0);
    }
  };

  const int nch = lp.nch;
  for (int i = 0; i < LV_STAGES - 1; ++i) issue(i);
  // records of the chunk after next (rA) and of the next (rB), the next
  // chunk's z values (vr, vi)
  int2 rA[LV_PRE], rB[LV_PRE];
  double fA[LV_PRE], fB[LV_PRE], vr[LV_PRE], vi[LV_PRE];
  if (nch > 0) {
    load_recs(0, rA, fA);
    load_z(rA, vr, vi);
  }
  if (nch > 1) load_recs(1, rB, fB);

  // B by the first tile's block, a warp a row: row w + 8 i in chunk
  // iteration i, its first 128 layer-0 terms' indices loaded at the
  // iteration's start, their values after the product, the sum (and any
  // further terms) at its end; rows past the iterations after the loop
  const bool do_b = k0 == 0;
  const double* ua = p.ut + a * 2 * p.U;
  int bu[4], bs[4];
  double bf[4], bvr[4], bvi[4];
  auto b_terms = [&](int w) {
    const int q0 = bptr[w], q1 = bptr[w + 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = max(min(q0 + lane + 32 * k, q1 - 1), 0);
      bu[k] = lp.b_u[q];
      bs[k] = lp.b_src[q];
      bf[k] = q0 + lane + 32 * k < q1 ? lp.b_fac[q] : 0.0;
    }
  };
  double bur[4], bui[4];
  auto b_values = [&]() {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bur[k] = ua[bu[k]];
      bui[k] = ua[p.U + bu[k]];
      bvr[k] = za_r[bs[k]];
      bvi[k] = za_i[bs[k]];
    }
  };
  auto b_finish = [&](int w) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s += bur[k] * (bf[k] * bvr[k]) + bui[k] * (bf[k] * bvi[k]);
    const int q1 = bptr[w + 1];
    for (int q = bptr[w] + 128 + lane; q < q1; q += 32) {
      const int u = lp.b_u[q], src = lp.b_src[q];
      const double f = lp.b_fac[q];
      s += ua[u] * (f * za_r[src]) + ua[p.U + u] * (f * za_i[src]);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) B[a * p.W + w] = s - p.bzero[w];
  };

  if (nch > 0) store_y(0, rA, fA, vr, vi);
  cp_wait<LV_STAGES - 2>();
  __syncthreads();

  double acc[NTW][LV_RT][4];
#pragma unroll
  for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
    for (int rt = 0; rt < LV_RT; ++rt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][rt][e] = 0.0;
  const int K3 = 3 * p.K;
  for (int i = 0; i < nch; ++i) {
    const int* ck = chunk + i * 8;
    const int bw = warp + 8 * i;            // B's row this iteration
    if (do_b && bw < p.W) b_terms(bw);
    const int nrt = ck[1];
    const int nk = (ck[3] + 7) / 8;          // k-steps of a part
    const int sre = ck[2] & 1, sim = (p.U + ck[2]) & 1;
    const double* st = stage + (i % LV_STAGES) * slot;
    const double* yb = ybuf + (i & 1) * LV_YBUF;
    if (i + 1 < nch) load_z(rB, vr, vi);
    if (i + 2 < nch) load_recs(i + 2, rA, fA);
    for (int kk = 0; kk < 2 * nk; ++kk) {
      const int boff = kk < nk ? sre + 8 * kk : LV_SEG + sim + 8 * (kk - nk);
      double b[NTW][2];
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn) {
        const double* bp =
            st + ((warp + 8 * jn) * 8 + g8) * LV_LDJ + boff + t4;
        const bool on = warp + 8 * jn < ntl;
        b[jn][0] = on ? bp[0] : 0.0;
        b[jn][1] = on ? bp[4] : 0.0;
      }
#pragma unroll
      for (int rt = 0; rt < LV_RT; ++rt) {
        if (rt >= nrt) break;
        const double* ap = yb + (16 * rt + g8) * LV_LDY + 8 * kk + t4;
        const double av[4] = {ap[0], ap[8 * LV_LDY], ap[4],
                              ap[8 * LV_LDY + 4]};
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
          if (warp + 8 * jn < ntl) mma_f64(acc[jn][rt], av, b[jn]);
      }
    }
    if (do_b && bw < p.W) b_values();
    if (ck[6]) {
      // the group's level is done: its sums into dB/dD, in level order;
      // the earlier levels' sums are all read before any is written, so
      // that the reads are in flight together
      const int* rl = rows + ck[0];
      double* ob = dBdD + a * p.W * K3;       // the atom's rows
      int off[LV_RT][2][NTW][2];              // -1: no output
      double old[LV_RT][2][NTW][2];
#pragma unroll
      for (int rt = 0; rt < LV_RT; ++rt)
#pragma unroll
        for (int sh = 0; sh < 2; ++sh) {
          const int e = rt < nrt ? rl[16 * rt + g8 + 8 * sh] : -1;
#pragma unroll
          for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // tile column r: direction r / KB, slot k0 + r % KB
              const int r = (warp + 8 * jn) * 8 + 2 * t4 + h;
              const int k = k0 + r % KB;
              const int o = e < 0 || r >= 3 * KB || k >= p.K
                                ? -1
                                : (e & 0x3fffffff) * K3 + 3 * k + r / KB;
              off[rt][sh][jn][h] = o;
              old[rt][sh][jn][h] =
                  o >= 0 && !(e >> 30) ? __ldcg(ob + o) : 0.0;
            }
        }
#pragma unroll
      for (int rt = 0; rt < LV_RT; ++rt)
#pragma unroll
        for (int sh = 0; sh < 2; ++sh)
#pragma unroll
          for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (off[rt][sh][jn][h] >= 0)
                ob[off[rt][sh][jn][h]] =
                    old[rt][sh][jn][h] + acc[jn][rt][2 * sh + h];
#pragma unroll
      for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
        for (int rt = 0; rt < LV_RT; ++rt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][rt][e] = 0.0;
    }
    if (i + 1 < nch) store_y(i + 1, rB, fB, vr, vi);
#pragma unroll
    for (int k = 0; k < LV_PRE; ++k) {
      rB[k] = rA[k];
      fB[k] = fA[k];
    }
    issue(i + LV_STAGES - 1);               // into chunk i - 1's slot
    if (do_b && bw < p.W) b_finish(bw);
    cp_wait<LV_STAGES - 2>();               // chunk i + 1 has landed
    __syncthreads();
  }
  if (do_b)
    for (int w = warp + 8 * nch; w < p.W; w += AG_THREADS / 32) {
      b_terms(w);
      b_values();
      b_finish(w);
    }
}

// Shared memory of a level-shape block of KB slots
// (`snap_kernels.dbdd_level_smem`).
size_t dbdd_level_smem(int KB, int nch, int nrows, int W) {
  return sizeof(double) *
             (static_cast<size_t>(LV_STAGES) * lv_slot(KB) + 2 * LV_YBUF +
              3 * LV_MAXKB) +
         sizeof(int) * (8 * static_cast<size_t>(nch) + nrows + W + 1);
}

template <int NTW>
int launch_level(const Args<double>& p, const LevelPlan& lp, size_t smem,
                 double* B, double* dBdD, cudaStream_t stream) {
  const int err = fs_allow_smem(dbdd_level_kernel<NTW>, smem);
  if (err) return err;
  if (p.N > 0)
    dbdd_level_kernel<NTW><<<static_cast<unsigned>(p.N * lp.CT), AG_THREADS,
                             smem, stream>>>(p, lp, B, dBdD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ut (N, nc * 2U), zr, zi (N, nc * nc, nz), J (3, N, K, 2U) f64; jelem
// (N, K) i32, read only when nc > 1; compact y targets tg_ptr (ntrip + 1),
// tg_u (nT,), tg_src (nT, 3) i32, tg_fac (nT, 3) f64; y_src (3, ntrip, U)
// i32 and y_fac (3, ntrip, U) f64 (layer 0 forms B); blk_chan, blk_pair
// (nc^3, 3) i32; bzero (W,) f64 (zeros when bzeroflag is 0), W = nc^3 *
// ntrip.  W split evenly over ntiles blocks per atom of at most MT rows
// (16 or 32); slab 0 holds whole y rows, else y is built slab columns at a
// time (a multiple of 48) from tg_slab (ntrip, ceil(2U / slab), 4) i32,
// each slab's target ranges (`snap_kernels.dbdd_slab_ranges`).  Writes B (N, W) and dBdD (N, W, K, 3).
extern "C" int dbdd(const double* ut, const double* zr, const double* zi,
                    const double* J, const int* jelem, const int* tg_ptr,
                    const int* tg_u, const int* tg_src, const double* tg_fac,
                    const int* tg_slab, const int* y_src, const double* y_fac,
                    const int* blk_chan, const int* blk_pair,
                    const double* bzero, long long natoms, int K, int ntrip,
                    int U, int nz, int nc, int MT, int ntiles, int slab,
                    double* B, double* dBdD, void* stream) {
  const int W = nc * nc * nc * ntrip;
  const Args<double> p{ut, zr, zi, J, jelem, tg_ptr, tg_u, tg_src, tg_fac,
                       reinterpret_cast<const int4*>(tg_slab), y_src, y_fac,
                       blk_chan, blk_pair, bzero, W, ntrip, U, nz, nc, K,
                       MT, ntiles, natoms};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab != 0) {
    if (slab < 0 || slab % (8 * AG_DEPTH * 2) != 0 || !tg_slab)
      return static_cast<int>(cudaErrorInvalidValue);
    const int ldl = ag_ldl(slab);
    const size_t smem = sizeof(double) * (MT * ldl + AG_STAGE) +
                        sizeof(int) * (2 * static_cast<size_t>(K) + 2) +
                        MT / 16 * (ldl / 8);
    if (smem > FS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    if (MT == 16) return launch_slab<1>(p, slab, smem, B, dBdD, s);
    if (MT == 32) return launch_slab<2>(p, slab, smem, B, dBdD, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rows(p, MT, B, dBdD, s);
}

// The float32 instantiation of the whole-row shape: `dbdd`'s arguments
// with ut, zr, zi, J, tg_fac, y_fac, bzero, B and dBdD f32 (a float32
// plan's tables), and no slab.
extern "C" int dbdd_f32(const float* ut, const float* zr, const float* zi,
                        const float* J, const int* jelem, const int* tg_ptr,
                        const int* tg_u, const int* tg_src,
                        const float* tg_fac, const int* tg_slab,
                        const int* y_src, const float* y_fac,
                        const int* blk_chan, const int* blk_pair,
                        const float* bzero, long long natoms, int K,
                        int ntrip, int U, int nz, int nc, int MT, int ntiles,
                        int slab, float* B, float* dBdD, void* stream) {
  if (slab != 0 || tg_slab) return static_cast<int>(cudaErrorInvalidValue);
  const int W = nc * nc * nc * ntrip;
  const Args<float> p{ut, zr, zi, J, jelem, tg_ptr, tg_u, tg_src, tg_fac,
                      nullptr, y_src, y_fac, blk_chan, blk_pair, bzero, W,
                      ntrip, U, nz, nc, K, MT, ntiles, natoms};
  return launch_rows(p, MT, B, dBdD, static_cast<cudaStream_t>(stream));
}

// K3's level shape (one channel): ut (N, 2U), zr, zi (N, nz), J (3, N, K,
// 2U) f64; the level plan of `snap_kernels.dbdd_levels` (chunk (nch, 8),
// rows (nrows,), rec (n, 4) i32 (a record's factor in its last two words),
// B's layer-0 terms b_ptr (W + 1), b_u, b_src i32, b_fac f64); bzero (W,)
// f64; KB neighbor slots a block (at most 32) in CT slot tiles, KB (CT -
// 1) < K <= KB CT.  Writes B (N, W) and dBdD (N, W, K, 3).
extern "C" int dbdd_level(const double* ut, const double* zr,
                          const double* zi, const double* J,
                          const int* chunk, const int* rows, const int* rec,
                          const int* b_ptr,
                          const int* b_u, const int* b_src,
                          const double* b_fac, const double* bzero,
                          long long natoms, int K, int W, int U, int nz,
                          int nch, int nrows, int KB, int CT, double* B,
                          double* dBdD, void* stream) {
  Args<double> p{};
  p.ut = ut;
  p.zr = zr;
  p.zi = zi;
  p.J = J;
  p.bzero = bzero;
  p.W = W;
  p.U = U;
  p.nz = nz;
  p.nc = 1;
  p.K = K;
  p.N = natoms;
  const LevelPlan lp{chunk, rows, reinterpret_cast<const int4*>(rec), b_ptr,
                     b_u, b_src, b_fac, nch, nrows, KB, CT};
  const size_t smem = dbdd_level_smem(KB, nch, nrows, W);
  if (KB < 1 || KB > LV_MAXKB || CT < 1 || KB * (CT - 1) >= K ||
      KB * CT < K || smem > FS_SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (3 * KB <= 64) return launch_level<1>(p, lp, smem, B, dBdD, s);
  return launch_level<2>(p, lp, smem, B, dBdD, s);
}
