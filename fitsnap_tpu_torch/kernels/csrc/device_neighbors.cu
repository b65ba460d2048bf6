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
// Bound on the H100: K8 must write 29 B per slot and read the positions
// once; a binned search evaluates a few hundred distances an atom (the
// atoms of the bins around it, in each image that reaches it), so at the Ta
// shapes (S = 27, A = 128, K = 64) it is bound by its bytes.  K8r needs
// O(A K) integer work per config against 9 B per slot of lists and table,
// and is bound by the bytes: 0.6 MB at 8 x 128 x 64, well under a
// microsecond, so its real floor is one launch's fixed latency.
//
// Design.  K8 bins each config's home atoms (not its S * A candidates), so
// nothing it keeps grows with S, and it has no cap on S * A (the flat index
// f must fit an int).  The grid: cubic bins of side s = cutoff (1 + 2^-20)
// (kernels/snap_kernels.py `K8_BIN_SIDE`, passed in) from the home atoms'
// low corner lo, n_d = floor((hi - lo) / s) + 1 bins an axis over their
// bounding box [lo, hi].  The bin of x is floor((x - lo) * (1 / s)), each
// step rounded as written (__dsub_rn, __dmul_rn), a monotone formula, so
// every home atom lies on the grid.  The grid has at most H bins
// (`k8_bins`, from A alone): where s would need more (a sparse config), s
// grows to ext / (m - 1.5), ext the box's largest edge and m the integer
// cube root of H, which needs at most (m - 1)^3; so no per-config
// parameter is read back by the host.  A counting sort (integer counts,
// one atomic per bin a warp, an exclusive scan) gives each bin its range
// of the sorted atoms (32 B each: pos_hi and j); the order within a bin
// follows the atomics, and nothing downstream depends on it.
//
// An atom i searches, for each image shift s, the bins within one of the
// query point q = pos_i - svec_s, clipped to the grid: a candidate pos_j +
// svec_s within the cutoff of pos_i (d2 < cutoff^2 as computed) has pos_j
// within cutoff (1 + 4 eps) of q along each axis, up to the rounding of q
// and of the candidate (1e-12 A at coordinates below 1e4 A, against the
// side's margin of 4e-6 A), so its bin is within one of q's; a shift whose
// clipped range is empty holds no neighbor of i (the host test
// `test_k8_bins_cover_every_neighbor` checks the cover on its cases).  A
// warp's lanes take the shifts, 32 at a time; the rows of up to 3 x 3 bins
// of the relevant shifts become items, one a lane (each a contiguous range
// of the sorted atoms, found by a shuffle search of the rows' prefix sums),
// and the items' atoms become candidates, four a lane a step.  A step runs
// each stage for its four candidates before the next (the item search, the
// loads, then d2), since a warp issues in order and the stages of one
// candidate depend on each other; no branch, so a lane past the list reads
// a valid atom and is not counted.  d2 = ((pos_j + svec_s - pos_i)^2 per
// component, summed x, y, z left to right), each step rounded with
// __dadd_rn / __dsub_rn / __dmul_rn as the plain version rounds it, so no
// FMA contraction changes d2 and near ties order as there.  The valid
// (d2, f) pairs, f = s A + j, go to a per-warp buffer (K8_BUF = 256 pairs
// in shared memory), a step's at once; a pair's slot is its rank in (d2, f)
// order, counted against the buffer, so the slots do not depend on the
// order in which the bins or lanes filled it, and the output repeats bit
// for bit.  When the buffer would overflow (more valid pairs than it
// holds: truncation), it is pruned to its K smallest pairs, and from then
// on only pairs below the K-th smallest are kept, which keeps the K nearest
// exactly for any number of valid pairs (the buffer must hold K plus one
// ballot's 32 pairs).  With m valid pairs and m < K, slots m..K-1 take the
// first K - m invalid candidates by f; at most m candidates below K + m
// are valid, and the buffer, never pruned then, holds them all: a bitmap of
// their f below K + m marks them, and the rest fill the slots in order.  A
// padded atom (i >= natoms) searches nothing and writes its K invalid slots
// (f = k, so jidx = k % A).  K above K8_BUF / 2 keeps each atom's buffer of
// 2 K + 128 pairs and its bitmap in global scratch instead, so that pruning
// stays rare.
//
// Launch shapes.  Fused (A <= 1,024 and S <= 512, `K8_FUSED_ATOMS`,
// `K8_FUSED_SHIFTS`: a config's sorted atoms and shifts fit one block's
// shared memory): one launch; block (config, 8 atoms, or 16 above 256 atom
// slots) sorts its config's home atoms and stages its shifts in shared
// memory, then each warp searches one atom there.  Every block of a config
// sorts the same atoms: at most 1,024, a few rounds of its threads.  Split
// (larger configs): a bin pass, one block of 1,024 threads per config, into
// global scratch, then the select pass, one warp an atom, 16 a block.  The
// fused shape is the faster where both run (on the H100 about 1.4-1.6x at
// 8 x 128 and 2 x 1,024 atom slots: the select pass reads the sorted atoms
// from L2, not shared memory, and the bin pass is a launch of its own;
// chip_smoke.py times both, PERF.md has the numbers).  Only integer atomics (the bin counts and the bitmap), whose order the output
// does not depend on; no floating-point atomics.
//
// What holds K8 back on the H100 is one warp's chain of dependent steps,
// not bytes or operations: a block's sort (bounding box, grid, counts,
// scan, places, each behind a barrier) before any search starts, then the
// shuffle searches and prefix sums that map lanes to items and candidates,
// then the ranking (PERF.md has the times).
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
//
// Working types.  K8 has a float64 and a float32 instantiation (entry
// points `device_neighbors` and `device_neighbors_f32`); K8r reads integers
// only and has one.  At float32 the positions and shifts are the hi/lo
// float32 pairs that `pack_batch_pos` splits from float64 on the host: the
// candidates are selected on the hi parts alone (d2 in float32, each step
// rounded on its own, as the plain version and the JAX function compute
// it), and a kept slot's displacement is rebuilt from the hi and lo parts
// by the same TwoSum chain in float32, so that it lands within an ulp or two
// of the float64 displacement.  The grid, the sorted atoms (16 B each: x,
// y, z and j's bits), the pair buffers and the bounding-box reductions
// follow the positions' type.  A float32 grid's side has a wider margin over
// the cutoff (`K8_BIN_SIDE_F32`, 2^-10 of it: 5e-3 A at a 5 A cutoff), since
// float32 rounds the query points and the bin coordinates at about 2e-6 A
// at 50 A coordinates, above the float64 side's margin.
#include "common.cuh"

#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int BIN_THREADS = 1024;            // the split shape's bin pass
constexpr int SEL_MAX_WARPS = 16;            // atoms a block of the select
constexpr int SEL_STEP = 4;                  // candidates a lane tests a step
constexpr int BIN_ROUNDS = 4;                // atoms a thread, fused shape

template <typename T>
__device__ __forceinline__ T fs_inf() {
  return static_cast<T>(CUDART_INF);
}

// A config's bin grid over its home atoms: origin (the box's low corner),
// 1 / side, bins an axis (0: no real atom).
template <typename T>
struct Grid {
  T o[3];
  T inv;
  int n[3];
  int pad;
};
static_assert(sizeof(Grid<double>) <= 48 && sizeof(Grid<float>) <= 48,
              "kernels/snap_kernels.py allocates 48 B a config");

// A sorted atom: x, y, z of pos_hi and j's bits, as two double2 (float64)
// or one float4 (float32).
template <typename T>
struct AtomRec;

template <>
struct AtomRec<double> {
  using V = double2;
  static constexpr int kPer = 2;             // V a record
  __device__ static void put(V* s, int o, double x, double y, double z,
                             int j) {
    s[2 * o] = make_double2(x, y);
    s[2 * o + 1] =
        make_double2(z, __longlong_as_double(static_cast<long long>(j)));
  }
  __device__ static void get(const V* s, int o, double& x, double& y,
                             double& z, int& j) {
    const double2 a = s[2 * o], b = s[2 * o + 1];
    x = a.x;
    y = a.y;
    z = b.x;
    j = static_cast<int>(__double_as_longlong(b.y));
  }
};

template <>
struct AtomRec<float> {
  using V = float4;
  static constexpr int kPer = 1;
  __device__ static void put(V* s, int o, float x, float y, float z, int j) {
    s[o] = make_float4(x, y, z, __int_as_float(j));
  }
  __device__ static void get(const V* s, int o, float& x, float& y,
                             float& z, int& j) {
    const float4 a = s[o];
    x = a.x;
    y = a.y;
    z = a.z;
    j = __float_as_int(a.w);
  }
};

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = fs_add_rn(a, b);
  const T bb = fs_sub_rn(s, a);
  e = fs_add_rn(fs_sub_rn(a, fs_sub_rn(s, bb)), fs_sub_rn(b, bb));
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The grid of side s (inverse inv) over the box [lo, hi]; returns its
// number of bins.
template <typename T>
__device__ double grid_of(const T* lo, const T* hi, T s, T inv, Grid<T>& g) {
  g.inv = inv;
  double prod = 1.0;
  for (int d = 0; d < 3; ++d) {
    g.o[d] = lo[d];
    const T n = floor(fs_mul_rn(fs_sub_rn(hi[d], lo[d]), inv)) + T(1);
    g.n[d] = static_cast<int>(fmin(static_cast<double>(n), 1e9));
    prod *= static_cast<double>(n);
  }
  return prod;
}

// The bin coordinate of x along axis d, as a T (floor of t).
template <typename T>
__device__ __forceinline__ T bin_coord(const Grid<T>& g, int d, T x) {
  return floor(fs_mul_rn(fs_sub_rn(x, g.o[d]), g.inv));
}

// The flat bin of a home atom, or -1 for a position that is not a number.
template <typename T>
__device__ __forceinline__ int atom_bin(const Grid<T>& g, T x, T y, T z) {
  const T bx = bin_coord(g, 0, x), by = bin_coord(g, 1, y),
          bz = bin_coord(g, 2, z);
  if (!(bx >= T(0) && bx < g.n[0] && by >= T(0) && by < g.n[1] &&
        bz >= T(0) && bz < g.n[2])) {
    return -1;
  }
  return (static_cast<int>(bz) * g.n[1] + static_cast<int>(by)) * g.n[0] +
         static_cast<int>(bx);
}

// The bins [lo, lo + n) along axis d within one of query coordinate x, on
// the grid; n <= 0 when none is.
template <typename T>
__device__ __forceinline__ void near_bins(const Grid<T>& g, int d, T x,
                                          int& lo, int& n) {
  const T b = bin_coord(g, d, x);
  const T l = fmax(b - T(1), T(0));
  const T h = fmin(b + T(1), static_cast<T>(g.n[d] - 1));
  lo = static_cast<int>(l);
  n = l <= h ? static_cast<int>(h) - lo + 1 : 0;
}

// Bin config c's home atoms, block-wide: the grid (into g), the bins'
// ranges bins[0..nb] (bins[b] the first of bin b, of nb <= H) and the
// atoms sorted by bin (`AtomRec`).  `bins`, `red` (6 x 32) and `wsum` (33)
// are shared memory, and `cursor` (H ints, kRegs false); `sorted` shared or
// global.  With kRegs the block's atoms (at most BIN_ROUNDS a thread) keep
// their bins and places in registers from the count to the placement; else
// a second sweep places them through `cursor`.  The lo parts of the
// positions are prefetched into L1 for the slots' displacements.
template <typename T, bool kRegs>
__device__ void bin_atoms(const T* __restrict__ ph, const T* __restrict__ pl,
                          int na, int A, int H, T side, T inv_side,
                          Grid<T>& g, int* bins, int* cursor, T* red,
                          int* wsum, typename AtomRec<T>::V* sorted) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const T inf = fs_inf<T>();
  // the home atoms' bounding box (the loads of every slot are issued with
  // that of natoms; padded slots are masked after)
  T b[6] = {inf, inf, inf, -inf, -inf, -inf};
  for (int j = tid; j < A; j += blockDim.x) {
    T x[3];
    for (int d = 0; d < 3; ++d) x[d] = ph[j * 3 + d];
    asm volatile("prefetch.global.L1 [%0];" ::"l"(pl + j * 3));
    if (j < na) {
      for (int d = 0; d < 3; ++d) {
        b[d] = fmin(b[d], x[d]);
        b[3 + d] = fmax(b[3 + d], x[d]);
      }
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    for (int d = 0; d < 3; ++d) {
      b[d] = fmin(b[d], __shfl_xor_sync(0xffffffffu, b[d], off));
      b[3 + d] = fmax(b[3 + d], __shfl_xor_sync(0xffffffffu, b[3 + d], off));
    }
  }
  if (lane == 0)
    for (int d = 0; d < 6; ++d) red[d * 32 + warp] = b[d];
  for (int h = tid; h <= H; h += blockDim.x) bins[h] = 0;
  __syncthreads();
  if (warp == 0) {
    for (int d = 0; d < 6; ++d)
      b[d] = lane < nw ? red[d * 32 + lane] : (d < 3 ? inf : -inf);
    for (int off = 16; off > 0; off /= 2) {
      for (int d = 0; d < 3; ++d) {
        b[d] = fmin(b[d], __shfl_xor_sync(0xffffffffu, b[d], off));
        b[3 + d] = fmax(b[3 + d],
                        __shfl_xor_sync(0xffffffffu, b[3 + d], off));
      }
    }
    if (lane == 0) {
      Grid<T> gg;
      if (na > 0) {
        if (grid_of(b, b + 3, side, inv_side, gg) > static_cast<double>(H)) {
          // a sparse config: the side that fits the grid in H bins
          int m = 4;
          while ((m + 1) * (m + 1) * (m + 1) <= H) ++m;
          T ext = T(0);
          for (int d = 0; d < 3; ++d)
            ext = fmax(ext, fs_sub_rn(b[3 + d], b[d]));
          const T s = fmax(side, fs_div_rn(ext, static_cast<T>(m) - T(1.5)));
          grid_of(b, b + 3, s, fs_div_rn(T(1), s), gg);
        }
      } else {
        gg.o[0] = gg.o[1] = gg.o[2] = T(0);
        gg.inv = T(0);
        gg.n[0] = gg.n[1] = gg.n[2] = 0;
      }
      gg.pad = 0;
      g = gg;
    }
  }
  __syncthreads();

  // count each bin's atoms (bins[b + 1]), one atomic per bin a warp; its
  // old value is the warp's place within the bin
  int rbin[BIN_ROUNDS], rat[BIN_ROUNDS];
  T rx[BIN_ROUNDS], ry[BIN_ROUNDS], rz[BIN_ROUNDS];
#pragma unroll
  for (int r = 0; r < BIN_ROUNDS; ++r) rbin[r] = -1;
  for (int j0 = warp * 32, r = 0; j0 < na; j0 += blockDim.x, ++r) {
    const int j = j0 + lane;
    T x = T(0), y = T(0), z = T(0);
    int bin = -1;
    if (j < na) {
      x = ph[j * 3];
      y = ph[j * 3 + 1];
      z = ph[j * 3 + 2];
      bin = atom_bin(g, x, y, z);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (bin >= 0 && lane == leader) base = atomicAdd(&bins[bin + 1],
                                                     __popc(peers));
    if (kRegs) {
      base = __shfl_sync(0xffffffffu, base, leader);
#pragma unroll
      for (int q = 0; q < BIN_ROUNDS; ++q) {
        if (q == r) {
          rbin[q] = bin;
          rat[q] = base + __popc(peers & lanes_below(lane));
          rx[q] = x;
          ry[q] = y;
          rz[q] = z;
        }
      }
    }
  }
  __syncthreads();

  // inclusive scan of the counts in place: bins[k] becomes the first of
  // bin k (nb <= H, the grid's bins; the ranges past them are empty); one
  // warp up to 1,024 bins, else the block
  const int nb = g.n[0] * g.n[1] * g.n[2];
  if (nb <= 32 * 32) {
    if (warp == 0) {
      const int per = (nb + 31) / 32;
      const int h0 = min(nb, lane * per), h1 = min(nb, h0 + per);
      int mine = 0;
      for (int h = h0; h < h1; ++h) mine += bins[h + 1];
      int incl = mine;
      for (int off = 1; off < 32; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      int at = incl - mine;
      for (int h = h0; h < h1; ++h) {
        at += bins[h + 1];
        bins[h + 1] = at;
      }
    }
  } else {
    const int per = (nb + blockDim.x - 1) / blockDim.x;
    const int h0 = min(nb, tid * per), h1 = min(nb, h0 + per);
    int mine = 0;
    for (int h = h0; h < h1; ++h) mine += bins[h + 1];
    int incl = mine;
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nw ? wsum[lane] : 0;
      int w = v;
      for (int off = 1; off < 32; off *= 2) {
        const int u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      if (lane < nw) wsum[lane] = w - v;
    }
    __syncthreads();
    int at = wsum[warp] + incl - mine;
    for (int h = h0; h < h1; ++h) {
      at += bins[h + 1];
      bins[h + 1] = at;
    }
  }
  __syncthreads();

  // place each atom
  if (kRegs) {
#pragma unroll
    for (int r = 0; r < BIN_ROUNDS; ++r) {
      if (rbin[r] >= 0) {
        const int o = bins[rbin[r]] + rat[r];
        const int j = r * blockDim.x + warp * 32 + lane;
        AtomRec<T>::put(sorted, o, rx[r], ry[r], rz[r], j);
      }
    }
  } else {
    for (int h = tid; h < nb; h += blockDim.x) cursor[h] = bins[h];
    __syncthreads();
    for (int j0 = warp * 32; j0 < na; j0 += blockDim.x) {
      const int j = j0 + lane;
      int bin = -1;
      T x = T(0), y = T(0), z = T(0);
      if (j < na) {
        x = ph[j * 3];
        y = ph[j * 3 + 1];
        z = ph[j * 3 + 2];
        bin = atom_bin(g, x, y, z);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (bin >= 0 && lane == leader) base = atomicAdd(&cursor[bin],
                                                       __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (bin >= 0) {
        const int o = base + __popc(peers & lanes_below(lane));
        AtomRec<T>::put(sorted, o, x, y, z, j);
      }
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ bool key_less(T da, int fa, T db, int fb) {
  return da < db || (da == db && fa < fb);
}

// The rank of each of the buffer's n pairs in (d2, f) order, for lane's
// pairs u = lane, lane + 32, ...; calls out(rank, d2, f).
template <typename T, typename Out>
__device__ __forceinline__ void rank_pairs(const T* bd, const int* bf, int n,
                                           int lane, Out out) {
  for (int u = lane; u < n; u += 32) {
    const T du = bd[u];
    const int fu = bf[u];
    int rank = 0;
#pragma unroll 4
    for (int v = 0; v < n; ++v) rank += key_less(bd[v], bf[v], du, fu);
    out(rank, du, fu);
  }
}

// The state of a warp's buffer: its pairs, and the bound (tau_d, tau_f)
// below which a pair is kept (no bound until the first pruning).
template <typename T>
struct Kept {
  int n;
  T tau_d;
  int tau_f;
};

// Prune the buffer to its K smallest pairs, in place; tau becomes the K-th
// smallest, the largest pair kept.  Out of line (it runs only when the
// buffer overflows), and by value, so that the caller's state stays in
// registers.
template <typename T>
__device__ __noinline__ Kept<T> prune(T* bd, int* bf, int n, int K,
                                      int lane) {
  __syncwarp();
  T td = fs_inf<T>();
  int tf = 0x7fffffff;
  bool found = false;
  rank_pairs(bd, bf, n, lane, [&](int rank, T d, int f) {
    if (rank == K - 1) {
      td = d;
      tf = f;
      found = true;
    }
  });
  __syncwarp();
  const int src = __ffs(__ballot_sync(0xffffffffu, found)) - 1;
  const T tau_d = __shfl_sync(0xffffffffu, td, src);
  const int tau_f = __shfl_sync(0xffffffffu, tf, src);
  // stable compaction: a pair moves to a place at or below its own, and
  // every lane reads its pair before any lane writes
  int w = 0;
  for (int base = 0; base < n; base += 32) {
    const int u = base + lane;
    T d = T(0);
    int f = 0;
    if (u < n) {
      d = bd[u];
      f = bf[u];
    }
    const bool keep = u < n && !key_less(tau_d, tau_f, d, f);
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    __syncwarp();
    if (keep) {
      const int o = w + __popc(bal & lanes_below(lane));
      bd[o] = d;
      bf[o] = f;
    }
    w += __popc(bal);
    __syncwarp();
  }
  return {w, tau_d, tau_f};
}

// The last lane L whose (non-decreasing across lanes) value v_L <= x, for
// x >= v_0: a binary search with shuffles, each lane its own x.
__device__ __forceinline__ int last_lane_le(int v, int x) {
  int L = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(0xffffffffu, v, L + step) <= x) L += step;
  }
  return L;
}

// One warp's atom i of config c: its K slots (out0 = its first), from the
// config's grid, bin ranges and sorted atoms, through a buffer of BUF
// (d2, f) pairs (bd, bf) and a bitmap of the valid indices below K + m
// (bits, (2 K + 31) / 32 words).
template <typename T>
__device__ void select_atom(const T* __restrict__ ph,
                            const T* __restrict__ pl,
                            const T* __restrict__ sh,
                            const T* __restrict__ sl,
                            const T* svs, const unsigned char* homes,
                            int na, int i,
                            int A, int S, int K, T cut2, const Grid<T>& g,
                            const int* start,
                            const typename AtomRec<T>::V* sorted,
                            T* bd, int* bf, int BUF, unsigned* bits,
                            long long out0, T* __restrict__ disp,
                            int* __restrict__ jidx,
                            unsigned char* __restrict__ mask) {
  const int lane = threadIdx.x & 31;
  int m = 0;                                 // valid candidates
  int n = 0;                                 // pairs in the buffer
  if (i < na) {
    const T xi = ph[i * 3], yi = ph[i * 3 + 1], zi = ph[i * 3 + 2];
    const int nx = g.n[0], ny = g.n[1];
    T tau_d = fs_inf<T>();                   // keep pairs below (tau_d, tau_f)
    int tau_f = 0x7fffffff;
    for (int s0 = 0; s0 < S; s0 += 32) {
      // lane's shift s: the bins within one of the query point xi - svec_s
      // (a candidate pos_j + svec_s near xi has pos_j near it), yn zn rows
      // of xn bins, each row a contiguous range of the sorted atoms
      const int s = s0 + lane;
      int x0 = 0, xn = 0, y0 = 0, yn = 0, z0 = 0, zn = 0, home = 0;
      if (s < S) {
        const T vx = svs[s * 3], vy = svs[s * 3 + 1], vz = svs[s * 3 + 2];
        near_bins(g, 0, fs_sub_rn(xi, vx), x0, xn);
        near_bins(g, 1, fs_sub_rn(yi, vy), y0, yn);
        near_bins(g, 2, fs_sub_rn(zi, vz), z0, zn);
        home = homes ? homes[s]
                     : vx == T(0) && vy == T(0) && vz == T(0) &&
                           sl[s * 3] == T(0) && sl[s * 3 + 1] == T(0) &&
                           sl[s * 3 + 2] == T(0);
      }
      const int rows = xn > 0 && yn > 0 && zn > 0 ? yn * zn : 0;
      int rincl = rows;
      for (int off = 1; off < 32; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, rincl, off);
        if (lane >= off) rincl += v;
      }
      const int rbase = rincl - rows;
      const int nitems = __shfl_sync(0xffffffffu, rincl, 31);
      for (int g0 = 0; g0 < nitems; g0 += 32) {
        // lane's item: row r of shift lane L
        const int u = g0 + lane;
        const int L = last_lane_le(rbase, u);
        const int r = u - __shfl_sync(0xffffffffu, rbase, L);
        const int ix0 = __shfl_sync(0xffffffffu, x0, L);
        const int ixn = __shfl_sync(0xffffffffu, xn, L);
        const int iy0 = __shfl_sync(0xffffffffu, y0, L);
        const int iyn = __shfl_sync(0xffffffffu, yn, L);
        const int iz0 = __shfl_sync(0xffffffffu, z0, L);
        const int ihome = __shfl_sync(0xffffffffu, home, L);
        // the item's shift and home flag (shift 0 past the items, so that
        // the branch-free candidate loads below stay in bounds)
        const int itag = u < nitems ? (s0 + L) * 2 + ihome : 0;
        int ilo = 0, ilen = 0;
        if (u < nitems) {
          const int b0 = ((iz0 + r / iyn) * ny + iy0 + r % iyn) * nx + ix0;
          ilo = start[b0];
          ilen = start[b0 + ixn] - ilo;
        }
        int cincl = ilen;
        for (int off = 1; off < 32; off *= 2) {
          const int v = __shfl_up_sync(0xffffffffu, cincl, off);
          if (lane >= off) cincl += v;
        }
        const int cbase = cincl - ilen;
        const int cshift = ilo - cbase;      // sorted index - candidate index
        const int ncand = __shfl_sync(0xffffffffu, cincl, 31);
        for (int c0 = 0; c0 < ncand; c0 += 32 * SEL_STEP) {
          // every candidate of the step first, without branches (a lane
          // past the list reads a valid atom and is not ok), so that the
          // steps' loads and d2 overlap; then the appends
          // each stage for every q before the next (a warp issues in order,
          // so the independent shuffles and loads of the q's overlap)
          int I[SEL_STEP], at[SEL_STEP], tag[SEL_STEP];
#pragma unroll
          for (int q = 0; q < SEL_STEP; ++q) I[q] = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
#pragma unroll
            for (int q = 0; q < SEL_STEP; ++q) {
              const int e = c0 + q * 32 + lane;
              if (__shfl_sync(0xffffffffu, cbase, I[q] + step) <= e)
                I[q] += step;
            }
          }
#pragma unroll
          for (int q = 0; q < SEL_STEP; ++q) {
            at[q] = min(__shfl_sync(0xffffffffu, cshift, I[q]) + c0 + q * 32 +
                            lane,
                        na - 1);
            tag[q] = __shfl_sync(0xffffffffu, itag, I[q]);
          }
          T ax[SEL_STEP], ay[SEL_STEP], az[SEL_STEP];
          int aj[SEL_STEP];
          T vx[SEL_STEP], vy[SEL_STEP], vz[SEL_STEP];
#pragma unroll
          for (int q = 0; q < SEL_STEP; ++q) {
            AtomRec<T>::get(sorted, at[q], ax[q], ay[q], az[q], aj[q]);
            const int sq = tag[q] >> 1;
            vx[q] = svs[sq * 3];
            vy[q] = svs[sq * 3 + 1];
            vz[q] = svs[sq * 3 + 2];
          }
          T d2[SEL_STEP];
          int f[SEL_STEP];
          bool ok[SEL_STEP];
#pragma unroll
          for (int q = 0; q < SEL_STEP; ++q) {
            // d2 of pos_j + svec_s - pos_i, rounded as the plain version
            const T dx = fs_sub_rn(fs_add_rn(ax[q], vx[q]), xi);
            const T dy = fs_sub_rn(fs_add_rn(ay[q], vy[q]), yi);
            const T dz = fs_sub_rn(fs_add_rn(az[q], vz[q]), zi);
            d2[q] = fs_add_rn(fs_add_rn(fs_mul_rn(dx, dx), fs_mul_rn(dy, dy)),
                              fs_mul_rn(dz, dz));
            const int j = aj[q];
            f[q] = (tag[q] >> 1) * A + j;
            ok[q] = c0 + q * 32 + lane < ncand && d2[q] < cut2 &&
                    !((tag[q] & 1) && j == i);
            m += ok[q];
          }
          // the step's appends at once where the buffer holds them all,
          // else one ballot at a time with pruning
          unsigned kb[SEL_STEP];
          int total = 0;
#pragma unroll
          for (int q = 0; q < SEL_STEP; ++q) {
            kb[q] = __ballot_sync(
                0xffffffffu, ok[q] && key_less(d2[q], f[q], tau_d, tau_f));
            total += __popc(kb[q]);
          }
          if (n + total <= BUF) {
#pragma unroll
            for (int q = 0; q < SEL_STEP; ++q) {
              if ((kb[q] >> lane) & 1u) {
                const int o = n + __popc(kb[q] & lanes_below(lane));
                bd[o] = d2[q];
                bf[o] = f[q];
              }
              n += __popc(kb[q]);
            }
          } else {
            for (int q = 0; q < SEL_STEP; ++q) {
              bool keep = ok[q] && key_less(d2[q], f[q], tau_d, tau_f);
              unsigned k1 = __ballot_sync(0xffffffffu, keep);
              if (n + __popc(k1) > BUF) {
                const Kept<T> kp = prune(bd, bf, n, K, lane);
                n = kp.n;
                tau_d = kp.tau_d;
                tau_f = kp.tau_f;
                keep = ok[q] && key_less(d2[q], f[q], tau_d, tau_f);
                k1 = __ballot_sync(0xffffffffu, keep);
              }
              if (keep) {
                const int o = n + __popc(k1 & lanes_below(lane));
                bd[o] = d2[q];
                bf[o] = f[q];
              }
              n += __popc(k1);
            }
          }
        }
      }
    }
    // the valid candidates: each lane counted its own
    for (int off = 16; off > 0; off /= 2)
      m += __shfl_xor_sync(0xffffffffu, m, off);
    __syncwarp();
    // valid slots: a pair's slot is its rank in (d2, f) order
    rank_pairs(bd, bf, n, lane, [&](int rank, T, int f) {
      if (rank >= K) return;
      const int s = f / A;
      const int j = f - s * A;
      const long long o = out0 + rank;
      for (int x = 0; x < 3; ++x) {
        T s1, e1, s2, e2;
        two_sum(sh[s * 3 + x], ph[j * 3 + x], s1, e1);
        two_sum(s1, -ph[i * 3 + x], s2, e2);
        const T lo = fs_sub_rn(fs_add_rn(sl[s * 3 + x], pl[j * 3 + x]),
                               pl[i * 3 + x]);
        disp[o * 3 + x] = fs_add_rn(s2, fs_add_rn(fs_add_rn(e1, e2), lo));
      }
      jidx[o] = j;
      mask[o] = 1;
    });
  }

  // slots m..K-1: the first K - m invalid candidates by index, all below
  // K + m (at most m candidates there are valid).  With m < K the buffer
  // was never pruned and holds every valid pair: a bitmap of their indices
  // below the limit marks the valid ones.  A padded atom has none.
  if (m < K) {
    const long long sa = static_cast<long long>(S) * A;
    const long long km = static_cast<long long>(K) + m;
    const int lim = static_cast<int>(sa < km ? sa : km);
    const int words = (lim + 31) / 32;
    __syncwarp();
    for (int w = lane; w < words; w += 32) bits[w] = 0u;
    __syncwarp();
    for (int u = lane; u < n; u += 32) {
      const int f = bf[u];
      if (f < lim) atomicOr(&bits[f >> 5], 1u << (f & 31));
    }
    __syncwarp();
    // invalid candidates before each word (lane w holds word w's; words
    // <= 32 in the shared bitmap, more in global scratch, a word at a time)
    int r0 = 0;                              // invalid candidates so far
    for (int w0 = 0; w0 < words && m + r0 < K; w0 += 32) {
      const int wl = w0 + lane;
      const unsigned valid_w = wl < words ? bits[wl] : ~0u;
      const int span = lim - wl * 32;        // candidates of word wl
      const unsigned in_w = span >= 32 ? ~0u : span > 0 ? (1u << span) - 1u
                                                        : 0u;
      const int inv_w = __popc(~valid_w & in_w);
      int incl = inv_w;
      for (int off = 1; off < 32; off *= 2) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const int before_w = r0 + incl - inv_w;
      const int wn = min(32, words - w0);
      for (int w = 0; w < wn; ++w) {
        const unsigned bad_bits = __shfl_sync(0xffffffffu, ~valid_w & in_w, w);
        const int r = __shfl_sync(0xffffffffu, before_w, w) +
                      __popc(bad_bits & lanes_below(lane));
        if (((bad_bits >> lane) & 1u) && m + r < K) {
          const long long o = out0 + m + r;
          const int f = (w0 + w) * 32 + lane;
          disp[o * 3] = T(1);
          disp[o * 3 + 1] = T(0);
          disp[o * 3 + 2] = T(0);
          jidx[o] = f % A;
          mask[o] = 0;
        }
      }
      r0 += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// The atoms' arrays of config c.
template <typename T>
struct ConfigPtrs {
  const T *ph, *pl, *sh, *sl;
};

template <typename T>
__device__ __forceinline__ ConfigPtrs<T> config_ptrs(
    const T* pos_hi, const T* pos_lo, const T* svec_hi, const T* svec_lo,
    long long c, int A, int S) {
  return {pos_hi + c * A * 3, pos_lo + c * A * 3, svec_hi + c * S * 3,
          svec_lo + c * S * 3};
}

// The bitmap words a warp keeps in shared memory for K slots ((2 K + 31)
// / 32, rounded up to 16 bytes so that what follows stays aligned).
__host__ __device__ __forceinline__ int local_words(int K) {
  return ((2 * K + 31) / 32 + 3) / 4 * 4;
}

// The warp's pair buffer and bitmap: shared memory (gbuf_d null; `smem`
// holds the warps' d2, then their f, then their bitmaps), else atom ci's in
// global scratch.
template <typename T>
struct Buffers {
  T* bd;
  int* bf;
  unsigned* bits;
};

template <typename T>
__device__ __forceinline__ Buffers<T> buffers(unsigned char* smem, T* gbuf_d,
                                              int* gbuf_f, unsigned* gbits,
                                              int BUF, int K, long long ci) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (gbuf_d == nullptr) {
    T* d = reinterpret_cast<T*>(smem);
    int* f = reinterpret_cast<int*>(d + nw * BUF);
    return {d + warp * BUF, f + warp * BUF,
            reinterpret_cast<unsigned*>(f + nw * BUF) +
                warp * local_words(K)};
  }
  return {gbuf_d + ci * BUF, gbuf_f + ci * BUF,
          gbits + ci * ((2 * K + 31) / 32)};
}

// The dynamic shared bytes of nw warps' pair buffers and bitmaps (0 where
// they are in global scratch); a multiple of 16 (BUF % 4 == 0).
template <typename T>
__host__ __device__ __forceinline__ size_t local_bytes(bool local, int nw,
                                                       int BUF, int K) {
  return local ? static_cast<size_t>(nw) *
                     (BUF * (sizeof(T) + 4) + local_words(K) * 4)
               : 0;
}

// The fused shape: block (config c, one atom a warp) bins c's home atoms
// into shared memory, then its warps select one atom each.  Dynamic shared
// memory: the pair buffers and bitmaps (`local_bytes`; none when gbuf_d
// holds them), the sorted atoms (A x 4 T), the bin ranges (H + 1), the
// shifts' hi parts and home flags (S x (3 T + 1) bytes).
template <typename T>
__global__ void __launch_bounds__(SEL_MAX_WARPS * 32)
neighbors_fused_kernel(const T* __restrict__ pos_hi,
                       const T* __restrict__ pos_lo,
                       const T* __restrict__ svec_hi,
                       const T* __restrict__ svec_lo,
                       const int* __restrict__ natoms, int A, int S, int K,
                       int H, T cut2, T side, T inv_side,
                       T* __restrict__ gbuf_d,
                       int* __restrict__ gbuf_f, unsigned* __restrict__ gbits,
                       int BUF, T* __restrict__ disp,
                       int* __restrict__ jidx,
                       unsigned char* __restrict__ mask) {
  using V = typename AtomRec<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[6 * 32];
  __shared__ int wsum[33];
  __shared__ Grid<T> g;
  const int nw = blockDim.x >> 5;
  const int per_cfg = (A + nw - 1) / nw;
  const long long c = blockIdx.x / per_cfg;
  const int i = (blockIdx.x - c * per_cfg) * nw + (threadIdx.x >> 5);
  const ConfigPtrs<T> p =
      config_ptrs(pos_hi, pos_lo, svec_hi, svec_lo, c, A, S);
  const int na = natoms[c];
  V* sorted = reinterpret_cast<V*>(
      smem + local_bytes<T>(gbuf_d == nullptr, nw, BUF, K));
  int* bins = reinterpret_cast<int*>(sorted + AtomRec<T>::kPer * A);
  // the shifts' hi parts and home flags
  T* svs = reinterpret_cast<T*>(bins + H + 1 + (H + 1) % 2);
  unsigned char* homes = reinterpret_cast<unsigned char*>(svs + 3 * S);
  {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const T vx = p.sh[s * 3], vy = p.sh[s * 3 + 1], vz = p.sh[s * 3 + 2];
      svs[s * 3] = vx;
      svs[s * 3 + 1] = vy;
      svs[s * 3 + 2] = vz;
      homes[s] = vx == T(0) && vy == T(0) && vz == T(0) &&
                 p.sl[s * 3] == T(0) && p.sl[s * 3 + 1] == T(0) &&
                 p.sl[s * 3 + 2] == T(0);
    }
  }
  bin_atoms<T, true>(p.ph, p.pl, na, A, H, side, inv_side, g, bins, nullptr,
                     red, wsum, sorted);
  if (i >= A) return;                        // the whole warp
  const long long ci = c * A + i;
  const Buffers<T> bu = buffers(smem, gbuf_d, gbuf_f, gbits, BUF, K, ci);
  select_atom(p.ph, p.pl, p.sh, p.sl, svs, homes, na, i, A, S, K, cut2, g,
              bins, sorted, bu.bd, bu.bf, BUF, bu.bits, ci * K, disp, jidx,
              mask);
}

// The split shape (configs too large for the fused shape's shared memory):
// the bin pass, one block per config, into global scratch (grids, bins
// (C, H + 1), sorted (C, A, 4 T)), then the select pass, one warp per atom.
template <typename T>
__global__ void __launch_bounds__(BIN_THREADS)
neighbors_bin_kernel(const T* __restrict__ pos_hi,
                     const T* __restrict__ pos_lo,
                     const int* __restrict__ natoms, int A, int H,
                     T side, T inv_side, Grid<T>* __restrict__ grids,
                     int* __restrict__ bins_all,
                     typename AtomRec<T>::V* __restrict__ sorted_all) {
  extern __shared__ int bins[];              // [H + 1], then cursor [H]
  __shared__ T red[6 * 32];
  __shared__ int wsum[33];
  __shared__ Grid<T> g;
  const long long c = blockIdx.x;
  bin_atoms<T, false>(pos_hi + c * A * 3, pos_lo + c * A * 3, natoms[c], A,
                      H, side, inv_side, g, bins, bins + H + 1, red, wsum,
                      sorted_all + c * A * AtomRec<T>::kPer);
  int* out = bins_all + c * (H + 1);
  for (int h = threadIdx.x; h <= H; h += blockDim.x) out[h] = bins[h];
  if (threadIdx.x == 0) grids[c] = g;
}

template <typename T>
__global__ void __launch_bounds__(SEL_MAX_WARPS * 32)
neighbors_select_kernel(const T* __restrict__ pos_hi,
                        const T* __restrict__ pos_lo,
                        const T* __restrict__ svec_hi,
                        const T* __restrict__ svec_lo,
                        const int* __restrict__ natoms, long long atoms,
                        int A, int S, int K, int H, T cut2,
                        const Grid<T>* __restrict__ grids,
                        const int* __restrict__ bins_all,
                        const typename AtomRec<T>::V* __restrict__ sorted_all,
                        T* __restrict__ gbuf_d, int* __restrict__ gbuf_f,
                        unsigned* __restrict__ gbits, int BUF,
                        T* __restrict__ disp, int* __restrict__ jidx,
                        unsigned char* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];   // `local_bytes`
  const long long ci = static_cast<long long>(blockIdx.x) *
                           (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ci >= atoms) return;                   // the whole warp
  const long long c = ci / A;
  const int i = static_cast<int>(ci - c * A);
  const ConfigPtrs<T> p =
      config_ptrs(pos_hi, pos_lo, svec_hi, svec_lo, c, A, S);
  const Buffers<T> bu = buffers(smem, gbuf_d, gbuf_f, gbits, BUF, K, ci);
  const Grid<T> g = grids[c];
  select_atom(p.ph, p.pl, p.sh, p.sl, p.sh, nullptr, natoms[c], i, A, S, K,
              cut2, g, bins_all + c * (H + 1),
              sorted_all + c * A * AtomRec<T>::kPer, bu.bd, bu.bf, BUF,
              bu.bits, ci * K, disp, jidx, mask);
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

template <typename T>
int neighbors_launch(const T* pos_hi, const T* pos_lo, const T* svec_hi,
                     const T* svec_lo, const int* natoms, int C, int A, int S,
                     int K, int H, double cutoff, double side_d,
                     double inv_side_d, int buf, T* gbuf_d, int* gbuf_f,
                     unsigned* gbits, void* grids, int* bins, T* sorted,
                     T* disp, int* jidx, unsigned char* mask, void* stream) {
  using V = typename AtomRec<T>::V;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long atoms = static_cast<long long>(C) * A;
  if (atoms == 0 || K == 0) return 0;
  const bool local = gbuf_d == nullptr;
  const T side = static_cast<T>(side_d), inv_side = static_cast<T>(inv_side_d);
  // cutoff^2 as the plain version compares it: the square at float64,
  // rounded once to the working type
  const T cut2 = static_cast<T>(cutoff * cutoff);
  if (static_cast<long long>(S) * A > 0x7fffffffLL || H < 64 ||
      !(side_d > cutoff) || buf < K + 32 || local != (gbuf_f == nullptr) ||
      local != (gbits == nullptr) ||
      (local && buf % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grids == nullptr) {
    const int nw = A <= 256 ? SEL_MAX_WARPS / 2 : SEL_MAX_WARPS;
    // the fused kernel's atoms: at most BIN_ROUNDS a thread, in registers
    if (A > BIN_ROUNDS * 32 * nw) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem =
        local_bytes<T>(local, nw, buf, K) +
        static_cast<size_t>(A) * 4 * sizeof(T) +
        static_cast<size_t>(H + 2) * 4 +
        static_cast<size_t>(S) * (3 * sizeof(T) + 1);
    if (smem + 4096 > FS_SMEM_LIMIT) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the attribute bounds the dynamic bytes; room for the static ones
    const int err = fs_allow_smem(neighbors_fused_kernel<T>, smem + 4096);
    if (err) return err;
    const long long blocks = static_cast<long long>(C) * ((A + nw - 1) / nw);
    neighbors_fused_kernel<T><<<static_cast<unsigned>(blocks), nw * 32, smem,
                                st>>>(
        pos_hi, pos_lo, svec_hi, svec_lo, natoms, A, S, K, H, cut2, side,
        inv_side, gbuf_d, gbuf_f, gbits, buf, disp, jidx, mask);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bin_smem = static_cast<size_t>(2 * H + 1) * sizeof(int);
  int err = fs_allow_smem(neighbors_bin_kernel<T>, bin_smem);
  if (err) return err;
  neighbors_bin_kernel<T><<<C, BIN_THREADS, bin_smem, st>>>(
      pos_hi, pos_lo, natoms, A, H, side, inv_side,
      static_cast<Grid<T>*>(grids), bins, reinterpret_cast<V*>(sorted));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t pairs = local_bytes<T>(local, SEL_MAX_WARPS, buf, K);
  if (pairs + 4096 > FS_SMEM_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = fs_allow_smem(neighbors_select_kernel<T>, pairs + 4096);
  if (err) return err;
  const long long blocks = (atoms + SEL_MAX_WARPS - 1) / SEL_MAX_WARPS;
  neighbors_select_kernel<T><<<static_cast<unsigned>(blocks),
                               SEL_MAX_WARPS * 32, pairs, st>>>(
      pos_hi, pos_lo, svec_hi, svec_lo, natoms, atoms, A, S, K, H, cut2,
      static_cast<const Grid<T>*>(grids), bins,
      reinterpret_cast<const V*>(sorted), gbuf_d, gbuf_f, gbits, buf, disp,
      jidx, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos_hi, pos_lo (C, A, 3) f64, svec_hi, svec_lo (C, S, 3) f64, natoms (C,)
// i32.  The bins' side is `side` (above the cutoff; inv_side = 1 / side)
// and a config has at most H of them; each atom's buffer holds `buf` (d2, f)
// pairs, buf >= K + 32: in shared memory (buf % 4 == 0) where gbuf_d,
// gbuf_f and gbits are null, else gbuf_d (C * A, buf) f64, gbuf_f
// (C * A, buf) i32 and gbits (C * A, (2 K + 31) / 32) i32.  The split shape
// runs where `grids` is given, with scratch grids (C, 48 bytes), bins
// (C, H + 1) i32 and sorted (C, A, 4) f64; else the fused shape.  The
// caller (kernels/snap_kernels.py) chooses the shape and where the buffers
// live; this refuses only what does not fit a block (shared memory, or the
// fused kernel's atoms in registers).  Writes disp (C, A, K, 3) f64, jidx
// (C, A, K) i32, mask (C, A, K) u8.
extern "C" int device_neighbors(const double* pos_hi, const double* pos_lo,
                                const double* svec_hi, const double* svec_lo,
                                const int* natoms, int C, int A, int S, int K,
                                int H, double cutoff, double side,
                                double inv_side, int buf, double* gbuf_d,
                                int* gbuf_f, unsigned* gbits, void* grids,
                                int* bins, double* sorted, double* disp,
                                int* jidx, unsigned char* mask,
                                void* stream) {
  return neighbors_launch<double>(pos_hi, pos_lo, svec_hi, svec_lo, natoms,
                                  C, A, S, K, H, cutoff, side, inv_side, buf,
                                  gbuf_d, gbuf_f, gbits, grids, bins, sorted,
                                  disp, jidx, mask, stream);
}

// The float32 instantiation: `device_neighbors`' arguments with every f64
// array f32 (the hi/lo float32 parts of the positions and shifts, the
// scratch gbuf_d, grids (still 48 bytes a config) and sorted, and disp);
// cutoff, side and inv_side stay doubles, rounded to float32 here (cutoff^2
// squared first).
extern "C" int device_neighbors_f32(const float* pos_hi, const float* pos_lo,
                                    const float* svec_hi,
                                    const float* svec_lo, const int* natoms,
                                    int C, int A, int S, int K, int H,
                                    double cutoff, double side,
                                    double inv_side, int buf, float* gbuf_d,
                                    int* gbuf_f, unsigned* gbits, void* grids,
                                    int* bins, float* sorted, float* disp,
                                    int* jidx, unsigned char* mask,
                                    void* stream) {
  return neighbors_launch<float>(pos_hi, pos_lo, svec_hi, svec_lo, natoms, C,
                                 A, S, K, H, cutoff, side, inv_side, buf,
                                 gbuf_d, gbuf_f, gbits, grids, bins, sorted,
                                 disp, jidx, mask, stream);
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
