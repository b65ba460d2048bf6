"""Wrappers of the CUDA kernels of the linear SNAP fit, with their plain
PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K1 pair_u_duals (_chem) | csrc/pair_u_duals.cu | ops/snap.py _ck_prologue, _pair_wu_duals, _utot_from_wu |
| K2 zlist (_chem) | csrc/zlist.cu | ops/snap.py _compute_zcat_pair (channel pairs :1005-1010) |
| K3 dbdd (_chem) | csrc/dbdd.cu (+ atom_gemm.cuh) | ops/snap.py _dbdu_ylist, _chem_b_and_dbdu + the contractions at :956-982 |
| K6q quad_chain | csrc/quad_chain.cu | ops/snap.py _quad_chain |
| K4 pair_scatter_rows | csrc/pair_scatter.cu | calculators/snap.py:326-343 (and calculators/ace.py:153-162) |
| K5 zbl_eav | csrc/zbl_pair.cu | ops/refpot.py reference_eav (vjp and scatter; zbl, coul/cut, spin/exchange/biquadratic), zbl_pair_energy |
| K7 normal_contrib | csrc/normal_contrib.cu | parallel/fit.py config_normal_contrib (:288-364) |
| K8 device_neighbors | csrc/device_neighbors.cu | parallel/fit.py device_neighbors |
| K8r reverse_table | csrc/device_neighbors.cu | the index role of the one-hot (A, K, A) matmuls |

K1-K3 each have a one-channel wrapper and a chemflag one (`_chem`, utot in
element channels); the two share a source and count their launches apart.
Each wrapper takes its plain version for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else.  Every
launch adds one to the wrapper's `launches` count.
"""

from types import SimpleNamespace

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels.launch import (SMEM_LIMIT as _SMEM_LIMIT,
                                              check as _check,
                                              launch as _launch,
                                              on_cpu as _on_cpu, ptr as _ptr)
from fitsnap_tpu_torch.ops import snap as ops
from fitsnap_tpu_torch.ops.mono import mono_blocks, mono_plan

_P, _I, _LL, _D = kl.P, kl.I, kl.LL, kl.D
for _name in ("pair_u_duals", "pair_u_duals_f32"):
    kl.register(_name, "pair_u_duals",
                [_P] * 5 + [_D] * 3 + [_I, _I, _LL, _I] + [_P] * 7 + [_I] * 8
                + [_P] * 4)
kl.register("pair_u_recur", "pair_u_duals",
            [_P] * 5 + [_D] * 3 + [_I, _I, _LL, _I] + [_P] * 2 + [_I] * 5
            + [_P] * 4)
for _name in ("zlist", "zlist_f32"):
    kl.register(_name, "zlist", [_P, _LL] + [_I] * 4 + [_P] * 3 + [_I, _P]
                + [_I] * 2 + [_P] * 3)
for _name in ("dbdd", "dbdd_f32"):
    kl.register(_name, "dbdd", [_P] * 15 + [_LL] + [_I] * 8 + [_P] * 3)
kl.register("dbdd_level", "dbdd", [_P] * 12 + [_LL] + [_I] * 8 + [_P] * 3)
kl.register("quad_chain", "quad_chain", [_P] * 5 + [_LL] + [_I] * 3
            + [_P] * 3)
for _name in ("pair_scatter_rows", "pair_scatter_rows_f32"):
    kl.register(_name, "pair_scatter", [_P] * 5 + [_I] * 8 + [_P] * 4)
for _name in ("zbl_eav", "zbl_eav_f32"):
    kl.register(_name, "zbl_pair",
                [_P] * 6 + [_I] * 5 + [_D, _D] + [_P] * 6)
kl.register("ref_eav", "zbl_pair",
            [_P] * 9 + [_I] * 5 + [_D, _D] + [_P] * 6)
for _name in ("device_neighbors", "device_neighbors_f32"):
    kl.register(_name, "device_neighbors",
                [_P] * 5 + [_I] * 5 + [_D] * 3 + [_I] + [_P] * 10)
kl.register("reverse_table", "device_neighbors",
            [_P, _P] + [_I] * 4 + [_P] * 3)
kl.register("normal_contrib", "normal_contrib",
            [_P] * 15 + [_I] * 14 + [_P] * 6)
kl.register("normal_contrib_f32", "normal_contrib",
            [_P] * 15 + [_I] * 14 + [_P] * 7)


# ---------------------------------------------------------------------------
# K1: pair U expansion with tangents, and its neighbor sum
# ---------------------------------------------------------------------------


TWOJMAX_MAX = 16   # the largest twojmax the SNAP kernels take


def check_twojmax(p, kernel):
    """Refuse a plan past `TWOJMAX_MAX` before any of its kernel tables is
    built (the host plans alone pass 25 GB at twojmax 18)."""
    if p.twojmax > TWOJMAX_MAX:
        raise ValueError(f"twojmax {p.twojmax}: {kernel} takes at most "
                         f"{TWOJMAX_MAX}")


def _channels(p, chem, name):
    """Refuse a plan whose channel count is not the wrapper's mode."""
    if (p.nchem > 1) != chem:
        other = name[:-len("_chem")] if chem else name + "_chem"
        raise ValueError(f"{name}: the plan has {p.nchem} utot channel(s); "
                         f"use {other}")


def pair_u_duals_plain(disp, jelem, mask, ielem, p):
    """Plain K1, both modes: (J (3, N, K, 2U), ut (N, nchem*2U))."""
    wu, J = ops._pair_wu_duals(disp, jelem, mask, ielem, p)
    return J, ops._utot_from_wu(wu, jelem, ielem, p)


# block shape of csrc/pair_u_duals.cu: warps, pairs of a tile, most columns
# of a chunk, prologue doubles a pair
_K1_WARPS, _K1_TILE, _K1_CW, _K1_PRO = 8, 32, 4, 20


def _k1_row_stride(nc):
    """Row stride (doubles) of K1's window: the tile's pairs, then the nc
    channels of the weighted monomial sums, odd."""
    return (_K1_TILE + nc) | 1


def _k1_columns(p):
    """K1's change of basis by column, cached on the plan: the monomial
    exponents (n_mono, 4), the degree blocks (`mono_blocks`), and for each
    (column,
    accumulator) its nonzeros (monomial, coefficient) in monomial order,
    accumulators U = L M and dU/dv = L_v M (v = ar, ai, br, bi) with
    L_v[m, u] = (e_v(m) + 1) L[m + e_v, u]; e_ptr (2U * 5 + 1) their CSR."""
    if p.k1 is not None and "columns" in p.k1:
        return p.k1["columns"]
    exps, _, _, L = mono_plan(p.twojmax)
    exps = np.asarray(exps)
    index = {tuple(e): i for i, e in enumerate(exps)}
    mats = [L]
    for v in range(4):
        Lv = np.zeros_like(L)
        for m in np.nonzero(exps[:, v])[0]:
            e = exps[m].copy()
            e[v] -= 1
            Lv[index[tuple(e)]] = exps[m, v] * L[m]
        mats.append(Lv)
    stack = np.stack(mats, 1).transpose(2, 1, 0)     # (2U, 5, n_mono)
    col, acc, mono = np.nonzero(stack)
    counts = np.bincount(col * 5 + acc, minlength=stack.shape[0] * 5)
    cols = SimpleNamespace(
        exps=exps, blocks=mono_blocks(p.twojmax)[0], mono=mono,
        coef=stack[col, acc, mono],
        e_ptr=np.concatenate([[0], np.cumsum(counts)]))
    p.k1 = dict(p.k1 or {}, columns=cols)
    return cols


_K1_ENT_CAP = 96   # entries of a chunk (more only for a column alone)


def _k1_chunks(p):
    """K1's column chunks in level order, a level's real columns and then
    its imaginary ones: (first column, columns), at most 4 columns (3 from
    an odd column, so that the next chunk starts even) and `_K1_ENT_CAP`
    entries unless one column alone holds more; cached on the plan."""
    cols = _k1_columns(p)
    if "chunks" in p.k1:
        return p.k1["chunks"]
    per_col = np.diff(cols.e_ptr).reshape(-1, 5).sum(1)
    U = p.u_len
    chunks = []
    for _, _, c0, c1 in cols.blocks:
        for lo, hi in ((c0, c1), (U + c0, U + c1)):
            u = lo
            while u < hi:
                n = 1
                while (n < _K1_CW - u % 2 and u + n < hi
                       and per_col[u:u + n + 1].sum() <= _K1_ENT_CAP):
                    n += 1
                if u + n < hi and (u + n) % 2 and n > 1:
                    n -= 1
                chunks.append((u, n))
                u += n
    p.k1["chunks"] = chunks
    return chunks


def _k1_steps(cols, u, n):
    """A chunk's steps (`pair_u_tables`): (coefficients (steps, 4), window
    monomials (steps, 4), -1 where a slot has no entry, and the step ends
    of the 4 x 5 (column, accumulator) runs).  A run's entries fill its
    steps in order, 4 a step; the last step is padded."""
    coef, mono, ends = [], [], []
    for cc in range(_K1_CW):
        for g in range(5):
            if cc < n:
                q = np.arange(cols.e_ptr[5 * (u + cc) + g],
                              cols.e_ptr[5 * (u + cc) + g + 1])
                depth = -(-len(q) // _K1_CW)
                c = np.zeros(depth * _K1_CW)
                m = np.full(depth * _K1_CW, -1, np.int64)
                c[:len(q)] = cols.coef[q]
                m[:len(q)] = cols.mono[q]
                coef.append(c.reshape(-1, _K1_CW))
                mono.append(m.reshape(-1, _K1_CW))
            ends.append(sum(len(x) for x in coef))
    return np.concatenate(coef), np.concatenate(mono), ends


def pair_u_tables(p, nsplit):
    """K1's window-shape plan with `nsplit` splits, cached on the plan: the
    chunks (`_k1_chunks`) cut into `nsplit` contiguous ranges of about
    equal entries; warp w of a block takes the split's chunks 8 r + w.  A
    chunk is a header of 24 ints (first column, columns, two unused, the
    step ends of its 20 (column, accumulator) runs; accumulators U,
    dU/dar, dU/dai, dU/dbr, dU/dbi), then its steps of 4 entries
    (`_k1_steps`): 4 coefficients and one double of the 4 slots' places,
    5 doubles a step (an empty slot has coefficient 0 and place 0).

    Each split lists the monomials its columns read (its window) and a
    slot's place is its window offset slot * `_k1_row_stride` as uint16;
    chunks are padded to 16 bytes, in column order.  At the plan's type
    (`p.dtype`): a float32 plan's steps are 4 float32 coefficients (each
    rounded once from the float64 change of basis) and the offsets, 6
    floats, its header 24 floats.  Tensors on the plan's device: blob (the
    chunks), loc (n, 2) i32 (first value and values of each chunk) by
    (split, warp), cw_ptr (nsplit * 8 + 1); win_ptr, win_exp (p | q << 8 |
    r << 16 | s << 24); zr_ptr, zruns (n, 2) each split's column runs [u0,
    u1); and the sizes of the kernel's buffers: the largest window, chunks
    of a warp, and doubles of a chunk.  None where a window offset passes
    16 bits."""
    cols = _k1_columns(p)
    if ("window", nsplit) in p.k1:
        return p.k1["window", nsplit]
    chunks = _k1_chunks(p)
    if not 1 <= nsplit <= len(chunks):
        raise ValueError(f"pair_u_duals: {nsplit} splits of "
                         f"{len(chunks)} chunks")
    f32 = p.dtype == torch.float32
    per_col = np.diff(cols.e_ptr).reshape(-1, 5).sum(1)
    weight = np.array([per_col[u:u + n].sum() + 16 * n for u, n in chunks],
                      np.float64)
    mid = np.cumsum(weight) - weight / 2
    split = np.minimum((mid * nsplit / weight.sum()).astype(np.int64),
                       nsplit - 1)
    ms = _k1_row_stride(p.nchem)
    e = cols.exps
    pieces, loc, cw_ptr, win_ptr, win_exp = [], [], [0], [0], []
    zr_ptr, zruns = [0], []
    size = max_win = max_wch = max_len = 0
    for s in range(nsplit):
        mine = [chunks[i] for i in np.nonzero(split == s)[0]]
        ucols = [u + i for u, n in mine for i in range(n)]
        sel = np.concatenate([np.arange(cols.e_ptr[5 * u],
                                        cols.e_ptr[5 * u + 5])
                              for u in ucols] + [np.zeros(0, np.int64)])
        win = np.unique(cols.mono[sel])
        slot = np.zeros(e.shape[0], np.int64)
        slot[win] = np.arange(len(win))
        we = e[win]
        win_exp.extend(we[:, 0] | we[:, 1] << 8 | we[:, 2] << 16
                       | we[:, 3] << 24)
        win_ptr.append(len(win_exp))
        max_win = max(max_win, len(win))
        by_warp = [[] for _ in range(_K1_WARPS)]
        for k, (u, n) in enumerate(mine):
            c, m, ends = _k1_steps(cols, u, n)
            head = np.array([u, n, 0, 0, *ends], np.int32)
            off = np.where(m < 0, 0, slot[np.maximum(m, 0)]) * ms
            if off.max(initial=0) > 0xffff:
                p.k1["window", nsplit] = None
                return None
            off = off.astype(np.uint16)
            if f32:
                st32 = np.zeros((len(c), 6), np.float32)
                st32[:, :4] = c
                st32[:, 4:] = off.view(np.float32)
                piece = np.concatenate([head.view(np.float32),
                                        st32.reshape(-1)])
                piece = np.concatenate([piece, np.zeros(
                    -len(piece) % 4, np.float32)])
            else:
                steps = np.zeros((len(c), 5))
                steps[:, :4] = c
                steps[:, 4] = off.view(np.float64)[:, 0]
                piece = np.concatenate([head.view(np.float64),
                                        steps.reshape(-1),
                                        np.zeros(len(c) % 2)])
            by_warp[k % _K1_WARPS].append(piece)
        for lst in by_warp:
            for piece in lst:
                loc.append((size, len(piece)))
                pieces.append(piece)
                size += len(piece)
                max_len = max(max_len, len(piece))
            cw_ptr.append(len(loc))
            max_wch = max(max_wch, len(lst))
        for u in sorted(ucols):
            if len(zruns) > zr_ptr[-1] and zruns[-1][1] == u:
                zruns[-1][1] = u + 1
            else:
                zruns.append([u, u + 1])
        zr_ptr.append(len(zruns))

    def t(x, width=None):
        x = np.asarray(x, np.int64).astype(np.int32)
        return torch.as_tensor(x if width is None else x.reshape(-1, width),
                               device=p.device)

    blob = torch.as_tensor(np.concatenate(pieces), device=p.device)
    plan = SimpleNamespace(
        shape="window", blob=blob, loc=t(loc, 2), cw_ptr=t(cw_ptr),
        win_ptr=t(win_ptr), win_exp=t(win_exp), zr_ptr=t(zr_ptr),
        zruns=t(zruns, 2), nsplit=nsplit, max_win=max_win, max_wch=max_wch,
        bufd=max_len, twojmax=p.twojmax, itemsize=blob.element_size())
    p.k1["window", nsplit] = plan
    return plan


def pair_u_smem(plan, nc, K):
    """Bytes of shared memory of a K1 block (csrc/pair_u_duals.cu) of
    `plan`'s shape (a window plan at its `itemsize`, 8 or 4)."""
    if plan.shape == "recursion":
        tj = plan.twojmax
        return 8 * (nc * plan.two_u + 2 * _K1_RW * _k1_recur_stage(tj)
                    + (tj + 1) ** 2) + 4 * (K + _K1_RW + 1)
    b = plan.itemsize
    fixed = b * (_K1_PRO * _K1_TILE + 4 * (plan.twojmax + 1) * _K1_TILE) \
        + 4 * (K + _K1_TILE + 1)
    q = 16 // b                      # values of 16 bytes
    return fixed + b * (-(-plan.max_win * _k1_row_stride(nc) // q) * q
                        + 2 * _K1_WARPS * plan.bufd) \
        + 4 * (2 * _K1_WARPS * plan.max_wch + plan.max_win)


def _k1_window_floor(p, K):
    """Bytes of shared memory that every window plan of `p` needs at K
    neighbor slots, whatever its split count: the most monomials that one
    chunk reads and the longest chunk (cached on the plan)."""
    if "floor" not in p.k1:
        cols = _k1_columns(p)
        chunks = _k1_chunks(p)
        win = max(len(np.unique(cols.mono[cols.e_ptr[5 * u]:
                                          cols.e_ptr[5 * (u + n)]]))
                  for u, n in chunks)
        steps = max(len(_k1_steps(cols, u, n)[0]) for u, n in chunks)
        if p.dtype == torch.float32:
            bufd = -(-(24 + 6 * steps) // 4) * 4
        else:
            bufd = 12 + 5 * steps + steps % 2
        p.k1["floor"] = (win, bufd)
    win, bufd = p.k1["floor"]
    return pair_u_smem(SimpleNamespace(
        shape="window", max_win=win, bufd=bufd, max_wch=1,
        twojmax=p.twojmax,
        itemsize=4 if p.dtype == torch.float32 else 8), p.nchem, K)


K1_SHAPES = ("window", "recursion")   # in the planner's order
# The most splits at which a window fits that the window shape takes: each
# split repeats its pairs' prologue and monomials, so that past 16 splits
# (twojmax 11 and up) the recursion shape is faster on the H100, while up
# to twojmax 10 (at most 4 splits) the window shape is (`chip_smoke.py`
# phase 21, PERF.md)
K1_WINDOW_SPLITS = 16
# csrc/pair_u_duals.cu's recursion shape: warps of a block (a pair each)
_K1_RW = 4
# the most level splits of the recursion shape
K1_RECUR_SPLITS = 8


def _k1_recur_stage(twojmax):
    """Doubles of a warp's staged level in the recursion shape: the largest
    level's half rows, real and imaginary."""
    return 2 * (twojmax // 2 + 1) * (twojmax + 1)


def pair_u_recur_plan(p, nsplit):
    """K1's recursion shape with `nsplit` level splits, cached on the plan:
    rt ((twojmax + 1)^2,) f64, sqrt(p / q) at p (twojmax + 1) + q (0 where
    p or q is 0: the recursion's coefficients, as `cg.rootpq_tables` forms
    them); lv (nsplit + 1,) i32 each split's first level, the levels cut
    into shares of about equal columns ((j + 1)^2 a level)."""
    if p.k1 is None:
        p.k1 = {}
    if ("recursion", nsplit) in p.k1:
        return p.k1["recursion", nsplit]
    tj = p.twojmax
    if not 1 <= nsplit <= tj + 1:
        raise ValueError(f"pair_u_duals: {nsplit} splits of {tj + 1} "
                         f"levels")
    if p.dtype == torch.float32:
        raise kl.f32_refusal("pair_u_duals (recursion shape)",
                             kl.QUEUE_LARGE)
    pq = np.arange(tj + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rt = np.sqrt(pq[:, None] / pq[None, :])
    rt[:, 0] = 0.0
    lv = _k1_level_cuts(tj, nsplit)
    plan = SimpleNamespace(
        shape="recursion", nsplit=nsplit, twojmax=tj, two_u=2 * p.u_len,
        rt=torch.as_tensor(rt.reshape(-1), device=p.device),
        lv=torch.as_tensor(np.asarray(lv, np.int32), device=p.device))
    p.k1["recursion", nsplit] = plan
    return plan


def _k1_level_cuts(twojmax, nsplit):
    """First level of each of `nsplit` splits and twojmax + 1: the levels
    in order, cut where the running count of columns ((j + 1)^2 a level)
    comes nearest each share; every split holds a level at least."""
    cum = np.cumsum((np.arange(twojmax + 1) + 1) ** 2)
    cuts = [0]
    for s in range(1, nsplit):
        j = int(np.abs(cum - cum[-1] * s / nsplit).argmin()) + 1
        cuts.append(min(max(j, cuts[-1] + 1), twojmax + 1 - (nsplit - s)))
    return cuts + [twojmax + 1]


def pair_u_plan(p, N, K, sms):
    """(shape, splits) of K1 at N atoms on a card of `sms` SMs: the first
    of `K1_SHAPES` with a split count that fits a block's shared memory
    (the window shape skipped where its floor, `_k1_window_floor`, does
    not, or where it first fits past `K1_WINDOW_SPLITS` splits), and of
    its split counts (powers of two) the fewest that fits and gives a
    block to every other SM (or an eighth of the chunks to a split); the
    recursion shape's splits are of levels, the fewest (to
    `K1_RECUR_SPLITS`) that give two blocks to every SM.  Raises when no
    shape fits.  A float32 plan has the window shape alone, at any split
    count that fits (the recursion shape is float64 only)."""
    nchunks = len(_k1_chunks(p))
    counts = [1 << i for i in range(nchunks.bit_length())
              if 1 << i <= nchunks]
    f32 = p.dtype == torch.float32
    for shape in ("window",) if f32 else K1_SHAPES:
        if shape == "recursion":
            s = 1
            while s < min(K1_RECUR_SPLITS, p.twojmax + 1) and N * s < 2 * sms:
                s *= 2
            s = min(s, p.twojmax + 1)
            if pair_u_smem(pair_u_recur_plan(p, s), p.nchem, K) \
                    <= _SMEM_LIMIT:
                return shape, s
            continue
        if _k1_window_floor(p, K) > _SMEM_LIMIT:
            continue
        fitted = False
        for s in counts:
            pl = pair_u_tables(p, s)
            if pl is None or pair_u_smem(pl, p.nchem, K) > _SMEM_LIMIT:
                continue
            if not fitted and s > K1_WINDOW_SPLITS and not f32:
                break
            fitted = True
            if 2 * N * s >= sms or 8 * s > nchunks:
                return shape, s
    if f32:
        raise kl.f32_refusal(f"pair_u_duals at twojmax {p.twojmax} (no "
                             f"window fits)", kl.QUEUE_LARGE)
    raise ValueError(f"pair_u_duals: neither shape fits a block's shared "
                     f"memory at K = {K}, {p.nchem} channel(s), twojmax "
                     f"{p.twojmax}")


def pair_u_split_count(p, N, K, sms):
    """Splits of K1 at N atoms (`pair_u_plan`)."""
    return pair_u_plan(p, N, K, sms)[1]


def _plan_type(p, dt, name):
    """Refuse a plan whose tables are not at the inputs' type `dt`."""
    if p.dtype != dt:
        raise TypeError(f"{name}: the plan's tables are {p.dtype} and the "
                        f"inputs {dt}: pass p.cast({dt})")


def _pair_u_duals_launch(disp, jelem, mask, ielem, p):
    N, K = mask.shape
    two_u = 2 * p.u_len
    dt = kl.float_type("pair_u_duals", disp)
    _plan_type(p, dt, "pair_u_duals")
    _check(disp, "disp", dt, (N, K, 3))
    _check(jelem, "jelem", torch.int32, (N, K))
    _check(mask, "mask", torch.bool, (N, K))
    _check(ielem, "ielem", torch.int32, (N,))
    dev = disp.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape, nsplit = pair_u_plan(p, N, K, sms)
    pl = (pair_u_recur_plan(p, nsplit) if shape == "recursion"
          else pair_u_tables(p, nsplit))
    J = torch.empty((3, N, K, two_u), dtype=dt, device=dev)
    ut = torch.empty((N, p.nchem * two_u), dtype=dt, device=dev)
    common = (_ptr(disp), _ptr(jelem), _ptr(mask), _ptr(ielem), _ptr(p.elem),
              p.rcutfac, p.rfac0, p.rmin0, int(p.switchflag),
              int(p.switchinnerflag), N, K)
    tail = (pl.twojmax, two_u, p.nchem, int(p.wselfallflag), _ptr(p.selfvec),
            _ptr(J), _ptr(ut))
    if pl.shape == "recursion":
        _launch("pair_u_recur", dev, *common, _ptr(pl.rt), _ptr(pl.lv),
                pl.nsplit, *tail)
        SHAPE_LAUNCHES["pair_u_recur"] += 1
        return J, ut
    _launch(kl.entry("pair_u_duals", dt), dev, *common, _ptr(pl.blob),
            _ptr(pl.loc), _ptr(pl.cw_ptr), _ptr(pl.win_ptr),
            _ptr(pl.win_exp), _ptr(pl.zr_ptr), _ptr(pl.zruns), pl.nsplit,
            pl.max_win, pl.max_wch, pl.bufd, *tail)
    return J, ut


def pair_u_duals(disp, jelem, mask, ielem, p):
    """K1 on the card, one channel: disp (N, K, 3) f64 or f32 (with the
    plan at its type, `p.cast`; float32 runs the window shape, to twojmax
    12), jelem (N, K) i32, mask (N, K) bool, ielem (N,) i32.  Same outputs
    as `pair_u_duals_plain`, at disp's type."""
    if _on_cpu(disp, jelem, mask, ielem):
        return pair_u_duals_plain(disp, jelem, mask, ielem, p)
    check_twojmax(p, "K1")
    _channels(p, False, "pair_u_duals")
    out = _pair_u_duals_launch(disp, jelem, mask, ielem, p)
    kl.count(pair_u_duals, disp.dtype)
    return out


def pair_u_duals_chem(disp, jelem, mask, ielem, p):
    """K1 on the card, chemflag mode: each neighbor summed into the utot
    channel of its element; ut (N, nchem*2U).  Arguments as
    `pair_u_duals`."""
    if _on_cpu(disp, jelem, mask, ielem):
        return pair_u_duals_plain(disp, jelem, mask, ielem, p)
    check_twojmax(p, "K1")
    _channels(p, True, "pair_u_duals_chem")
    _check(disp, "disp", torch.float64, disp.shape, queue=kl.QUEUE_CHEM)
    out = _pair_u_duals_launch(disp, jelem, mask, ielem, p)
    pair_u_duals_chem.launches += 1
    return out


pair_u_duals.launches = 0
pair_u_duals_chem.launches = 0


# ---------------------------------------------------------------------------
# K2: z-lists
# ---------------------------------------------------------------------------


def zlist_plain(ut, p):
    """Plain K2: (z_r, z_i), each (N, nz)."""
    return ops._compute_zcat(ut, p)


def zlist_chem_plain(ut, p):
    """Plain K2, chemflag mode: (z_r, z_i), each (N, nchem^2, nz), pair
    ea*nchem + eb the z-list of channel ea with channel eb."""
    return ops._compute_zcat_chem(ut, p)


_K2_WARPS, _K2_COMBOS = 8, 8   # csrc/zlist.cu: warps, combinations a pass


def zlist_tables(p):
    """K2's schedule, cached on the plan (numpy): the outputs with terms
    sorted by term count (most first, then by index) in groups of 32, one
    output a lane (-1 past the end): grp_out (G * 32); each group's terms
    lane-interleaved, term q of lane l at record first + 32 q + l, padded
    with zero terms to the group's count: rec (R, 4) i32 (the coefficient's
    two words, i1, i2; a float32 plan's coefficient as its float32 bits in
    the first word, the second 0), grp (G, 2) (first record, count); zo
    the outputs without terms, in order."""
    if p.k2 is not None:
        return p.k2
    out = p.z_out.cpu().numpy()
    ptr = p.z_ptr.cpu().numpy().astype(np.int64)
    i1, i2 = p.z_i1.cpu().numpy(), p.z_i2.cpu().numpy()
    coef = p.z_c.cpu().numpy()
    count = np.bincount(out, minlength=p.nz)
    live = np.nonzero(count)[0]
    order = live[np.lexsort((live, -count[live]))]
    G = -(-len(order) // 32)
    grp_out = np.full(G * 32, -1, np.int64)
    grp_out[:len(order)] = order
    grp, terms = [], []
    first = 0
    for g in range(G):
        lanes = grp_out[g * 32:(g + 1) * 32]
        n = np.where(lanes >= 0, count[np.maximum(lanes, 0)], 0)
        q = np.arange(n.max())[:, None]
        idx = np.where(q < n[None, :], ptr[np.maximum(lanes, 0)] + q, -1)
        terms.append(idx.reshape(-1))
        grp.append((first, n.max()))
        first += idx.size
    terms = np.concatenate(terms)
    pad = terms < 0
    rec = np.zeros((terms.size, 2), np.int64)
    if p.dtype == torch.float32:
        rec[:, 0] = np.where(pad, 0.0, coef[terms]).astype(np.float32) \
            .view(np.int32).astype(np.int64) & 0xffffffff
    else:
        rec[:, 0] = np.where(pad, 0.0, coef[terms]).view(np.int64)
    rec[:, 1] = (np.where(pad, 0, i1[terms]).astype(np.int64)
                 | np.where(pad, 0, i2[terms]).astype(np.int64) << 32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32),
                               device=p.device)

    p.k2 = SimpleNamespace(
        rec=torch.as_tensor(rec.view(np.int32).reshape(-1, 4),
                            device=p.device),
        grp=t(np.array(grp).reshape(-1, 2)), grp_out=t(grp_out),
        zo=t(np.nonzero(count == 0)[0]))
    return p.k2


def _zlist_launch(ut, p):
    N, nc = ut.shape[0], p.nchem
    dt = kl.float_type("zlist", ut)
    _plan_type(p, dt, "zlist")
    _check(ut, "ut", dt, (N, nc * 2 * p.u_len))
    tb = zlist_tables(p)
    ab = max(1, _K2_COMBOS // (nc * nc))
    G = tb.grp.shape[0]
    sms = torch.cuda.get_device_properties(ut.device).multi_processor_count
    nseg = max(1, min(G // _K2_WARPS, -(-4 * sms // -(-N // ab))))
    zr = torch.empty((N, nc * nc, p.nz), dtype=dt, device=ut.device)
    zi = torch.empty_like(zr)
    _launch(kl.entry("zlist", dt), ut.device, _ptr(ut), N, 2 * p.u_len, nc,
            ab, nseg,
            _ptr(tb.rec), _ptr(tb.grp), _ptr(tb.grp_out), G, _ptr(tb.zo),
            tb.zo.shape[0], p.nz, _ptr(zr), _ptr(zi))
    return zr, zi


def zlist(ut, p):
    """K2 on the card: ut (N, 2U) f64 or f32 (the plan at its type) ->
    (z_r, z_i) (N, nz) at ut's type."""
    if _on_cpu(ut):
        return zlist_plain(ut, p)
    check_twojmax(p, "K2")
    _channels(p, False, "zlist")
    zr, zi = _zlist_launch(ut, p)
    kl.count(zlist, ut.dtype)
    return zr[:, 0], zi[:, 0]


def zlist_chem(ut, p):
    """K2 on the card, chemflag mode: ut (N, nchem*2U) f64 -> (z_r, z_i)
    (N, nchem^2, nz), every ordered channel pair in one launch."""
    if _on_cpu(ut):
        return zlist_chem_plain(ut, p)
    check_twojmax(p, "K2")
    _channels(p, True, "zlist_chem")
    _check(ut, "ut", torch.float64, ut.shape, queue=kl.QUEUE_CHEM)
    out = _zlist_launch(ut, p)
    zlist_chem.launches += 1
    return out


zlist.launches = 0
zlist_chem.launches = 0


# ---------------------------------------------------------------------------
# K3: dB/dutot, B and the pair jacobian dB/dD
# ---------------------------------------------------------------------------

# K3's shapes past whole rows, in the planner's order: the level shape
# (one channel) and the slab shape (csrc/dbdd.cu)
K3_SHAPES = ("level", "slab")


def dbdd_plan(p, K=64):
    """(rows of W per block, blocks per atom, slab) of csrc/dbdd.cu at K
    neighbor slots.  Whole y rows (slab 0) where 16 of them fit a block:
    one channel's y rows (2U + pad doubles each) beside the neighbor
    lists, the zero-block flags and the product's epilogue stage, two
    blocks an SM where they fit (`launch.row_plan`).  Else rows of 32 and y
    built in slabs of u columns, the widest multiple of 48 whose rows fit
    two blocks an SM (one channel runs the level shape there instead,
    `dbdd_shape`).  A float32 plan's rows are float32 (whole rows to
    twojmax 12; no slab shape at float32)."""
    ldl = kl.ag_ldl(2 * p.u_len)
    b = p.dtype.itemsize
    fixed = kl.AG_STAGE_BYTES * b // 8 + 4 * (2 * K + 2)
    if 16 * b * ldl + fixed + 2 * ldl // 8 <= _SMEM_LIMIT:
        return kl.row_plan(p.nb_base, b * ldl, fixed + 2 * ldl // 8,
                           "dbdd") + (0,)
    if p.dtype == torch.float32:
        raise kl.f32_refusal(f"dbdd at twojmax {p.twojmax} (slab shape)",
                             kl.QUEUE_LARGE)
    slab = 48 * ((kl.SMEM_PAIR - fixed) // (32 * 8) // 48)
    while slab > 48 and 32 * 8 * kl.ag_ldl(slab) + fixed \
            + 2 * kl.ag_ldl(slab) // 8 > kl.SMEM_PAIR:
        slab -= 48
    if 32 * 8 * kl.ag_ldl(slab) + fixed > _SMEM_LIMIT:
        raise ValueError(f"dbdd: a slab of 48 columns of 32 rows exceeds a "
                         f"block's shared memory at K = {K}")
    tiles = -(-p.nb_base // 32)
    per = -(-p.nb_base // tiles)
    return -(-per // 16) * 16, tiles, slab


def dbdd_shape(p, K=64):
    """K3's shape at K neighbor slots: "rows" where whole y rows fit
    (`dbdd_plan`), else the first of `K3_SHAPES` that takes the plan (the
    level shape one channel only)."""
    if dbdd_plan(p, K)[2] == 0:
        return "rows"
    for shape in K3_SHAPES:
        if shape == "slab" or p.nchem == 1:
            return shape
    raise ValueError(f"dbdd: no shape of {K3_SHAPES} takes {p.nchem} "
                     f"channels past whole rows")


# csrc/dbdd.cu's level shape: columns of a level in a chunk, rows of a
# group (4 row tiles of 16), the y buffer's row stride, the threads the
# records are dealt to, J chunks in shared memory and a stage row's stride;
# a block's slots at the most (96 columns)
_K3_CH, _K3_GROUP, _K3_LDY, _K3_REC = 16, 64, 36, 256
_K3_STAGES, _K3_LDJ, _K3_SLOTS = 4, 52, 32


def dbdd_level_tiles(K):
    """(KB, CT) of K3's level shape at K neighbor slots: the slots in CT
    tiles of KB, as few tiles as keep a tile within 32 slots."""
    ct = -(-K // _K3_SLOTS)
    return -(-K // ct), ct


def dbdd_level_smem(KB, nch=0, nrows=0, W=0):
    """Bytes of shared memory of a level-shape block of KB slots: the J
    stages (3 KB rows, padded to whole n-tiles of 8, of two parts), two
    y buffers, the tile's J row offsets, and the plan's chunk table, row
    lists and B's row pointers (`dbdd_levels`: nch chunks, nrows rows, W
    rows of B)."""
    return 8 * (_K3_STAGES * -(-3 * KB // 8) * 8 * _K3_LDJ
                + 2 * _K3_GROUP * _K3_LDY + 3 * _K3_SLOTS) \
        + 4 * (8 * nch + nrows + W + 1)


def dbdd_levels(p):
    """K3's level plan, cached on the plan (one channel): the rows of each
    level (the triples whose targets, `dbdd_tables`, fall in it) in groups
    of at most 64, each group's level columns in chunks of 16, and for
    each chunk the records that build its y tile (the group's rows padded
    to 16 x the chunk's columns padded to 8; real part at column c, the
    imaginary one at c + the padded width).

    - chunk (nch, 8) i32: first row of the group in `rows`, row tiles of
      16, the chunk's first column (level offset + c0), columns L, first
      record, record rows m, 1 where the group's level ends (its sums go
      into dB/dD), 0;
    - rows i32: each group's rows, w | 1 << 30 at the row's first group in
      chunk order (written there, added later), -1 padding;
    - rec (n, 4) i32: record r = m * 256 + thread of a chunk (from its
      first) is (pos | set << 30, z index, the two words of its factor f):
      y[pos] (=, where set, else +=) f z_r[index], y[pos + padded width]
      the same with z_i; index -1 writes 0 (a position without target);
      pos -1 a record that does nothing; a target's records (its nonzero
      layers in layer order, or one zero record) on one thread in order,
      the targets dealt to the threads in turn;
    - b_ptr (W + 1), b_u, b_src i32, b_fac f64: each row's layer-0 terms
      (targets with a nonzero layer-0 factor), B's."""
    tg = dbdd_tables(p)
    if tg.levels is not None:
        return tg.levels
    if p.nchem != 1:
        raise ValueError("dbdd_levels: the level shape takes one channel")
    ptr = tg.tg_ptr.cpu().numpy().astype(np.int64)
    tu = tg.tg_u.cpu().numpy().astype(np.int64)
    tsrc = tg.tg_src.cpu().numpy().astype(np.int64)
    tfac = tg.tg_fac.cpu().numpy().astype(np.float64)
    W, tj = p.nb_base, p.twojmax
    t_of = np.repeat(np.arange(W), np.diff(ptr))
    off = np.array([j * (j + 1) * (2 * j + 1) // 6 for j in range(tj + 2)])
    lev = np.searchsorted(off, tu, "right") - 1
    chunks, rows = [], []
    recs, facs, nrec = [], [], 0
    seen = np.zeros(W, bool)
    for j in range(tj + 1):
        at = np.nonzero(lev == j)[0]
        R = np.unique(t_of[at])
        n = (j + 1) ** 2
        for g0 in range(0, len(R), _K3_GROUP):
            Rg = R[g0:g0 + _K3_GROUP]
            nrt = -(-len(Rg) // 16)
            rbase = len(rows)
            rows.extend(int(t) | (0 if seen[t] else 1 << 30) for t in Rg)
            rows.extend([-1] * (nrt * 16 - len(Rg)))
            seen[Rg] = True
            rr_of = np.full(W, -1)
            rr_of[Rg] = np.arange(len(Rg))
            mine = at[rr_of[t_of[at]] >= 0]
            for c0 in range(0, n, _K3_CH):
                L = min(_K3_CH, n - c0)
                lp8 = -(-L // 8) * 8
                sel = mine[(tu[mine] - off[j] >= c0)
                           & (tu[mine] - off[j] < c0 + L)]
                # the tile's positions, row-major: each target's layers
                npos = nrt * 16 * lp8
                lay_src = np.full((npos, 3), -1)
                lay_fac = np.zeros((npos, 3))
                q = rr_of[t_of[sel]] * lp8 + (tu[sel] - off[j] - c0)
                lay_src[q] = tsrc[sel]
                lay_fac[q] = tfac[sel]
                live = lay_fac != 0
                cnt = np.maximum(live.sum(1), 1)
                # dealt in turn: position q on thread q % 256, in order
                th = np.arange(npos) % _K3_REC
                slot = np.arange(npos) // _K3_REC
                per = np.zeros((-(-npos // _K3_REC), _K3_REC), np.int64)
                per[slot, th] = cnt
                start = np.cumsum(per, 0) - per
                m = int(per.sum(0).max())
                rx = np.full((m, _K3_REC), -1, np.int64)
                ry = np.full((m, _K3_REC), -1, np.int64)
                rf = np.zeros((m, _K3_REC))
                pos = np.arange(npos) // lp8 * _K3_LDY \
                    + np.arange(npos) % lp8
                k = np.zeros(npos, np.int64)
                for layer in range(3):
                    use = live[:, layer] | ((layer == 0) & ~live.any(1))
                    qq = np.nonzero(use)[0]
                    mm = start[slot[qq], th[qq]] + k[qq]
                    rx[mm, th[qq]] = pos[qq] | np.where(k[qq] == 0, 1 << 30,
                                                        0)
                    ry[mm, th[qq]] = np.where(live[qq, layer],
                                              lay_src[qq, layer], -1)
                    rf[mm, th[qq]] = np.where(live[qq, layer],
                                              lay_fac[qq, layer], 0.0)
                    k[qq] += 1
                chunks.append([rbase, nrt, off[j] + c0, L, nrec, m,
                               int(c0 + L >= n), 0])
                recs.append(np.stack([rx.reshape(-1), ry.reshape(-1)], 1))
                facs.append(rf.reshape(-1))
                nrec += m * _K3_REC
    b0 = tfac[:, 0] != 0
    counts = np.bincount(t_of[b0], minlength=W)

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=p.device)

    rec = np.concatenate([np.concatenate(recs).astype(np.int32),
                          np.concatenate(facs).view(np.int32).reshape(-1, 2)],
                         1)
    tg.levels = SimpleNamespace(
        chunk=t(np.asarray(chunks, np.int64)), rows=t(np.asarray(rows)),
        rec=t(rec),
        b_ptr=t(np.concatenate([[0], np.cumsum(counts)])),
        b_u=t(tu[b0]), b_src=t(tsrc[b0, 0]),
        b_fac=t(tfac[b0, 0], torch.float64), nch=len(chunks))
    return tg.levels


def dbdd_tiles(p, K=64):
    """(rows of W per block, blocks per atom) of csrc/dbdd.cu at K neighbor
    slots (`dbdd_plan`)."""
    return dbdd_plan(p, K)[:2]


def dbdd_tables(p):
    """K3's compact y targets, cached on the plan: the (triple t, u) whose
    y_fac is nonzero in some layer, sorted by (t, u): tg_ptr (ntrip + 1)
    the targets of triple t, tg_u (nT,) their u, tg_src (nT, 3) and tg_fac
    (nT, 3) each layer's y_src and y_fac there (factor 0 for a layer that
    adds nothing).  y[w, u] (one channel; the layers of the row's channel
    in the chemflag mode) is the layer-order sum of tg_fac * z[tg_src]."""
    if p.k3 is not None:
        return p.k3
    src = p.y_src.cpu().numpy()
    fac = p.y_fac.cpu().numpy()
    t, u = np.nonzero((fac != 0).any(axis=0))
    i32 = torch.int32
    p.k3 = SimpleNamespace(
        slabs={}, levels=None,
        tg_ptr=torch.as_tensor(np.searchsorted(t, np.arange(p.ntriples + 1)),
                               dtype=i32, device=p.device),
        tg_u=torch.as_tensor(u, dtype=i32, device=p.device),
        tg_src=torch.as_tensor(np.ascontiguousarray(src[:, t, u].T),
                               dtype=i32, device=p.device),
        tg_fac=torch.as_tensor(np.ascontiguousarray(fac[:, t, u].T),
                               device=p.device))
    return p.k3


def dbdd_slab_ranges(p, slab):
    """The target ranges of K3's slab shape at `slab` columns, cached on
    the plan: for triple t and slab s (columns [s slab, (s + 1) slab) of
    2U), the targets whose real column u falls in it, then those whose
    imaginary column U + u does, as (first, end) ranges of t's u-sorted
    targets: (ntrip, nslab, 4) i32."""
    tg = dbdd_tables(p)
    if slab not in tg.slabs:
        ptr = tg.tg_ptr.cpu().numpy().astype(np.int64)
        u = tg.tg_u.cpu().numpy()
        U = p.u_len
        edges = np.arange(-(-2 * U // slab) + 1) * slab
        out = np.zeros((p.ntriples, len(edges) - 1, 4), np.int64)
        for t in range(p.ntriples):
            ut = u[ptr[t]:ptr[t + 1]]
            for part in (0, 1):
                cut = ptr[t] + np.searchsorted(
                    ut, np.clip(edges - part * U, 0, U))
                out[t, :, 2 * part] = cut[:-1]
                out[t, :, 2 * part + 1] = cut[1:]
        tg.slabs[slab] = torch.as_tensor(out.astype(np.int32),
                                         device=p.device)
    return tg.slabs[slab]


def dbdd_plain(ut, z_r, z_i, J, p):
    """Plain K3: (B (N, W), dBdD (N, W, K, 3))."""
    zcat = (z_r, z_i)
    dBdu = ops._dbdu_ylist(ut, p, zcat)
    B = ops._bispectrum_from_zcat(ut, zcat, p)
    return B, torch.einsum("awu,caku->awkc", dBdu, J)


def dbdd_chem_plain(ut, z_r, z_i, J, jelem, p):
    """Plain K3, chemflag mode: (B (N, W), dBdD (N, W, K, 3)) with
    dBdD[a, w, k] = dB/dutot[a, w, jelem[a, k]] . J[:, a, k], one channel's
    pairs at a time (the JAX form's one-hot einsum, without its
    (N, W, K, 2U) intermediate)."""
    B, dBdu = ops._chem_b_and_dbdu(ut, p, (z_r, z_i))
    dBdD = sum(torch.einsum("awu,caku->awkc", dBdu[:, :, n],
                            J * (jelem == n).to(J.dtype)[None, :, :, None])
               for n in range(p.nchem))
    return B, dBdD


def _dbdd_launch(ut, z_r, z_i, J, jelem, p):
    N, K = J.shape[1], J.shape[2]
    U, W, nc = p.u_len, p.nb_base, p.nchem
    dt = kl.float_type("dbdd", ut, z_r, z_i, J)
    _plan_type(p, dt, "dbdd")
    _check(ut, "ut", dt, (N, nc * 2 * U))
    zshape = (N, nc * nc, p.nz) if nc > 1 else (N, p.nz)
    _check(z_r, "z_r", dt, zshape)
    _check(z_i, "z_i", dt, zshape)
    _check(J, "J", dt, (3, N, K, 2 * U))
    if jelem is not None:
        _check(jelem, "jelem", torch.int32, (N, K))
    dev = ut.device
    bzero = p.bzero if p.bzeroflag else torch.zeros_like(p.bzero)
    B = torch.empty((N, W), dtype=dt, device=dev)
    dBdD = torch.empty((N, W, K, 3), dtype=dt, device=dev)
    if dbdd_shape(p, K) == "level":
        lv = dbdd_levels(p)
        KB, CT = dbdd_level_tiles(K)
        _launch("dbdd_level", dev, _ptr(ut), _ptr(z_r), _ptr(z_i), _ptr(J),
                _ptr(lv.chunk), _ptr(lv.rows), _ptr(lv.rec),
                _ptr(lv.b_ptr), _ptr(lv.b_u), _ptr(lv.b_src),
                _ptr(lv.b_fac), _ptr(bzero), N, K, W, U, p.nz, lv.nch,
                lv.rows.numel(), KB, CT, _ptr(B), _ptr(dBdD))
        SHAPE_LAUNCHES["dbdd_level"] += 1
        return B, dBdD
    mt, tiles, slab = dbdd_plan(p, K)
    tg = dbdd_tables(p)
    ranges = _ptr(dbdd_slab_ranges(p, slab)) if slab else None
    _launch(kl.entry("dbdd", dt), dev, _ptr(ut), _ptr(z_r), _ptr(z_i),
            _ptr(J),
            _ptr(jelem) if jelem is not None else None, _ptr(tg.tg_ptr),
            _ptr(tg.tg_u), _ptr(tg.tg_src), _ptr(tg.tg_fac), ranges,
            _ptr(p.y_src), _ptr(p.y_fac), _ptr(p.blk_chan),
            _ptr(p.blk_pair), _ptr(bzero), N, K, p.ntriples, U, p.nz, nc, mt,
            tiles, slab, _ptr(B), _ptr(dBdD))
    if slab:
        SHAPE_LAUNCHES["dbdd_slab"] += 1
    return B, dBdD


def dbdd(ut, z_r, z_i, J, p):
    """K3 on the card: ut (N, 2U), z_r, z_i (N, nz), J (3, N, K, 2U), all
    f64 or all f32 (the plan at their type; float32 in whole rows, to
    twojmax 12)."""
    if _on_cpu(ut, z_r, z_i, J):
        return dbdd_plain(ut, z_r, z_i, J, p)
    check_twojmax(p, "K3")
    _channels(p, False, "dbdd")
    out = _dbdd_launch(ut, z_r, z_i, J, None, p)
    kl.count(dbdd, ut.dtype)
    return out


def dbdd_chem(ut, z_r, z_i, J, jelem, p):
    """K3 on the card, chemflag mode: ut (N, nchem*2U), z_r, z_i (N,
    nchem^2, nz), J (3, N, K, 2U), jelem (N, K) int32 (the neighbors'
    elements, their utot channels)."""
    if _on_cpu(ut, z_r, z_i, J, jelem):
        return dbdd_chem_plain(ut, z_r, z_i, J, jelem, p)
    check_twojmax(p, "K3")
    _channels(p, True, "dbdd_chem")
    _check(ut, "ut", torch.float64, ut.shape, queue=kl.QUEUE_CHEM)
    out = _dbdd_launch(ut, z_r, z_i, J, jelem, p)
    dbdd_chem.launches += 1
    return out


dbdd.launches = 0
dbdd_chem.launches = 0


# ---------------------------------------------------------------------------
# K6q: the quadratic columns by the product rule
# ---------------------------------------------------------------------------


def quad_chain_plain(B, dBdD, p):
    """Plain K6q: (B_ext (N, W + nq), dBdD_ext (N, W + nq, K, 3))."""
    return ops._quad_chain(B, dBdD, p)


def quad_chain(B, dBdD, p):
    """K6q on the card: B (N, W), dBdD (N, W, K, 3) f64, W = nb_base."""
    if _on_cpu(B, dBdD):
        return quad_chain_plain(B, dBdD, p)
    check_twojmax(p, "K6q")
    N, W, K = dBdD.shape[:3]
    if not p.quadraticflag or W != p.nb_base:
        raise ValueError(f"quad_chain: width {W} is not the plan's base "
                         f"width {p.nb_base} with quadraticflag")
    _check(B, "B", torch.float64, (N, W), queue=kl.QUEUE_CHEM)
    _check(dBdD, "dBdD", torch.float64, (N, W, K, 3), queue=kl.QUEUE_CHEM)
    nq = p.iq1.shape[0]
    dev = B.device
    Bx = torch.empty((N, W + nq), dtype=torch.float64, device=dev)
    dBx = torch.empty((N, W + nq, K, 3), dtype=torch.float64, device=dev)
    _launch("quad_chain", dev, _ptr(B), _ptr(dBdD), _ptr(p.iq1),
            _ptr(p.iq2), _ptr(p.qcoef), N, W, nq, K * 3, _ptr(Bx),
            _ptr(dBx))
    quad_chain.launches += 1
    return Bx, dBx


quad_chain.launches = 0


# ---------------------------------------------------------------------------
# K4: force and virial rows from a per-pair gradient
# ---------------------------------------------------------------------------

_VIRIAL_PAIRS = ((0, 1, 2, 1, 0, 0), (0, 1, 2, 2, 2, 1))


def pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes,
                            gather_only=False):
    """Plain K4: (force (C, A, 3, T, X), virial (C, 6, T, X)).

    g (C, A, X, K, 3) per-pair gradients; disp (C, A, K, 3); vmask
    (C, A, K) pairs that enter the virial; rev (C, A, R) reverse neighbor
    table (flat slots i*K + k, -1 padded); types (C, A) source types.
    With `gather_only`, (minus the gathers alone, None): no own row sums
    and no virial.
    """
    C, A, X, K, _ = g.shape
    R = rev.shape[2]
    oh = torch.nn.functional.one_hot(types.long(), ntypes).to(g.dtype)
    typed = (oh[:, :, None, :, None, None]
             * g.permute(0, 1, 3, 2, 4)[:, :, :, None])   # (C, A, K, T, X, 3)
    width = ntypes * X * 3
    flat = torch.cat([typed.reshape(C, A * K, width),
                      g.new_zeros((C, 1, width))], 1)
    idx = torch.where(rev < 0, A * K, rev).long().reshape(C, A * R, 1)
    scat = torch.gather(flat, 1, idx.expand(C, A * R, width))
    scat = scat.reshape(C, A, R, ntypes, X, 3).sum(2)
    if gather_only:
        return (-scat).permute(0, 1, 4, 2, 3).contiguous(), None
    rows = typed.sum(2)
    force = (rows - scat).permute(0, 1, 4, 2, 3)
    dm = disp * vmask[..., None].to(disp.dtype)
    vir = -torch.einsum("cakp,caktxq->cpqtx", dm, typed)
    pa, pb = _VIRIAL_PAIRS
    return force.contiguous(), vir[:, list(pa), list(pb)].contiguous()


def pair_scatter_tile(X, K):
    """K4's x-tile: the columns of g one block takes, a power of two up to
    16 (csrc/pair_scatter.cu XT_MAX) whose own rows (XT x 3K doubles) stay
    within 24 KB of shared memory."""
    xt = 16 if X >= 16 else 1 << max(0, X - 1).bit_length()
    while xt > 1 and xt * 24 * K > 24 * 1024:
        xt //= 2
    return xt


def pair_scatter_rows(g, disp, vmask, rev, types, ntypes, gather_only=False):
    """K4 on the card; same arguments and outputs as the plain version, g
    and disp both f64 or both f32 (the outputs at their type; the halo's
    `gather_only` at float64 only)."""
    if _on_cpu(g, disp, vmask, rev, types):
        return pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes,
                                       gather_only)
    C, A, X, K, _ = g.shape
    R = rev.shape[2]
    dt = kl.float_type("pair_scatter_rows", g, disp)
    if gather_only:
        _check(g, "g", torch.float64, g.shape, queue=kl.QUEUE_SPATIAL)
    _check(g, "g", dt, (C, A, X, K, 3))
    _check(disp, "disp", dt, (C, A, K, 3))
    _check(vmask, "vmask", torch.bool, (C, A, K))
    _check(rev, "rev", torch.int32, (C, A, R))
    _check(types, "types", torch.int32, (C, A))
    dev = g.device
    force = torch.empty((C, A, 3, ntypes, X), dtype=dt, device=dev)
    virial = torch.empty((C, 6, ntypes, X), dtype=dt, device=dev)
    vpart = torch.empty((C, A, 6, X), dtype=dt, device=dev)
    _launch(kl.entry("pair_scatter_rows", dt), dev, _ptr(g), _ptr(disp),
            _ptr(vmask), _ptr(rev), _ptr(types), C, A, X, K, R, ntypes,
            pair_scatter_tile(X, K), int(gather_only), _ptr(vpart),
            _ptr(force), _ptr(virial))
    kl.count(pair_scatter_rows, dt)
    return force, None if gather_only else virial


pair_scatter_rows.launches = 0

# ---------------------------------------------------------------------------
# K5: the reference potential's energy, forces and virial
# ---------------------------------------------------------------------------

# LAMMPS pair_zbl universal screening function (the constants of
# csrc/zbl_pair.cu)
ZBL_C = (0.02817, 0.28022, 0.50986, 0.18175)
ZBL_D = (0.20162, 0.40290, 0.94229, 3.19980)
QQR2E = 14.399645      # eV A, LAMMPS metal units' qqr2e (csrc/zbl_pair.cu)
ZBL_ATOMS = 4          # atoms of a block of csrc/zbl_pair.cu, two warps each
_ZBL_TICKETS = {}      # device -> the kernel's per-config tickets (zero)


def bethe_slater(r, a, g, d):
    """The Bethe-Slater profile 4 a x2 (1 - g x2) exp(-x2), x2 = (r/d)^2,
    of `pair_style spin/exchange/biquadratic`."""
    x2 = (r / d) ** 2
    return 4.0 * a * x2 * (1.0 - g * x2) * torch.exp(-x2)


def zbl_pair_grad_plain(disp, jidx, mask, types, table, cut_inner,
                        cut_outer, charges=None, spins=None, extra=None):
    """The per-slot half of plain K5: (g (C, A, K, 3), energy (C,)).

    disp (C, A, K, 3) pair displacements; jidx, mask (C, A, K); types
    (C, A); table (T, T, 6) rows (pre, a, sw3, sw4, sw5, active) per type
    pair.  g = 0.5 e'(r) D / r per pair (zero for masked pairs), energy =
    0.5 sum e per config.  With `extra` (9,) (coul/cut's cutoff, then the
    spin term's cutoff, a, g, d of J, a, g, d of K, offset; the scalars of
    csrc/zbl_pair.cu's `Extra`), charges (C, A) add the bare Coulomb term
    to e and e' inside its cutoff, and unit spins (C, A, 3) the
    Bethe-Slater spin energy to e alone; either may be None.
    """
    C, A, K = mask.shape
    ti = types.long()[:, :, None].expand(C, A, K)
    jflat = jidx.long().reshape(C, A * K)
    tj = torch.gather(types.long(), 1, jflat)
    pre, a, sw3, sw4, sw5, active = table[ti, tj.reshape(C, A, K)].unbind(-1)
    safe = torch.where(mask[..., None], disp,
                       disp.new_tensor([1.0, 0.0, 0.0]))
    r = torch.sqrt(torch.sum(safe * safe, -1))
    c = disp.new_tensor(ZBL_C)
    d = disp.new_tensor(ZBL_D)
    ex = torch.exp(-d * (r / a)[..., None])
    phi = torch.sum(c * ex, -1)
    dphi = -torch.sum(c * d * ex, -1) / a
    e = pre / r * phi + sw5
    de = pre * (-phi / (r * r) + dphi / r)
    t = r - cut_inner
    inner = r > cut_inner
    zero = torch.zeros_like(r)
    e = e + torch.where(inner, t * t * t * (sw3 + sw4 * t), zero)
    de = de + torch.where(inner, t * t * (3.0 * sw3 + 4.0 * sw4 * t), zero)
    on = mask & (r < cut_outer) & (active != 0)
    e = torch.where(on, e, zero)
    de = torch.where(on, de, zero)
    if charges is not None:
        qj = torch.gather(charges, 1, jflat).reshape(C, A, K)
        eq = QQR2E * (charges[:, :, None] * qj) / r
        qon = mask & (r < extra[0])
        e = e + torch.where(qon, eq, zero)
        de = de + torch.where(qon, -eq / r, zero)
    if spins is not None:
        sj = torch.gather(spins, 1, jflat[..., None].expand(C, A * K, 3))
        dots = torch.einsum("cax,cakx->cak", spins, sj.reshape(C, A, K, 3))
        es = -(bethe_slater(r, extra[2], extra[3], extra[4])
               * (dots - extra[8])
               + bethe_slater(r, extra[5], extra[6], extra[7])
               * (dots * dots - extra[8]))
        e = e + torch.where(mask & (r < extra[1]), es, zero)
    g = (0.5 * de / r)[..., None] * safe
    return g, 0.5 * e.sum(dim=(1, 2))


def zbl_eav_plain(disp, jidx, mask, rev, types, table, cut_inner,
                  cut_outer, charges=None, spins=None, extra=None):
    """Plain K5: (energy (C,), force (C, A, 3), virial (C, 6)), the
    per-slot gradient of `zbl_pair_grad_plain` turned into forces and
    virial by K4's plain version at width 1 with one type block.

    rev (C, A, R) is the reverse neighbor table (flat slots i*K + k whose
    jidx is the row's atom, -1 padded); the virial is ordered (xx, yy, zz,
    yz, xz, xy), W_ab = -sum D_a g_b over the masked slots.  charges,
    spins and extra as `zbl_pair_grad_plain`'s (the spin term adds energy
    alone)."""
    C, A = mask.shape[:2]
    g, energy = zbl_pair_grad_plain(disp, jidx, mask, types, table,
                                    cut_inner, cut_outer, charges, spins,
                                    extra)
    force, virial = pair_scatter_rows_plain(g[:, :, None], disp, mask, rev,
                                            torch.zeros_like(types), 1)
    return energy, force.reshape(C, A, 3), virial.reshape(C, 6)


def _zbl_tickets(device, C):
    """The kernel's per-config tickets on `device`, at least C of them:
    zero when allocated, and left zero by every launch."""
    t = _ZBL_TICKETS.get(device)
    if t is None or t.numel() < C:
        t = torch.zeros((max(C, 64),), dtype=torch.int32, device=device)
        _ZBL_TICKETS[device] = t
    return t


def zbl_eav(disp, jidx, mask, rev, types, table, cut_inner, cut_outer,
            charges=None, spins=None, extra=None):
    """K5 on the card; same arguments and outputs as the plain version.
    Without `extra` it launches the ZBL-only entry point (zbl_eav, at
    float64 or float32: disp and table at one type, the outputs at it),
    with it the whole reference (ref_eav, float64 only)."""
    if _on_cpu(disp, jidx, mask, rev, types, table,
               *(x for x in (charges, spins, extra) if x is not None)):
        return zbl_eav_plain(disp, jidx, mask, rev, types, table,
                             cut_inner, cut_outer, charges, spins, extra)
    C, A, K = mask.shape
    R, T = rev.shape[2], table.shape[0]
    dt = kl.float_type("zbl_eav", disp, table)
    if extra is not None:
        _check(disp, "disp", torch.float64, disp.shape, queue=kl.QUEUE_CHEM)
    _check(disp, "disp", dt, (C, A, K, 3))
    _check(jidx, "jidx", torch.int32, (C, A, K))
    _check(mask, "mask", torch.bool, (C, A, K))
    _check(rev, "rev", torch.int32, (C, A, R))
    _check(types, "types", torch.int32, (C, A))
    _check(table, "table", dt, (T, T, 6))
    if extra is None and (charges is not None or spins is not None):
        raise ValueError("zbl_eav: charges and spins need `extra`")
    if extra is not None:
        _check(extra, "extra", torch.float64, (9,))
    if charges is not None:
        _check(charges, "charges", torch.float64, (C, A))
    if spins is not None:
        _check(spins, "spins", torch.float64, (C, A, 3))
    dev = disp.device
    if C * A == 0:
        return (disp.new_zeros(C), disp.new_zeros((C, A, 3)),
                disp.new_zeros((C, 6)))
    bpc = -(-A // ZBL_ATOMS)
    part = torch.empty((C * bpc, 7), dtype=dt, device=dev)
    energy = torch.empty((C,), dtype=dt, device=dev)
    force = torch.empty((C, A, 3), dtype=dt, device=dev)
    virial = torch.empty((C, 6), dtype=dt, device=dev)
    head = (_ptr(disp), _ptr(jidx), _ptr(mask), _ptr(rev), _ptr(types),
            _ptr(table))
    tail = (C, A, K, R, T, float(cut_inner), float(cut_outer), _ptr(part),
            _ptr(_zbl_tickets(dev, C)), _ptr(energy), _ptr(force),
            _ptr(virial))
    if extra is None:
        _launch(kl.entry("zbl_eav", dt), dev, *head, *tail)
    else:
        _launch("ref_eav", dev, *head,
                *(None if x is None else _ptr(x)
                  for x in (charges, spins)), _ptr(extra), *tail)
    kl.count(zbl_eav, dt)
    return energy, force, virial


zbl_eav.launches = 0

# ---------------------------------------------------------------------------
# K8: neighbor lists on the device; K8r: their reverse table
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _neighbor_args(pos_hi, svec_hi, k_pad):
    C, A, _ = pos_hi.shape
    S = svec_hi.shape[1]
    if k_pad > S * A:
        raise ValueError(f"device_neighbors: k_pad {k_pad} exceeds the "
                         f"{S} x {A} candidates")
    return C, A, S


def device_neighbors_plain(pos_hi, pos_lo, svec_hi, svec_lo, natoms, cutoff,
                           k_pad):
    """Plain K8: (disp (C, A, K, 3), jidx (C, A, K) int32, mask (C, A, K)).

    pos_hi, pos_lo (C, A, 3) and svec_hi, svec_lo (C, S, 3) are hi/lo
    parts of the positions and image shift vectors; natoms (C,).  The K
    slots of atom i take the candidates pos_j + svec_s (flat index s*A + j)
    in increasing (d2, index) order, valid ones first; a stable descending
    sort of -d2 gives the order of `jax.lax.top_k`.
    """
    C, A, S = _neighbor_args(pos_hi, svec_hi, k_pad)
    cand = pos_hi[:, None, :, :] + svec_hi[:, :, None, :]      # (C, S, A, 3)
    diff = cand[:, None] - pos_hi[:, :, None, None, :]          # (C,A,S,A,3)
    dx, dy, dz = diff.unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    idx = torch.arange(A, device=pos_hi.device)
    real = idx[None, :] < natoms[:, None]                      # (C, A)
    home = ((svec_hi == 0) & (svec_lo == 0)).all(-1)           # (C, S)
    self_pair = home[:, None, :, None] & (idx[:, None, None]
                                          == idx[None, None, :])[None]
    valid = ((d2 < cutoff * cutoff) & real[:, None, None, :]
             & real[:, :, None, None] & ~self_pair)
    score = torch.where(valid, -d2, torch.full_like(d2, -torch.inf))
    vals, order = torch.sort(score.reshape(C, A, S * A), dim=-1,
                             descending=True, stable=True)
    mask = vals[..., :k_pad] > -torch.inf
    order = order[..., :k_pad]
    s_sel, j_sel = order // A, order % A
    c = torch.arange(C, device=pos_hi.device)[:, None, None]
    s1, e1 = two_sum(svec_hi[c, s_sel], pos_hi[c, j_sel])
    s2, e2 = two_sum(s1, -pos_hi[:, :, None, :])
    lo = svec_lo[c, s_sel] + pos_lo[c, j_sel] - pos_lo[:, :, None, :]
    disp = s2 + (e1 + e2 + lo)
    disp = torch.where(mask[..., None], disp,
                       disp.new_tensor([1.0, 0.0, 0.0]))
    return disp, j_sel.to(torch.int32), mask


# K8 (csrc/device_neighbors.cu): the bin side over the cutoff (a margin
# over it, so a neighbor lies within one bin of its atom); the pairs a
# warp's buffer holds in shared memory (K above half of it keeps each
# atom's buffer in global scratch); the most atom slots and image shifts of
# its fused shape (a config's sorted atoms and shifts in each block's
# shared memory; more run the split shape, a bin pass into global scratch,
# then the select pass).  These choices are made here alone: the entry
# point runs the shape and buffers it is given, and refuses only what does
# not fit a block.
K8_BIN_SIDE = 1.0 + 2.0 ** -20
K8_BIN_SIDE_F32 = 1.0 + 2.0 ** -10   # the float32 grid's (csrc: the margin)
K8_BUF = 256
K8_FUSED_ATOMS = 1024
K8_FUSED_SHIFTS = 512


def k8_bins(A):
    """H, the most bins K8's grid of one config of A atom slots may have:
    2 A + 64 (a bcc cell of 128 Ta atoms needs 27 bins of the cutoff's
    side, one of 1,024 atoms 216), at least 64 (a grid the side can always
    grow into) and at most 16,384.  A config that would need more bins gets
    larger ones; only the shapes decide H, so the host never waits on the
    card for it."""
    return max(64, min(2 * A + 64, 16384))


def k8_grid(pos_hi, natoms, cutoff, H, dtype=np.float64):
    """K8's bin grid of one config, op for op as its bin pass computes it:
    (origin (3,), 1 / side, bins an axis (3,) int) over the home atoms
    pos_hi[:natoms] (numpy at `dtype`, the positions' type: float64 with
    side cutoff K8_BIN_SIDE, float32 with K8_BIN_SIDE_F32; each operation
    rounds as the kernel's __dsub_rn / __dmul_rn / __ddiv_rn, or their
    float32 twins, do)."""
    dt = np.dtype(dtype).type
    p = np.asarray(pos_hi, dt)[:natoms]
    lo, hi = p.min(0), p.max(0)

    def bins(inv):
        return np.floor((hi - lo) * inv) + dt(1.0)

    # the wrapper's side and 1 / side, at float64, rounded to the type
    side = cutoff * (K8_BIN_SIDE_F32 if dt is np.float32 else K8_BIN_SIDE)
    side, inv = dt(side), dt(1.0 / side)
    n = bins(inv)
    if np.prod(n.astype(np.float64)) > H:
        m = 4
        while (m + 1) ** 3 <= H:
            m += 1
        side = max(side, (hi - lo).max() / (dt(m) - dt(1.5)))
        inv = dt(1.0) / side
        n = bins(inv)
    return lo, inv, n.astype(np.int64)


def k8_bin_coords(points, grid):
    """The bin coordinates (..., 3) float of points (..., 3) on a
    `k8_grid`, as K8 computes them: floor((x - origin) * (1 / side))."""
    origin, inv, _ = grid
    return np.floor((np.asarray(points, origin.dtype) - origin) * inv)


def k8_near_bins(points, grid):
    """The bins K8 searches for query points (..., 3) (an atom's position
    less an image shift): (lo, hi) coordinates (..., 3), one bin around
    the point's, clipped to the grid; empty where lo > hi."""
    b = k8_bin_coords(points, grid)
    return np.maximum(b - 1, 0), np.minimum(b + 1, grid[2] - 1)


def device_neighbors(pos_hi, pos_lo, svec_hi, svec_lo, natoms, cutoff,
                     k_pad):
    """K8 on the card; same arguments and outputs as the plain version
    (natoms int32), at float64 or float32 (the hi/lo float32 pairs of
    `pack_batch_pos(..., dtype=np.float32)`; disp comes out float32).  One
    launch for A <= K8_FUSED_ATOMS and S <= K8_FUSED_SHIFTS, else two (the
    bin pass, then the select pass).  The scratch comes from here, at the
    positions' type: the split shape's grids, bin ranges and sorted atoms,
    and for k_pad above K8_BUF / 2 each atom's buffer of pairs and bitmap
    of valid indices."""
    C, A, S = _neighbor_args(pos_hi, svec_hi, k_pad)
    if _on_cpu(pos_hi, pos_lo, svec_hi, svec_lo, natoms):
        return device_neighbors_plain(pos_hi, pos_lo, svec_hi, svec_lo,
                                      natoms, cutoff, k_pad)
    dt = kl.float_type("device_neighbors", pos_hi, pos_lo, svec_hi, svec_lo)
    for t, name, shape in ((pos_hi, "pos_hi", (C, A, 3)),
                           (pos_lo, "pos_lo", (C, A, 3)),
                           (svec_hi, "svec_hi", (C, S, 3)),
                           (svec_lo, "svec_lo", (C, S, 3))):
        _check(t, name, dt, shape)
    _check(natoms, "natoms", torch.int32, (C,))
    if S * A > 2 ** 31 - 1:
        raise ValueError(f"device_neighbors: {S} x {A} candidates exceed "
                         f"the int32 flat index of a slot")
    dev = pos_hi.device
    H = k8_bins(A)
    side = float(cutoff) * (K8_BIN_SIDE_F32 if dt == torch.float32
                            else K8_BIN_SIDE)

    def scratch(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    buf, gbuf_d, gbuf_f, gbits = K8_BUF, None, None, None
    if k_pad > K8_BUF // 2:
        buf = -(-(2 * k_pad + 128) // 32) * 32
        gbuf_d = scratch((C * A, buf), dt)
        gbuf_f = scratch((C * A, buf), torch.int32)
        gbits = scratch((C * A, (2 * k_pad + 31) // 32), torch.int32)
    grids = bins = srt = None
    if A > K8_FUSED_ATOMS or S > K8_FUSED_SHIFTS:
        # 48 bytes a config's grid, 4 values an atom of the sorted atoms
        grids = scratch((C, 48 // dt.itemsize), dt)
        bins = scratch((C, H + 1), torch.int32)
        srt = scratch((C, A, 4), dt)
    disp = scratch((C, A, k_pad, 3), dt)
    jidx = scratch((C, A, k_pad), torch.int32)
    mask = scratch((C, A, k_pad), torch.bool)
    opt = [None if t is None else _ptr(t)
           for t in (gbuf_d, gbuf_f, gbits, grids, bins, srt)]
    _launch(kl.entry("device_neighbors", dt), dev, _ptr(pos_hi),
            _ptr(pos_lo), _ptr(svec_hi), _ptr(svec_lo), _ptr(natoms), C, A,
            S, k_pad, H, float(cutoff), side, 1.0 / side, buf, *opt,
            _ptr(disp), _ptr(jidx), _ptr(mask))
    kl.count(device_neighbors, dt)
    return disp, jidx, mask


device_neighbors.launches = 0


def reverse_table_plain(jidx, mask):
    """Plain K8r: (rev (C, A, K) int32, dropped (C,) int32).

    Row n of rev lists the flat slots i*K + k with mask[i, k] and
    jidx[i, k] == n, in increasing order, padded with -1; `dropped` counts
    the entries of each config past the width K (0 for full symmetric
    lists).
    """
    C, A, K = mask.shape
    dev = mask.device
    dest = torch.where(mask, jidx.long(), A).reshape(C, A * K)
    sdest, slots = torch.sort(dest, dim=1, stable=True)
    counts = torch.zeros((C, A + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, dest, torch.ones_like(dest))
    start = torch.cumsum(counts, 1) - counts
    col = torch.arange(A * K, device=dev)[None] - torch.gather(start, 1,
                                                               sdest)
    keep = (sdest < A) & (col < K)
    rev = torch.full((C, A, K), -1, dtype=torch.int32, device=dev)
    cidx = torch.arange(C, device=dev)[:, None].expand(C, A * K)
    rev[cidx[keep], sdest[keep], col[keep]] = slots[keep].to(torch.int32)
    dropped = (counts[:, :A] - K).clamp(min=0).sum(1).to(torch.int32)
    return rev, dropped


def reverse_table(jidx, mask):
    """K8r on the card; same arguments and outputs as the plain version."""
    if _on_cpu(jidx, mask):
        return reverse_table_plain(jidx, mask)
    C, A, K = mask.shape
    _check(jidx, "jidx", torch.int32, (C, A, K))
    _check(mask, "mask", torch.bool, (C, A, K))
    dev = mask.device
    rev = torch.empty((C, A, K), dtype=torch.int32, device=dev)
    dropped = torch.zeros((C,), dtype=torch.int32, device=dev)
    _launch("reverse_table", dev, _ptr(jidx), _ptr(mask), C, A, K, K,
            _ptr(rev), _ptr(dropped))
    reverse_table.launches += 1
    return rev, dropped


reverse_table.launches = 0

# ---------------------------------------------------------------------------
# K7: weighted normal equations of a batch
# ---------------------------------------------------------------------------

_NC_TILE = 64          # edge of an output tile of csrc/normal_contrib.cu
_NC_CHUNK = 16         # rows of one staged chunk there (KC)
_NC_SLAB = 8           # chunks of a slab at the least
_NC_BLOCKS = 2 * 132   # blocks that fill the card: two on each of 132 SMs


def normal_contrib_plan(C, A, W, with_ata=True):
    """K7's tile plan for C configs of A atom slots and full width W:
    (output tiles, row slabs, rows per slab).  The tiles cover the upper
    triangle of the (W + 1)^2 Gram matrix (with `with_ata`; else only its
    last column); the rows split into slabs until about `_NC_BLOCKS` blocks
    run, each slab at least `_NC_SLAB` chunks of `_NC_CHUNK` rows."""
    nt = -(-(W + 1) // _NC_TILE)
    ntiles = nt * (nt + 1) // 2 if with_ata else nt
    chunks = -(-C * (7 + 3 * A) // _NC_CHUNK)
    nslab = max(1, min(-(-_NC_BLOCKS // ntiles), chunks // _NC_SLAB))
    return ntiles, nslab, -(-chunks // nslab) * _NC_CHUNK


def full_rows(rows, truths, natoms, types, numtypes, const_cols,
              layout="snap"):
    """Full rows (C, 1 + 3A + 6, W) and right-hand sides (C, 1 + 3A + 6).

    rows: the rows function's dict (e_cols, force_rows, virial_rows, ref_e,
    ref_f, ref_v); truths: (energy (C,), forces (C, A, 3), stress6 (C, 6)).
    With `const_cols`, the rows gain one constant column per type: the
    type's atom fraction on the energy row, zero on the force and virial
    rows.  In the "snap" layout each of the `numtypes` blocks of the raw
    width leads with its type's column; in the "ace" layout (one block of
    element-resolved labels) the `numtypes` columns lead the row.
    """
    energy, forces, stress6 = truths
    C, A = types.shape
    dt = rows["e_cols"].dtype
    real = (torch.arange(A, device=types.device)[None, :]
            < natoms[:, None]).to(dt)
    nat = natoms.clamp(min=1).to(dt)
    e_row = rows["e_cols"] / nat[:, None]
    f_rows = rows["force_rows"].reshape(C, 3 * A, -1)
    v_rows = rows["virial_rows"]
    if layout not in ("snap", "ace"):
        raise ValueError(f"unknown constant-column layout {layout!r}")
    if const_cols:
        T = numtypes
        counts = (torch.nn.functional.one_hot(types.long(), T).to(dt)
                  * real[..., None]).sum(1) / nat[:, None]

        def lead(block, first):
            shp = block.shape[:-1]
            if layout == "ace":
                return torch.cat([first.reshape(shp + (T,)), block], -1)
            return torch.cat([first.reshape(shp + (T, 1)),
                              block.reshape(shp + (T, -1))], -1) \
                .reshape(shp + (-1,))

        e_row = lead(e_row, counts)
        f_rows = lead(f_rows, f_rows.new_zeros(C, 3 * A, T))
        v_rows = lead(v_rows, v_rows.new_zeros(C, 6, T))
    a = torch.cat([e_row[:, None], f_rows, v_rows], 1)
    b = torch.cat([((energy - rows["ref_e"]) / nat)[:, None],
                   (forces - rows["ref_f"]).reshape(C, 3 * A),
                   stress6 - rows["ref_v"]], 1)
    return a, b


def row_weights(weights, natoms, num_atoms, flags):
    """Weight of each full row of `full_rows`, (C, 1 + 3A + 6).

    weights: (eweight, fweight, vweight) per config; flags: {"energy",
    "force", "stress"} row kinds to include.  Rows of padded atoms and of
    padded configs (natoms 0) weigh zero; with unit weights this is the
    0/1 mask of the rows that count.
    """
    ew, fw, vw = weights
    C = natoms.shape[0]
    live = (natoms > 0).to(ew.dtype)
    real = (torch.arange(num_atoms, device=natoms.device)[None, :]
            < natoms[:, None]).to(ew.dtype)
    fe, ff, fs = (float(bool(flags[k])) for k in ("energy", "force",
                                                    "stress"))
    return torch.cat([(ew * live * fe)[:, None],
                      (fw * live * ff)[:, None] * real.repeat_interleave(3, 1),
                      (vw * live * fs)[:, None].expand(C, 6)], 1)


def normal_contrib_plain(rows, truths, weights, natoms, types, numtypes,
                         const_cols, flags, coeff=None, with_ata=True,
                         layout="snap"):
    """Plain K7: (AtA (W, W), Atb (W,), nrows ()) of a batch.

    rows, truths, const_cols, layout: as for `full_rows`; weights, flags:
    as for `row_weights`; all float64, or all float32 (the JAX package's
    accelerator rows, `parallel/fit.py:323-363` there).  The rows, truths
    and weights are formed at their type and widened only then: AtA and
    Atb come out float64.  With `coeff` (float64), b is replaced by the
    residual b - a . coeff, formed at float64 and rounded to the rows'
    type, and Atb comes out at the rows' type (AtA zero), as the JAX
    refinement pass computes it; nrows is float64.
    """
    a, b = full_rows(rows, truths, natoms, types, numtypes, const_cols,
                     layout)
    A = types.shape[1]
    w = row_weights(weights, natoms, A, flags)
    if coeff is None:
        a, b, w = (x.to(torch.float64) for x in (a, b, w))
    else:
        b = (b.to(coeff.dtype) - a.to(coeff.dtype) @ coeff).to(a.dtype)
    aw = a * w[..., None]
    bw = b * w
    W = a.shape[2]
    AtA = torch.einsum("crp,crq->pq", aw, aw) if with_ata \
        else a.new_zeros((W, W))
    ones = torch.ones_like(weights[0])
    nrows = row_weights((ones, ones, ones), natoms, A, flags) \
        .to(torch.float64).sum()
    return AtA, torch.einsum("crp,cr->p", aw, bw), nrows


def normal_contrib(rows, truths, weights, natoms, types, numtypes,
                   const_cols, flags, coeff=None, with_ata=True,
                   layout="snap"):
    """K7 on the card; same arguments and outputs as the plain version
    (natoms and types int32): the rows, truths and weights all float64 or
    all float32 (coeff float64)."""
    tensors = [rows[k] for k in ("e_cols", "force_rows", "virial_rows",
                                 "ref_e", "ref_f", "ref_v")]
    tensors += list(truths) + list(weights) + [natoms, types]
    if coeff is not None:
        tensors.append(coeff)
    if _on_cpu(*tensors):
        return normal_contrib_plain(rows, truths, weights, natoms, types,
                                    numtypes, const_cols, flags, coeff,
                                    with_ata, layout)
    if layout not in ("snap", "ace"):
        raise ValueError(f"unknown constant-column layout {layout!r}")
    C, A = types.shape
    T = numtypes
    Wr = rows["e_cols"].shape[1]
    W = Wr + (T if const_cols else 0)
    shapes = ((C, Wr), (C, A, 3, Wr), (C, 6, Wr), (C,), (C, A, 3), (C, 6),
              (C,), (C, A, 3), (C, 6), (C,), (C,), (C,))
    names = ("e_cols", "force_rows", "virial_rows", "ref_e", "ref_f",
             "ref_v", "energy", "forces", "stress6", "eweight", "fweight",
             "vweight")
    dt = kl.float_type("normal_contrib", *tensors[:12])
    for t, name, shape in zip(tensors, names, shapes):
        _check(t, name, dt, shape)
    _check(natoms, "natoms", torch.int32, (C,))
    _check(types, "types", torch.int32, (C, A))
    if coeff is not None:
        _check(coeff, "coeff", torch.float64, (W,))
    dev = types.device
    ntiles, nslab, slab_rows = normal_contrib_plan(C, A, W, with_ata)
    nt = -(-(W + 1) // _NC_TILE)
    if nslab * slab_rows * nt * _NC_TILE >= 1 << 31:
        raise ValueError(f"normal_contrib: {C} configs of {A} atoms at width "
                         f"{W} exceed 2^31 row entries; pass fewer configs "
                         f"per chunk")
    # the weighted augmented rows, padded to whole slabs and tiles
    aw = torch.empty((nslab * slab_rows, nt * _NC_TILE), dtype=torch.float64,
                     device=dev)
    # the slabs' partial tiles (with one slab the tiles go out directly)
    partial = torch.empty((ntiles * nslab if nslab > 1 else 0, _NC_TILE,
                           _NC_TILE), dtype=torch.float64, device=dev)
    # without AtA the kernel writes Atb only, and AtA is zero; float32 rows'
    # residual mode writes A^T r at float32 (the rows' type), and needs
    # each row's weight as scratch
    bt = dt if coeff is not None else torch.float64
    AtA = (torch.empty if with_ata else torch.zeros)(
        (W, W), dtype=bt, device=dev)
    Atb = torch.empty((W,), dtype=bt, device=dev)
    nrows = torch.empty((), dtype=torch.float64, device=dev)
    extra = []
    if dt == torch.float32:
        extra = [_ptr(torch.empty((nslab * slab_rows,), dtype=dt,
                                  device=dev)) if coeff is not None
                 else None]
    _launch(kl.entry("normal_contrib", dt), dev,
            *[_ptr(t) for t in tensors[:14]],
            _ptr(coeff) if coeff is not None else None, C, A, T, Wr, W,
            0 if not const_cols else (2 if layout == "ace" else 1),
            int(bool(flags["energy"])),
            int(bool(flags["force"])), int(bool(flags["stress"])),
            int(bool(with_ata)), _NC_TILE, ntiles, nslab, slab_rows,
            _ptr(aw), _ptr(partial), _ptr(AtA), _ptr(Atb), _ptr(nrows),
            *extra)
    kl.count(normal_contrib, dt)
    return AtA, Atb, nrows


normal_contrib.launches = 0

KERNELS = (pair_u_duals, zlist, dbdd, pair_scatter_rows, zbl_eav,
           normal_contrib, device_neighbors, reverse_table, pair_u_duals_chem,
           zlist_chem, dbdd_chem, quad_chain)
# the kernels with a float32 instantiation: their float32 launches also
# count apart (`launches_f32`), reported as "<name>_f32" by `launches`
F32_KERNELS = (pair_u_duals, zlist, dbdd, pair_scatter_rows, zbl_eav,
               normal_contrib, device_neighbors)
for _k in F32_KERNELS:
    _k.launches_f32 = 0


# launches of the shapes of K1 and K3 past twojmax 12, by entry point
# (inside their wrappers' counts): K1's recursion shape, K3's level and
# slab shapes
SHAPE_LAUNCHES = dict.fromkeys(("pair_u_recur", "dbdd_level", "dbdd_slab"),
                               0)


def reset_launches():
    """Set every kernel's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
    for k in F32_KERNELS:
        k.launches_f32 = 0
    for k in SHAPE_LAUNCHES:
        SHAPE_LAUNCHES[k] = 0


def shape_launches():
    """{entry point: launches since the last reset} of K1's and K3's
    shapes past twojmax 12 (`SHAPE_LAUNCHES`)."""
    return dict(SHAPE_LAUNCHES)


def launches():
    """{kernel name: float64 launches since the last reset}, and
    {"<name>_f32": float32 launches} of the kernels with a float32
    instantiation."""
    out = {k.__name__: k.launches for k in KERNELS}
    for k in F32_KERNELS:
        out[k.__name__] -= k.launches_f32
        out[k.__name__ + "_f32"] = k.launches_f32
    return out
