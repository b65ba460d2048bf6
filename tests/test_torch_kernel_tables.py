"""The host tables of K1 (pair_u_duals) and K2 (zlist) against the JAX
package's plan (CPU, float64).

- K1's column entries rebuild, exactly, the change of basis L of the JAX
  package's numpy-only `fitsnap_tpu/ops/mono.py:mono_plan` and its four
  partials L_v[m, u] = (e_v(m) + 1) L[m + e_v, u], at twojmax 2, 6 and 10;
  each split plan covers every column once, in chunks of at most 4, and
  its steps, read through the splits' windows, rebuild the same matrices.
- K2's schedule rebuilds, exactly, the z terms of the JAX package's plan
  (`fitsnap_tpu/ops/cg.build_snap_plan`'s grouped term tables) at twojmax
  2, 6 and 10: the same (output, i1, i2, coefficient) terms, the zero
  outputs those without a term, groups of equal-ish term counts.
- The kernels' schedules, run in numpy over these tables (the arithmetic
  of csrc/pair_u_duals.cu and csrc/zlist.cu), agree with the plain twins
  at twojmax 2 and 6, one channel and chemflag, at 1e-12; and the plain
  twins agree with the JAX functions at 1e-12 (relative to the largest
  magnitude of each array: the packages sum in different orders).
- The dealt schedules of `nn_tables` (`ops/snap.deal`) at twojmax 2, 6
  and 10: K10T's rebuilds the (t, u, src, fac) entries of `yt_*` exactly
  and K10's those of `yu_*`, each group's (descriptor, U column) on its
  own threads, at most `per` a thread, dealt in compact z order; K9's
  rebuilds the (i1, i2, i3, c) terms of `bt_*` exactly, and `bt_*` the
  plan's B terms (each channel triple's block of i1, i2, i3 with `mmat`),
  one channel and chemflag (two and three elements, wselfallflag 0 and 1,
  bzeroflag and bnormflag); the referenced z
  entries `yz_src` list every src of those entries once, sorted; each
  schedule, run in numpy (the arithmetic of csrc/nn_dedu.cu and
  csrc/nn_grid.cu), agrees with its plain twin (`nn_dedu_vg_t_plain`,
  `nn_dedu_vg_plain`, `nn_ut_b_plain`, K9's also on the chemflag plans) at
  1e-12; and K9, K10 and K10T
  launch with their schedules' `threads`, whose narrow launch bounds hold
  four blocks of the schedules' block an SM.
- Past twojmax 12: K1's recursion shape, its schedule run in numpy in the
  kernel's order (csrc/pair_u_duals.cu `pair_u_recur`), against the JAX
  package's `compute_ulist_duals` and `_utot_from_wu` at twojmax 2-8 (one
  channel and chemflag, wselfallflag 0 and 1, one to four level splits)
  and against the plain version at twojmax 13, 14 and 16, its coefficients
  against `rootpq_tables`, its splits and channel caps; K3's level shape,
  its plan's layout and its schedule in torch (csrc/dbdd.cu `dbdd_level`)
  against the plain version at twojmax 13 and 14 and against JAX's
  `_dbdu_ylist` and contraction at twojmax 2 and 6; K3's slab shape; the
  planners' choices; every SNAP wrapper's twojmax limit.
"""

import re
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.ops import mono as jmono
from fitsnap_tpu.ops import snap as jsnap
from fitsnap_tpu.ops.cg import build_snap_plan
from fitsnap_tpu_torch.convert import (PARAM_FIELDS, PLAN_FIELDS,
                                       snap_params_from_numpy)
from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import snap as tsnap

RTOL = 1e-12


def close(port, ref, rtol=RTOL):
    port = np.asarray(port.cpu() if torch.is_tensor(port) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"relative error {err:.3e}"


@lru_cache(maxsize=None)
def plans(twojmax, nelem=1, chem=False, wself=False, bnorm=False,
          bzero=True):
    """(JAX SnapParams, the port's SnapParams on the CPU)."""
    plan = build_snap_plan(twojmax=twojmax, nelements=nelem, chemflag=chem,
                           bzeroflag=bzero, wselfallflag=wself,
                           bnormflag=bnorm)
    jp = jsnap.SnapParams(
        plan=plan, rcutfac=4.6, rfac0=0.99, rmin0=0.0, switchflag=True,
        switchinnerflag=False, wj=np.array([1.0, 0.93, 0.8][:nelem]),
        radelem=np.array([0.5, 0.45, 0.4][:nelem]))
    d = {k: getattr(plan, k) for k in PLAN_FIELDS}
    d.update({k: getattr(jp, k) for k in PARAM_FIELDS})
    return jp, snap_params_from_numpy(d, "cpu")


def block(seed, nelem, A=6, K=40):
    """(disp, jelem, mask, ielem): masked pairs, an atom with every slot
    masked, and an atom with more than one tile (32) of live pairs."""
    rng = np.random.default_rng(seed)
    disp = rng.normal(size=(A, K, 3))
    disp *= rng.uniform(1.2, 4.4, (A, K, 1)) / np.linalg.norm(
        disp, axis=-1, keepdims=True)
    mask = rng.uniform(size=(A, K)) < 0.7
    mask[0] = True
    mask[-1] = False
    jelem = rng.integers(0, nelem, (A, K)).astype(np.int32)
    ielem = rng.integers(0, nelem, A).astype(np.int32)
    return disp, jelem, mask, ielem


def f64(words):
    """The doubles stored in (n, 2) int32 words."""
    return np.ascontiguousarray(words).view(np.float64)[:, 0]


def numpy_tables(pl, p):
    t = {k: getattr(pl, k).numpy() for k in (
        "blob", "loc", "cw_ptr", "win_ptr", "win_exp", "zr_ptr", "zruns")}
    t["row_stride"] = sk._k1_row_stride(p.nchem)
    return t


def chunk_steps(t, k):
    """(first column, columns, the header's unused pair, [(column
    of the chunk, accumulator, coefficients (4,), window slots (4,),
    offsets modulo the row stride) per step]) of chunk row k."""
    first, size = t["loc"][k]
    piece = t["blob"][first:first + size]
    u0, n, sc, ncr, *ends = piece[:12].view(np.int32)
    assert size == 12 + 5 * ends[-1] + ends[-1] % 2
    st = piece[12:12 + 5 * ends[-1]].reshape(-1, 5)
    offs = np.ascontiguousarray(st[:, 4]).view(np.uint16).reshape(-1, 4)
    offs = offs.astype(np.int64)
    run = np.searchsorted(np.asarray(ends), np.arange(ends[-1]), "right")
    ms = t["row_stride"]
    return u0, n, (sc, ncr), list(zip(run // 5, run % 5, st[:, :4],
                                      offs // ms, offs % ms))


def column_levels(p):
    """The degree level j of every U column (real, then imaginary)."""
    U = p.u_len
    level = np.zeros(2 * U, np.int64)
    for j, (_, _, c0, c1) in enumerate(sk._k1_columns(p).blocks):
        level[c0:c1] = level[U + c0:U + c1] = j
    return level


def unpack(win_exp):
    return np.stack([(win_exp >> s) & 255 for s in (0, 8, 16, 24)], 1)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k1_entries_rebuild_the_jax_change_of_basis(twojmax):
    _, p = plans(twojmax)
    exps, _, _, L = jmono.mono_plan(twojmax)
    exps = np.asarray(exps)
    index = {tuple(e): i for i, e in enumerate(exps)}
    want = [L]
    for v in range(4):
        Lv = np.zeros_like(L)
        for m, e in enumerate(exps):
            e = e.copy()
            e[v] += 1
            if tuple(e) in index:
                Lv[m] = e[v] * L[index[tuple(e)]]
        want.append(Lv)
    cols = sk._k1_columns(p)
    n_mono, two_u = L.shape
    got = np.zeros((5, n_mono, two_u))
    deg = exps.sum(1)
    level = column_levels(p)
    for u in range(two_u):
        for acc in range(5):
            q = slice(cols.e_ptr[5 * u + acc], cols.e_ptr[5 * u + acc + 1])
            m = cols.mono[q]
            assert (np.diff(m) > 0).all()
            assert (deg[m] == level[u] - (acc > 0)).all()
            got[acc, m, u] = cols.coef[q]
    assert np.array_equal(got, np.stack(want))
    assert np.array_equal(cols.exps, exps)


@pytest.mark.parametrize("twojmax,nsplit", [(2, 1), (2, 3), (6, 1), (6, 4),
                                            (10, 2), (10, 8)])
def test_k1_split_plan_rebuilds_the_change_of_basis(twojmax, nsplit):
    """Every column in one chunk of at most 4 columns; the splits' steps,
    read through their windows, rebuild L and its partials exactly; empty
    slots carry coefficient 0 at offset 0."""
    _, p = plans(twojmax)
    cols = sk._k1_columns(p)
    t = numpy_tables(sk.pair_u_tables(p, nsplit), p)
    n_mono, two_u = cols.exps.shape[0], 2 * p.u_len
    assert len(t["cw_ptr"]) == nsplit * sk._K1_WARPS + 1
    got = np.zeros((5, n_mono, two_u))
    seen = np.zeros(two_u, int)
    index = {tuple(e): i for i, e in enumerate(cols.exps)}
    all_chunks = sk._k1_chunks(p)
    level = column_levels(p)
    for s in range(nsplit):
        win = unpack(t["win_exp"][t["win_ptr"][s]:t["win_ptr"][s + 1]])
        mono = np.array([index[tuple(e)] for e in win], np.int64)
        split_cols, rounds = [], {}
        for w in range(8):
            for r, k in enumerate(range(t["cw_ptr"][s * 8 + w],
                                        t["cw_ptr"][s * 8 + w + 1])):
                u0, n, head, steps = chunk_steps(t, k)
                assert 1 <= n <= 4 - u0 % 2 and head == (0, 0)
                assert len(set(level[u0:u0 + n])) == 1
                split_cols.extend(range(u0, u0 + n))
                rounds.setdefault(r, []).append((w, u0, n))
                for cc, acc, coef, slot, rem in steps:
                    assert (rem == 0).all() and cc < n
                    for q in range(4):
                        if coef[q] == 0:
                            assert slot[q] == 0
                            continue
                        u = u0 + cc
                        assert got[acc, mono[slot[q]], u] == 0
                        got[acc, mono[slot[q]], u] = coef[q]
        # warp w takes the split's chunks 8 r + w, in order
        order = [(u, n) for r in sorted(rounds) for _, u, n in rounds[r]]
        first = all_chunks.index(order[0])
        assert order == all_chunks[first:first + len(order)]
        for r, chunks in rounds.items():
            assert [w for w, *_ in chunks] == list(range(len(chunks)))
        seen[split_cols] += 1
        runs = t["zruns"][t["zr_ptr"][s]:t["zr_ptr"][s + 1]]
        assert sorted(split_cols) == [u for a, b in runs
                                      for u in range(a, b)]
    assert (seen == 1).all()
    dense = np.zeros((5, n_mono, two_u))
    col, acc = np.divmod(np.repeat(np.arange(two_u * 5),
                                   np.diff(cols.e_ptr)), 5)
    dense[acc, cols.mono, col] = cols.coef
    assert np.array_equal(got, dense)


def test_k1_split_count_fits_shared_memory():
    """At twojmax 10 one split's window (all 1,001 monomials) exceeds a
    block's shared memory, so the plan takes more; a large chunk of atoms
    takes one split at twojmax 6."""
    _, p10 = plans(10)
    s = sk.pair_u_split_count(p10, 12, 40, 132)
    assert s > 1
    assert sk.pair_u_smem(sk.pair_u_tables(p10, s), 5, 40) <= 232448
    assert sk.pair_u_smem(sk.pair_u_tables(p10, 1), 1, 40) > 232448
    _, p6 = plans(6)
    assert sk.pair_u_split_count(p6, 1024, 64, 132) == 1
    assert sk.pair_u_split_count(p6, 16, 64, 132) > 1


def emulate_k1(p, args, nsplit):
    """csrc/pair_u_duals.cu's arithmetic over `pair_u_tables`: windowed
    monomials, each run's 4 slot sums in step order, (s0 + s1) + (s2 +
    s3), J; utot as the U entries applied to the channels' weighted
    monomial sums."""
    t = numpy_tables(sk.pair_u_tables(p, nsplit), p)
    vals, tans = (x.numpy() for x in tsnap._prologue_duals(*args, p))
    mask = args[2].numpy()
    N, K = mask.shape
    nc, two_u = p.nchem, 2 * p.u_len
    chan = args[1].numpy() if nc > 1 else np.zeros((N, K), int)
    J = np.full((3, N, K, two_u), np.nan)
    ut = np.zeros((N, nc, two_u))
    w = vals[4]
    for s in range(nsplit):
        e = unpack(t["win_exp"][t["win_ptr"][s]:t["win_ptr"][s + 1]])
        M = np.prod([vals[v][None] ** e[:, v, None, None] for v in range(4)],
                    0)
        for k in range(t["cw_ptr"][s * 8], t["cw_ptr"][s * 8 + 8]):
            u0, n, _, steps = chunk_steps(t, k)
            slot_acc = np.zeros((4, 5, 4, N, K))
            for cc, acc, coef, slot, _ in steps:
                for q in range(4):
                    slot_acc[cc, acc, q] += coef[q] * M[slot[q]]
            for cc in range(n):
                sa = slot_acc[cc]
                acc = (sa[:, 0] + sa[:, 1]) + (sa[:, 2] + sa[:, 3])
                tan = sum(tans[:, v] * acc[1 + v] for v in range(4))
                J[..., u0 + cc] = np.where(mask, w * tan
                                           + tans[:, 4] * acc[0], 0.0)
        # utot: the U entries applied to W[m] = sum_k w_k M_k[m], by channel
        Wm = np.stack([(np.where(mask & (chan == ch), w, 0.0)[None]
                        * M).sum(-1) for ch in range(nc)], -1)
        for k in range(t["cw_ptr"][s * 8], t["cw_ptr"][s * 8 + 8]):
            u0, n, _, steps = chunk_steps(t, k)
            for cc, acc, coef, slot, _ in steps:
                if acc == 0:
                    ut[:, :, u0 + cc] += (coef[:, None, None]
                                          * Wm[slot]).sum(0)
    self = tsnap._channel_self(args[3], p, torch.float64).numpy()
    return J, (ut + self).reshape(N, -1)


@pytest.mark.parametrize("twojmax,nelem,chem,nsplit", [
    (2, 1, False, 1), (2, 1, False, 3), (6, 1, False, 1), (6, 1, False, 4),
    (2, 3, True, 2), (4, 2, True, 1)])
def test_k1_schedule_matches_plain(twojmax, nelem, chem, nsplit):
    _, p = plans(twojmax, nelem, chem)
    args = tuple(torch.from_numpy(x) for x in block(3, nelem))
    J, ut = emulate_k1(p, args, nsplit)
    J0, ut0 = sk.pair_u_duals_plain(*args, p)
    close(J, J0)
    close(ut, ut0)
    assert (J.transpose(1, 2, 0, 3)[~args[2].numpy()] == 0).all()


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def jax_z_terms(twojmax):
    """(out, i1, i2, coefficient) of every nonzero of the JAX plan's grouped
    z term tables, and the number of outputs."""
    zd = build_snap_plan(twojmax=twojmax).z_dense
    D = int(zd["D"])
    rows, t0 = [], 0
    for g in zd["groups"]:
        gi1, gi2, M = (np.asarray(g[k]) for k in ("gi1", "gi2", "M"))
        ti, k, col = np.nonzero(M)
        rows.append(np.stack([(t0 + ti) * D * D + col, gi1[ti, k],
                              gi2[ti, k], M[ti, k, col]], 1))
        t0 += M.shape[0]
    return np.concatenate(rows), t0 * D * D


def schedule_terms(tb):
    rec = tb.rec.numpy()
    grp, grp_out = tb.grp.numpy(), tb.grp_out.numpy()
    rows = []
    for g, (first, count) in enumerate(grp):
        for lane in range(32):
            o = grp_out[32 * g + lane]
            q = first + 32 * np.arange(count) + lane
            c = f64(rec[q, :2])
            if o < 0:
                assert (c == 0).all()
                continue
            live = c != 0
            assert live[:live.sum()].all()   # padding after the terms
            rows.append(np.stack([np.full(live.sum(), o), rec[q, 2][live],
                                  rec[q, 3][live], c[live]], 1))
    return np.concatenate(rows)


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k2_schedule_rebuilds_the_jax_z_terms(twojmax):
    _, p = plans(twojmax)
    tb = sk.zlist_tables(p)
    ref, nz = jax_z_terms(twojmax)
    got = schedule_terms(tb)
    order = np.lexsort(ref.T[::-1])
    assert np.array_equal(got[np.lexsort(got.T[::-1])], ref[order])
    assert p.nz == nz
    count = np.bincount(ref[:, 0].astype(int), minlength=nz)
    assert np.array_equal(tb.zo.numpy(), np.nonzero(count == 0)[0])
    grp_out = tb.grp_out.numpy()
    assert sorted(grp_out[grp_out >= 0]) == list(np.nonzero(count)[0])
    counts = count[np.maximum(grp_out, 0)] * (grp_out >= 0)
    assert (np.diff(counts[grp_out >= 0]) <= 0).all()
    assert np.array_equal(tb.grp.numpy()[:, 1],
                          counts.reshape(-1, 32).max(1))


def emulate_k2(p, ut):
    """csrc/zlist.cu's arithmetic over `zlist_tables`, every ordered
    channel pair: (zr, zi) (N, nchem^2, nz)."""
    tb = sk.zlist_tables(p)
    rec = tb.rec.numpy()
    c, i1, i2 = f64(rec[:, :2]), rec[:, 2], rec[:, 3]
    N, nc, U = ut.shape[0], p.nchem, p.u_len
    uc = ut.numpy().reshape(N, nc, 2, U)
    zr = np.full((N, nc * nc, p.nz), np.nan)
    zi = zr.copy()
    zr[:, :, tb.zo.numpy()] = zi[:, :, tb.zo.numpy()] = 0.0
    for g, (first, count) in enumerate(tb.grp.numpy()):
        for lane in range(32):
            o = tb.grp_out[32 * g + lane].item()
            if o < 0:
                continue
            q = first + 32 * np.arange(count) + lane
            for pr in range(nc * nc):
                a, b = uc[:, pr // nc][..., i1[q]], uc[:, pr % nc][..., i2[q]]
                zr[:, pr, o] = ((a[:, 0] * b[:, 0] - a[:, 1] * b[:, 1])
                                * c[q]).sum(1)
                zi[:, pr, o] = ((a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0])
                                * c[q]).sum(1)
    return zr, zi


@pytest.mark.parametrize("twojmax,nelem,chem", [(2, 1, False), (6, 1, False),
                                                (2, 3, True), (4, 2, True)])
def test_k2_schedule_matches_plain(twojmax, nelem, chem):
    _, p = plans(twojmax, nelem, chem)
    args = tuple(torch.from_numpy(x) for x in block(5, nelem))
    ut = sk.pair_u_duals_plain(*args, p)[1]
    zr, zi = emulate_k2(p, ut)
    if chem:
        ref = sk.zlist_chem_plain(ut, p)
    else:
        ref = sk.zlist_plain(ut, p)
        zr, zi = zr[:, 0], zi[:, 0]
    close(zr, ref[0])
    close(zi, ref[1])


# ---------------------------------------------------------------------------
# K9, K10 and K10T: the dealt schedules
# ---------------------------------------------------------------------------


def dealt_y(d, bits):
    """A dealt y schedule as numpy: per, threads, stride, (low field, zc,
    fac) as (per, stride) arrays, seg."""
    key = d.key.numpy().reshape(d.per, d.stride)
    fac = d.fac.numpy().reshape(d.per, d.stride)
    return (d.per, d.threads, d.stride, key & ((1 << bits) - 1), key >> bits,
            fac, d.seg.numpy())


def k10t_schedule(tb):
    """K10T's schedule as numpy: per, threads, (u, zc, fac) as (per,
    threads) arrays, seg (W+1,), yz_src."""
    per, T, stride, u, zc, fac, seg = dealt_y(tb.ydesc, tb.key_bits)
    assert stride == T                   # one slot a thread
    return per, T, u, zc, fac, seg, tb.yz_src.numpy()


def check_dealt_entries(per, T, stride, low, zc, fac, seg, ref):
    """The dealt entries (group, low, z index, fac) equal `ref`'s, each
    group's on its own slots, entries then padding in each slot, a group's
    slots reading z in order at each step."""
    assert T % 32 == 0 and T <= 1024 and seg[-1] <= stride
    assert stride == T or (stride > 1024 and T == 1024)
    got = []
    for t in range(len(seg) - 1):
        for slot in range(seg[t], seg[t + 1]):
            live = fac[:, slot] != 0
            n = int(live.sum())
            assert live[:n].all() and n >= 1     # entries, then padding
            got += [(t, int(a), int(z), f) for a, z, f in zip(
                low[:n, slot], zc[:n, slot], fac[:n, slot])]
    assert (fac[:, seg[-1]:] == 0).all()
    assert (low[fac == 0] == 0).all() and (zc[fac == 0] == 0).all()
    assert sorted(got) == sorted(ref)     # each group's, once each
    for t in range(len(seg) - 1):
        z = zc[:, seg[t]:seg[t + 1]][fac[:, seg[t]:seg[t + 1]] != 0]
        assert (np.diff(z) >= 0).all()


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k10t_schedule_rebuilds_the_y_entries(twojmax):
    _, p = plans(twojmax)
    tb = tsnap.nn_tables(p)
    per, T, u, zc, fac, seg, yz_src = k10t_schedule(tb)
    # 8 entries a thread where 288 threads hold the segments, else where
    # 1,024 do
    assert per == {2: 8, 6: 8, 10: 15}[twojmax]
    ptr = tb.yt_ptr
    ref = [(t, int(uu), int(np.searchsorted(yz_src, s)), f)
           for t in range(p.ntriples)
           for uu, s, f in zip(tb.yt_u[ptr[t]:ptr[t + 1]],
                               tb.yt_src[ptr[t]:ptr[t + 1]],
                               tb.yt_fac[ptr[t]:ptr[t + 1]])]
    assert len(seg) == p.ntriples + 1
    check_dealt_entries(per, T, T, u, zc, fac, seg, ref)


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k10_schedule_rebuilds_the_y_entries(twojmax):
    """K10's schedule, by U column: its (u, t, src, fac) entries are
    `yu_*`'s; 9 entries a thread at twojmax 6 (275 segments in 288
    threads)."""
    _, p = plans(twojmax)
    tb = tsnap.nn_tables(p)
    per, T, stride, t, zc, fac, seg = dealt_y(tb.ycol, tb.key_bits)
    yz_src = tb.yz_src.numpy()
    assert (per, T) == {2: (8, 32), 6: (9, 288), 10: (17, 1024)}[twojmax]
    ptr = tb.yu_ptr
    ref = [(u, int(tt), int(np.searchsorted(yz_src, s)), f)
           for u in range(p.u_len)
           for tt, s, f in zip(tb.yu_t[ptr[u]:ptr[u + 1]],
                               tb.yu_src[ptr[u]:ptr[u + 1]],
                               tb.yu_fac[ptr[u]:ptr[u + 1]])]
    assert len(seg) == p.u_len + 1
    assert (yz_src[zc[fac != 0]] >= 0).all()
    check_dealt_entries(per, T, stride, t, zc, fac, seg, ref)


def k9_schedule(tb):
    """K9's B-term schedule as numpy: per, threads, stride, (i1, i2, i3,
    c) as (per, stride) arrays, seg (W+1,)."""
    d = tb.bterm
    key = d.key.numpy().reshape(d.per, d.stride)
    return (d.per, d.threads, d.stride, key & 0xffff, (key >> 16) & 0xffff,
            key >> 32, d.fac.numpy().reshape(d.per, d.stride),
            d.seg.numpy())


# K9's plans: one channel (the ids of the one-channel cases kept), and
# chemflag with two and three elements, wselfallflag 0 and 1, bzeroflag and
# bnormflag: (twojmax, nelem, chem, wself, bnorm, bzero)
K9_PLANS = [pytest.param(2, 1, False, False, False, True, id="2"),
            pytest.param(6, 1, False, False, False, True, id="6"),
            pytest.param(10, 1, False, False, False, True, id="10"),
            pytest.param(2, 2, True, False, False, True, id="2-chem2"),
            pytest.param(4, 2, True, True, True, True,
                         id="4-chem2-wself-bnorm"),
            pytest.param(4, 2, True, False, True, False,
                         id="4-chem2-bnorm-nobzero"),
            pytest.param(2, 3, True, True, False, True, id="2-chem3-wself"),
            pytest.param(4, 3, True, False, True, True, id="4-chem3-bnorm")]


def plan_b_terms(p):
    """The B terms of plan `p` by descriptor, in term order: descriptor
    blk * ntriples + t of channel triple blk sums (i1, i2, i3)[blk * nterms
    + k] with mmat[k, t] over the nonzero mmat[k, t]."""
    mmat = p.mmat.numpy()
    i1, i2, i3 = (getattr(p, n).numpy() for n in ("i1", "i2", "i3"))
    out = []
    for blk in range(p.nchem ** 3):
        for t in range(p.ntriples):
            k = np.nonzero(mmat[:, t])[0]
            q = blk * mmat.shape[0] + k
            out.append((i1[q], i2[q], i3[q], mmat[k, t]))
    return out


@pytest.mark.parametrize("twojmax,nelem,chem,wself,bnorm,bzero", K9_PLANS)
def test_k9_schedule_rebuilds_the_b_terms(twojmax, nelem, chem, wself,
                                          bnorm, bzero):
    """K9's B terms dealt by descriptor rebuild `bt_*`'s (t, i1, i2, i3, c)
    exactly, each descriptor's on its own threads in its order, at most
    `per` a thread; 15 terms a thread at twojmax 6 (251 segments in 256
    threads, where a descriptor has up to 505).  `bt_*` holds the plan's B
    terms: under chemflag nb_base = nchem^3 ntriples descriptors, their
    keys below 2^16 (the kernel's fields)."""
    _, p = plans(twojmax, nelem, chem, wself, bnorm, bzero)
    tb = tsnap.nn_tables(p)
    per, T, stride, i1, i2, i3, c, seg = k9_schedule(tb)
    if not chem:
        assert (per, T) == {2: (8, 32), 6: (15, 256),
                            10: (60, 1024)}[twojmax]
        assert stride == T
    assert T % 32 == 0 and T <= 1024 and stride >= T and seg[-1] <= stride
    assert len(seg) == p.nb_base + 1 == p.nchem ** 3 * p.ntriples + 1
    ptr = tb.bt_ptr
    for t, ref in enumerate(plan_b_terms(p)):
        for arr, r in zip((tb.bt_i1, tb.bt_i2, tb.bt_i3, tb.bt_c), ref):
            assert np.array_equal(arr[ptr[t]:ptr[t + 1]], r)
    assert max(i1.max(), i2.max(), i3.max()) < p.nchem * p.u_len < 1 << 16
    for t in range(p.nb_base):
        q = np.arange(ptr[t], ptr[t + 1])
        n = seg[t + 1] - seg[t]
        assert n == -(-len(q) // per)
        for i in range(n):
            mine = q[i::n]                  # dealt round-robin, in order
            live = c[:, seg[t] + i] != 0
            assert live[:len(mine)].all() and not live[len(mine):].any()
            for arr, ref in ((i1, tb.bt_i1), (i2, tb.bt_i2),
                             (i3, tb.bt_i3), (c, tb.bt_c)):
                assert np.array_equal(arr[:len(mine), seg[t] + i], ref[mine])
    assert (c[:, seg[-1]:] == 0).all()
    assert (i1[c == 0] == 0).all() and (i3[c == 0] == 0).all()


@pytest.mark.parametrize("twojmax,count,sectors", [(2, 38, 14),
                                                   (6, 1388, 464),
                                                   (10, 11098, 3522)])
def test_k10t_referenced_z_entries_each_once(twojmax, count, sectors):
    """yz_src lists each referenced z entry once, sorted (the same for K10's
    and K10T's entries); `sectors` of the 32-byte sectors of a z part (nz
    doubles) hold one, which the kernels' gathers move whole."""
    _, p = plans(twojmax)
    tb = tsnap.nn_tables(p)
    yz_src = tb.yz_src.numpy()
    assert (np.diff(yz_src) > 0).all()
    assert np.array_equal(yz_src, np.unique(tb.yt_src))
    assert np.array_equal(yz_src, np.unique(tb.yu_src))
    assert len(yz_src) == count and yz_src[-1] < p.nz
    assert len(np.unique(yz_src // 4)) == sectors


def emulate_k10t(p, vgc, zr, zi):
    """csrc/nn_dedu.cu's K10T over `nn_tables`: du by Lg's columns, each
    thread's segment of y entries on the compact z, then each descriptor's
    segment sums in order."""
    tb = tsnap.nn_tables(p)
    per, T, u, zc, fac, seg, yz_src = k10t_schedule(tb)
    N, U = vgc.shape[0], p.u_len
    sv = vgc.reshape(N, -1)
    ptr, row, val = (tb.lgc_ptr.numpy(), tb.lgc_row.numpy(),
                     tb.lgc_val.numpy())
    du = np.stack([(sv[:, row[ptr[c]:ptr[c + 1]]]
                    * val[ptr[c]:ptr[c + 1]]).sum(1)
                   for c in range(2 * U)], 1)
    zcr, zci = zr[:, yz_src], zi[:, yz_src]
    part = np.zeros((N, T))
    for j in range(per):
        part += fac[j] * (zcr[:, zc[j]] * du[:, u[j]]
                          + zci[:, zc[j]] * du[:, U + u[j]])
    return np.stack([part[:, seg[t]:seg[t + 1]].sum(1)
                     for t in range(p.ntriples)], 1)


def emulate_k10(p, dedb, zr, zi):
    """csrc/nn_dedu.cu's K10 over `nn_tables`: each slot's segment of y
    entries by U column on the compact z, real and imaginary apart, each
    column's segment sums in order, then vg by Lg's nonzero rows (the
    others 0)."""
    tb = tsnap.nn_tables(p)
    per, T, stride, t, zc, fac, seg = dealt_y(tb.ycol, tb.key_bits)
    yz_src = tb.yz_src.numpy()
    N, U = dedb.shape[0], p.u_len
    zcr, zci = zr[:, yz_src], zi[:, yz_src]
    pr, pi = np.zeros((N, stride)), np.zeros((N, stride))
    for j in range(per):
        w = dedb[:, t[j]] * fac[j]
        pr += w * zcr[:, zc[j]]
        pi += w * zci[:, zc[j]]
    du = np.concatenate([
        np.stack([x[:, seg[u]:seg[u + 1]].sum(1) for u in range(U)], 1)
        for x in (pr, pi)], 1)
    row, ptr, col, val = (x.numpy() for x in (tb.lgr_row, tb.lgr_ptr,
                                                tb.lgr_col, tb.lgr_val))
    assert (np.diff(np.diff(ptr)) <= 0).all()     # longest rows first
    vg = np.zeros((N, tb.n_t ** 2))
    for i, r in enumerate(row):
        vg[:, r] = (du[:, col[ptr[i]:ptr[i + 1]]]
                    * val[ptr[i]:ptr[i + 1]]).sum(1)
    return vg.reshape(N, tb.n_t, tb.n_t)


def emulate_k9(p, args):
    """csrc/nn_grid.cu's K9 after its product: per element channel ut = wg
    . Lg by Lg's columns, then the self term (every channel under
    wselfallflag or in one channel, else the atom's own); each slot's
    segment of B terms in order, then each descriptor's segment sums in
    order, less bzero.  wg, the tensor-core product, is the plain grid sum
    over the channel's pairs (the neighbor's element).  ut is laid out as
    the plain version's: the channels' real parts, then their imaginary
    parts."""
    tb = tsnap.nn_tables(p)
    per, T, stride, i1, i2, i3, c, seg = k9_schedule(tb)
    ar, ai, br, bi, w = (x.numpy() for x in tsnap._ck_prologue(*args, p))
    P, Q = tb.pidx.numpy(), tb.qidx.numpy()
    T1 = ar[..., None] ** P * ai[..., None] ** Q
    T2 = br[..., None] ** P * bi[..., None] ** Q
    N, U, nc = w.shape[0], p.u_len, p.nchem
    chan = np.eye(nc)[args[1].numpy() if nc > 1 else np.zeros(w.shape, int)]
    wg = np.einsum("akc,ak,akd,ake->acde", chan, w, T1, T2).reshape(N, nc, -1)
    ptr, row, val = (tb.lgc_ptr.numpy(), tb.lgc_row.numpy(),
                     tb.lgc_val.numpy())
    ut = np.stack([(wg[:, :, row[ptr[u]:ptr[u + 1]]]
                    * val[ptr[u]:ptr[u + 1]]).sum(-1)
                   for u in range(2 * U)], -1)
    own = (np.ones((N, nc)) if nc == 1 or p.wselfallflag
           else np.eye(nc)[args[3].numpy()])
    ut = ut + own[..., None] * p.selfvec.numpy()
    re = ut[..., :U].reshape(N, nc * U)
    im = ut[..., U:].reshape(N, nc * U)
    part = np.zeros((N, stride))
    for j in range(per):
        ab_r = re[:, i1[j]] * re[:, i2[j]] - im[:, i1[j]] * im[:, i2[j]]
        ab_i = re[:, i1[j]] * im[:, i2[j]] + im[:, i1[j]] * re[:, i2[j]]
        part += (ab_r * re[:, i3[j]] + ab_i * im[:, i3[j]]) * c[j]
    B = np.stack([part[:, seg[t]:seg[t + 1]].sum(1)
                  for t in range(p.nb_base)], 1)
    if p.bzeroflag:
        B = B - p.bzero.numpy()
    return np.concatenate([re, im], 1), B


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k10t_schedule_matches_plain(twojmax):
    _, p = plans(twojmax)
    n_t = tsnap.nn_tables(p).n_t
    rng = np.random.default_rng(11)
    N = 5
    vgc, zr, zi = (rng.normal(size=s) for s in ((N, n_t, n_t), (N, p.nz),
                                                (N, p.nz)))
    out = emulate_k10t(p, vgc, zr, zi)
    ref = nk.nn_dedu_vg_t_plain(*(torch.from_numpy(x) for x in (vgc, zr, zi)),
                                p)
    close(out, ref)


@pytest.mark.parametrize("twojmax", [2, 6, 10])
def test_k10_schedule_matches_plain(twojmax):
    _, p = plans(twojmax)
    rng = np.random.default_rng(12)
    N = 5
    dedb, zr, zi = (rng.normal(size=s) for s in ((N, p.ntriples),
                                                 (N, p.nz), (N, p.nz)))
    out = emulate_k10(p, dedb, zr, zi)
    ref = nk.nn_dedu_vg_plain(*(torch.from_numpy(x) for x in (dedb, zr, zi)),
                              p)
    close(out, ref)


@pytest.mark.parametrize("twojmax,nelem,chem,wself,bnorm,bzero", K9_PLANS)
def test_k9_schedule_matches_plain(twojmax, nelem, chem, wself, bnorm,
                                   bzero):
    """K9's emulation on `block`'s atoms (masked pairs, an atom with every
    slot masked: its ut the self term) against `nn_ut_b_plain`, one channel
    and chemflag."""
    _, p = plans(twojmax, nelem, chem, wself, bnorm, bzero)
    args = tuple(torch.from_numpy(x) for x in block(9, nelem))
    ut, B = emulate_k9(p, args)
    ut0, B0 = nk.nn_ut_b_plain(*args, p)
    assert ut.shape == (6, 2 * p.nchem * p.u_len)
    assert B.shape == (6, p.nb_base)
    close(ut, ut0)
    close(B, B0)
    U, nc, ie = p.u_len, p.nchem, int(args[3][-1])
    own = np.ones(nc) if nc == 1 or wself else np.eye(nc)[ie]
    self_ut = (own[:, None] * p.selfvec.numpy()).reshape(nc, 2, U)
    assert np.array_equal(ut[-1], np.concatenate(
        [self_ut[:, 0].ravel(), self_ut[:, 1].ravel()]))


def _entry_args(source, name):
    """The parameter names of csrc/<source>.cu's entry point `name` and the
    body of its launch (where the entry point forwards its parameters to
    its template on the working type, `<name>_launch<double>`, that
    template's body)."""
    src = (Path(nk.__file__).parent / "csrc" / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)\s*\{(.*?)\n\}",
                  src, re.S)
    names = [a.strip().rsplit(" ", 1)[-1].lstrip("*")
             for a in m.group(1).split(",")]
    body = m.group(2)
    if re.search(rf"return {name}_launch<double>\(", body):
        body = re.search(r"int " + name + r"_launch\(([^)]*)\)\s*\{(.*?)\n\}",
                         src, re.S).group(2)
    return names, body


def _launched_args(monkeypatch, call):
    """{parameter: value} of the one launch `call` makes, the kernel
    library replaced by a recorder (CPU tensors taken for device ones)."""
    seen = []
    monkeypatch.setattr(nk, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(nk, "_launch",
                        lambda name, dev, *a: seen.append((name, a)))
    call()
    (name, args), = seen
    source = {"nn_ut_b": "nn_grid"}.get(name, "nn_dedu")
    names, body = _entry_args(source, name)
    return dict(zip(names, args + (None,))), body


@pytest.mark.parametrize("kernel", ["nn_dedu_vg_t", "nn_dedu_vg", "nn_ut_b"])
@pytest.mark.parametrize("twojmax", [6, 8])
def test_k10t_block_is_the_narrow_launch_shape(monkeypatch, kernel,
                                               twojmax):
    """K10T, K10 and K9 launch with their schedules' `threads` (the block
    of the launch is that argument), and their sources' narrow launch
    bounds hold four blocks of their schedules' block an SM (K10 and K10T
    at 56 registers a thread, K9 at the 64 its FP64 mma needs), so that
    the 512 atoms of the Ta minibatch run in one wave at twojmax 6."""
    _, p = plans(twojmax)
    tb = tsnap.nn_tables(p)
    rng = np.random.default_rng(3)
    N, K, n_t = 3, 5, tb.n_t

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    z = (t(N, p.nz), t(N, p.nz))
    disp, jelem, mask, ielem = (torch.from_numpy(x)
                                for x in block(1, 1, A=N, K=K))
    calls = {"nn_dedu_vg_t": (lambda: nk.nn_dedu_vg_t(t(N, n_t, n_t), *z, p),
                              tb.ydesc, "nn_dedu", "", tsnap.DEAL_BLOCK),
             "nn_dedu_vg": (lambda: nk.nn_dedu_vg(t(N, p.ntriples), *z, p),
                            tb.ycol, "nn_dedu", "", tsnap.DEAL_BLOCK),
             "nn_ut_b": (lambda: nk.nn_ut_b(disp, jelem, mask, ielem, p),
                         tb.bterm, "nn_grid", "K9_", tsnap.K9_BLOCK)}
    call, sched, source, prefix, target = calls[kernel]
    args, body = _launched_args(monkeypatch, call)
    assert args["threads"] == sched.threads and args["per"] == sched.per
    assert args.get("stride", sched.threads) == sched.stride
    assert re.search(r"<<<static_cast<unsigned>\(natoms\), threads,", body)
    src = (Path(nk.__file__).parent / "csrc" / f"{source}.cu").read_text()
    narrow, blocks = (int(re.search(rf"constexpr int {prefix}{n} = (\d+);",
                                    src).group(1))
                      for n in ("NARROW_THREADS", "NARROW_BLOCKS"))
    regs = 65536 // (narrow * blocks) // 8 * 8
    assert target <= narrow and 4 * target * regs <= 65536
    assert regs >= {"nn_grid": 64, "nn_dedu": 56}[source]
    if twojmax == 6:
        assert sched.threads <= target


# ---------------------------------------------------------------------------
# the plain twins against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("twojmax,nelem,chem", [(2, 1, False), (6, 1, False),
                                                (4, 2, True)])
def test_plain_twins_match_jax(twojmax, nelem, chem):
    jp, p = plans(twojmax, nelem, chem)
    x = block(7, nelem, A=4, K=12)
    targs = tuple(torch.from_numpy(v) for v in x)

    def reference(disp, jelem, mask, ielem):
        wu, J = jsnap._pair_wu_duals(disp, jelem, mask, ielem, jp)
        ut = jsnap._utot_from_wu(wu, jelem, ielem, jp)
        if chem:
            U = jp.plan.u_len
            uc = ut.reshape(ut.shape[0], nelem, 2, U)
            z = [jsnap._compute_zcat_pair(uc[:, a, 0], uc[:, a, 1],
                                          uc[:, b, 0], uc[:, b, 1], jp.plan)
                 for a in range(nelem) for b in range(nelem)]
            zr = jnp.stack([v[0] for v in z], 1)
            zi = jnp.stack([v[1] for v in z], 1)
        else:
            zr, zi = jsnap._compute_zcat(ut, jp.plan)
        return J, ut, zr, zi

    J, ut, zr, zi = (np.array(v) for v in jax.jit(reference)(
        *(jnp.asarray(v) for v in x)))
    J0, ut0 = sk.pair_u_duals_plain(*targs, p)
    close(J0, J)
    close(ut0, ut)
    z0 = (sk.zlist_chem_plain if chem else sk.zlist_plain)(ut0, p)
    close(z0[0], zr)
    close(z0[1], zi)


# ---------------------------------------------------------------------------
# twojmax 13-16: the planners, K3's slab shape, the wrappers' limit
# ---------------------------------------------------------------------------


def port_section(twojmax):
    """A one-element BISPECTRUM section (the Ta_Linear_JCP2014 values)."""
    return SimpleNamespace(
        twojmax=[str(twojmax)], numtypes=1, wj=["1.0"], radelem=["0.5"],
        rcutfac=4.67637, rfac0=0.99363, rmin0=0.0, chemflag=0,
        quadraticflag=0, bnormflag=0, wselfallflag=0, switchflag=1,
        bzeroflag=1, switchinnerflag=0, sinner=None, dinner=None)


@pytest.fixture(scope="module")
def large_plans():
    """The port's plans at twojmax 13 and 14, built once (about 6 and 13 s
    here, and 2.5 and 4.8 GB at their peaks)."""
    return {tj: tsnap.make_params(port_section(tj), "cpu") for tj in (13, 14)}


@pytest.mark.parametrize("twojmax", [13, 14])
@pytest.mark.parametrize("K", [26, 64, 200])
def test_k1_k3_plans_past_twojmax_12(large_plans, twojmax, K):
    """K1 takes its recursion shape (no window fits) and K3 its level
    shape (16 whole y rows do not fit; one channel), each within a block's
    shared memory, at a chunk of 1,024 atoms and of 12 on a card of 132
    SMs; K3's slab plan (the chemflag modes' shape there) fits two blocks
    an SM."""
    p = large_plans[twojmax]
    for N in (1024, 12):
        shape, s = sk.pair_u_plan(p, N, K, 132)
        assert shape == "recursion" and (N * s >= 264 or s == 8)
        assert sk.pair_u_smem(sk.pair_u_recur_plan(p, s), 1, K) \
            <= sk._SMEM_LIMIT
    assert sk._k1_window_floor(p, K) > sk._SMEM_LIMIT
    assert sk.dbdd_shape(p, K) == "level"
    lv = sk.dbdd_levels(p)
    KB, CT = sk.dbdd_level_tiles(K)
    assert KB <= 32 and KB * (CT - 1) < K <= KB * CT
    assert sk.dbdd_level_smem(KB, lv.nch, lv.rows.numel(), p.nb_base) \
        <= sk._SMEM_LIMIT
    mt, tiles, slab = sk.dbdd_plan(p, K)
    assert slab > 0 and slab % 48 == 0 and mt == 32
    assert (tiles - 1) * 32 < p.nb_base <= tiles * mt
    ldl = sk.kl.ag_ldl(slab)
    assert 32 * 8 * ldl + sk.kl.AG_STAGE_BYTES + 4 * (2 * K + 2) \
        + 2 * ldl // 8 <= sk.kl.SMEM_PAIR


def test_k1_takes_the_recursion_shape_past_16_window_splits():
    """Twojmax 11's window first fits at 128 splits: the planner takes the
    recursion shape, at any chunk; twojmax 10's fits at 4 and keeps it."""
    p11 = tsnap.make_params(port_section(11), "cpu")
    _, p10 = plans(10)
    for N in (1024, 12, 2):
        assert sk.pair_u_plan(p11, N, 40, 132)[0] == "recursion"
        assert sk.pair_u_plan(p10, N, 40, 132)[0] == "window"
    first = [s for s in (1, 2, 4, 8, 16, 32, 64, 128)
             if sk.pair_u_smem(sk.pair_u_tables(p11, s), 1, 40)
             <= sk._SMEM_LIMIT]
    assert first[0] == 128 > sk.K1_WINDOW_SPLITS


def emulate_k3_slab(p, ut, zr, zi, J, jelem, slab):
    """csrc/dbdd.cu's slab shape: B from y layer 0 against utot; per
    channel and slab, y's columns in the slab from the targets of
    `dbdd_slab_ranges` (real parts, then imaginary ones), the product
    summed slab by slab in inner order."""
    tg = sk.dbdd_tables(p)
    tg_u = tg.tg_u.numpy()
    tg_src, tg_fac = tg.tg_src.numpy(), tg.tg_fac.numpy()
    ranges = sk.dbdd_slab_ranges(p, slab).numpy()
    N, K = J.shape[1:3]
    U, W, nc = p.u_len, p.nb_base, p.nchem
    zr = zr.numpy().reshape(N, nc * nc, p.nz)
    zi = zi.numpy().reshape(N, nc * nc, p.nz)
    ut = ut.numpy().reshape(N, nc, 2 * U)
    J = J.numpy()
    chan = jelem.numpy() if nc > 1 else np.zeros((N, K), int)
    blk_chan, blk_pair = p.blk_chan.numpy(), p.blk_pair.numpy()
    y_src, y_fac = p.y_src.numpy()[0], p.y_fac.numpy()[0]
    bzero = p.bzero.numpy() if p.bzeroflag else np.zeros(W)
    B = np.zeros((N, W))
    dBdD = np.zeros((N, W, K, 3))
    for w in range(W):
        blk, t = divmod(w, p.ntriples)
        ua = ut[:, blk_chan[blk, 0]]
        zp = blk_pair[blk, 0]
        f = y_fac[t]
        B[:, w] = (ua[:, :U] * (f * zr[:, zp, y_src[t]])
                   + ua[:, U:] * (f * zi[:, zp, y_src[t]])).sum(1) - bzero[w]
    for ch in range(nc):
        acc = np.zeros((N, W, K, 3))
        for s, i0 in enumerate(range(0, 2 * U, slab)):
            i1 = min(i0 + slab, 2 * U)
            ys = np.zeros((N, W, i1 - i0))
            for w in range(W):
                blk, t = divmod(w, p.ntriples)
                for part, za in ((0, zr), (1, zi)):
                    q = np.arange(ranges[t, s, 2 * part],
                                  ranges[t, s, 2 * part + 1])
                    col = part * U + tg_u[q]
                    assert ((col >= i0) & (col < i1)).all()
                    v = np.zeros((N, len(q)))
                    for l in range(3):
                        if blk_chan[blk, l] == ch:
                            v += tg_fac[q, l] * za[:, blk_pair[blk, l],
                                                   tg_src[q, l]]
                    ys[:, w, col - i0] = v
            acc += np.einsum("awu,caku->awkc", ys, J[..., i0:i1])
        dBdD += np.where((chan == ch)[:, None, :, None], acc, 0.0)
    return B, dBdD


@pytest.mark.parametrize("twojmax,nelem,chem,slab", [
    (6, 1, False, 48), (6, 2, True, 48), (4, 3, True, 48)])
def test_k3_slab_schedule_matches_plain(twojmax, nelem, chem, slab):
    """The slab shape in slabs narrower than its plans' (several slabs at
    these widths), one channel and chemflag."""
    _, p = plans(twojmax, nelem, chem)
    args = tuple(torch.from_numpy(x) for x in block(4, nelem))
    J, ut = sk.pair_u_duals_plain(*args, p)
    z = (sk.zlist_chem_plain if chem else sk.zlist_plain)(ut, p)
    B, dBdD = emulate_k3_slab(p, ut, *z, J, args[1], slab)
    if chem:
        B0, dBdD0 = sk.dbdd_chem_plain(ut, *z, J, args[1], p)
    else:
        B0, dBdD0 = sk.dbdd_plain(ut, *z, J, p)
    close(B, B0)
    close(dBdD, dBdD0)


def test_k1_k3_schedules_match_plain_tj13(large_plans):
    """The recursion shape of K1 and the slab shape of K3 at twojmax 13,
    their plans' own split and slab, on one config of 3 atoms x 8
    slots."""
    p = large_plans[13]
    args = tuple(torch.from_numpy(x) for x in block(9, 1, A=3, K=8))
    shape, nsplit = sk.pair_u_plan(p, 3, 8, 132)
    assert shape == "recursion"
    J, ut = emulate_k1_recursion(p, args, nsplit)
    J0, ut0 = sk.pair_u_duals_plain(*args, p)
    close(J, J0)
    close(ut, ut0)
    z = sk.zlist_plain(ut0, p)
    B, dBdD = emulate_k3_slab(p, ut0, *z, J0, args[1], sk.dbdd_plan(p, 8)[2])
    B0, dBdD0 = sk.dbdd_plain(ut0, *z, J0, p)
    close(B, B0)
    close(dBdD, dBdD0)


@pytest.mark.parametrize("label,module,name,nargs", [
    ("K1", sk, "pair_u_duals", 4), ("K1", sk, "pair_u_duals_chem", 4),
    ("K2", sk, "zlist", 1), ("K2", sk, "zlist_chem", 1),
    ("K3", sk, "dbdd", 4), ("K3", sk, "dbdd_chem", 5),
    ("K6q", sk, "quad_chain", 2), ("K9", nk, "nn_ut_b", 4),
    ("K10", nk, "nn_dedu_vg", 3), ("K10T", nk, "nn_dedu_vg_t", 3),
    ("K11", nk, "nn_pair_force", 5), ("K11T", nk, "nn_pair_force_t", 6)])
def test_wrappers_refuse_twojmax_17_first(monkeypatch, label, module, name,
                                          nargs):
    """On the card path every SNAP-plan wrapper checks the plan's twojmax
    before anything else: a stand-in plan with no tables at twojmax 17
    meets the ValueError that names the limit; 16 passes the check."""
    monkeypatch.setattr(module, "_on_cpu", lambda *t: False)
    with pytest.raises(ValueError, match=f"^twojmax 17: {label} takes at "
                                         f"most 16$"):
        getattr(module, name)(*[None] * nargs,
                              SimpleNamespace(twojmax=17, nchem=1))
    sk.check_twojmax(SimpleNamespace(twojmax=16), label)


# ---------------------------------------------------------------------------
# K1's recursion shape and K3's level shape
# ---------------------------------------------------------------------------


def light_k1_params(twojmax):
    """The fields of a one-element plan that K1 and its plain version read
    (the Ta_Linear_JCP2014 section's values), without the z and y tables:
    the port's whole plan at twojmax 16 takes about a minute and 14 GB."""
    from fitsnap_tpu_torch.ops.mono import mono_plan

    exps, parent, var, L = mono_plan(twojmax)
    deg = np.asarray(exps).sum(1)
    U = sum((j + 1) ** 2 for j in range(twojmax + 1))
    selfvec = np.zeros(2 * U)
    for j in range(twojmax + 1):
        off = j * (j + 1) * (2 * j + 1) // 6
        selfvec[off + np.arange(j + 1) * (j + 2)] = 1.0
    f64 = torch.float64
    return SimpleNamespace(
        twojmax=twojmax, u_len=U, rcutfac=4.67637, rfac0=0.99363, rmin0=0.0,
        switchflag=True, switchinnerflag=False, sinner=None, dinner=None,
        radelem=torch.tensor([0.5], dtype=f64),
        wj=torch.tensor([1.0], dtype=f64),
        elem=torch.tensor([[0.5, 1.0, 0.0, 0.0]], dtype=f64), nchem=1,
        wselfallflag=False, selfvec=torch.as_tensor(selfvec),
        mono_parent=torch.as_tensor(parent, dtype=torch.int32),
        mono_var=torch.as_tensor(var, dtype=torch.int32),
        mono_levels=tuple(int(x) for x in np.searchsorted(
            deg, np.arange(twojmax + 2))),
        L=torch.as_tensor(L), device=torch.device("cpu"), dtype=f64, k1=None)


def emulate_k1_recursion(p, args, nsplit):
    """csrc/pair_u_duals.cu's recursion shape over `pair_u_recur_plan`, in
    its order of operations: for each split and pass c (one displacement
    axis), the half rows of each level from the last row down (row j / 2
    of an even level from the mirror of level j - 1's row j / 2 - 1), J
    of the split's levels (the rows past the half from the mirrored
    column); utot the self term plus the live pairs' weighted half rows in
    slot order, by channel, the rest by symmetry."""
    pl = sk.pair_u_recur_plan(p, nsplit)
    tj, U, nc = p.twojmax, p.u_len, p.nchem
    rt = pl.rt.numpy().reshape(tj + 1, tj + 1)
    lv = pl.lv.numpy()
    vals, tans = (x.numpy() for x in tsnap._prologue_duals(*args, p))
    mask = args[2].numpy()
    jel = args[1].numpy()
    N, K = mask.shape
    off = [j * (j + 1) * (2 * j + 1) // 6 for j in range(tj + 2)]
    conj = np.array([1.0, -1.0, 1.0, -1.0])[:, None, None]
    J = np.full((3, N, K, 2 * U), np.nan)
    ut = np.full((N, nc, 2 * U), np.nan)
    selfv = tsnap._channel_self(args[3], p, torch.float64).numpy()
    ar, ai, br, bi, w = vals
    for s in range(nsplit):
        j0, j1 = lv[s], lv[s + 1]
        half = {}
        for c in range(3):
            dar, dai, dbr, dbi, dw = tans[c]
            P = np.zeros((tj // 2 + 1, tj + 1, 4, N, K))  # [mb, ma, part]
            P[0, 0, 0] = 1.0
            for j in range(j1):
                for mb in range(j // 2, -1, -1) if j else ():
                    x = np.zeros((j + 1, 4, N, K))
                    y = np.zeros((j + 1, 4, N, K))
                    if 2 * mb == j:
                        for ma in range(j + 1):
                            sx = -1.0 if (ma + mb) % 2 else 1.0
                            if ma < j:
                                x[ma] = sx * conj * P[mb - 1, j - 1 - ma]
                            if ma > 0:
                                y[ma] = -sx * conj * P[mb - 1, j - ma]
                    else:
                        x[:j] = P[mb, :j]
                        y[1:] = P[mb, :j]
                    ma = np.arange(j + 1)
                    ca = rt[j - ma, j - mb][:, None, None]
                    cb = rt[ma, j - mb][:, None, None]
                    x0, x1, x2, x3 = x.transpose(1, 0, 2, 3)
                    y0, y1, y2, y3 = y.transpose(1, 0, 2, 3)
                    P[mb, :j + 1] = np.stack([
                        ca * (ar * x0 + ai * x1) - cb * (br * y0 + bi * y1),
                        ca * (ar * x1 - ai * x0) - cb * (br * y1 - bi * y0),
                        ca * (dar * x0 + ar * x2 + dai * x1 + ai * x3)
                        - cb * (dbr * y0 + br * y2 + dbi * y1 + bi * y3),
                        ca * (dar * x1 + ar * x3 - dai * x0 - ai * x2)
                        - cb * (dbr * y1 + br * y3 - dbi * y0 - bi * y2)],
                        1)
                if j < j0:
                    continue
                for mb in range(j + 1):
                    for ma in range(j + 1):
                        col = off[j] + mb * (j + 1) + ma
                        if 2 * mb <= j:
                            v = P[mb, ma]
                            if c == 0:
                                half[col] = (w * v[0], w * v[1])
                        else:
                            sg = -1.0 if (ma + mb) % 2 else 1.0
                            v = sg * conj * P[j - mb, j - ma]
                        J[c, ..., col] = np.where(mask, w * v[2] + dw * v[0],
                                                  0.0)
                        J[c, ..., U + col] = np.where(
                            mask, w * v[3] + dw * v[1], 0.0)
        us = selfv.copy()
        for a in range(N):
            for k in np.nonzero(mask[a])[0]:
                e = 0 if nc == 1 else jel[a, k]
                if 0 <= e < nc:
                    for col, (vr, vi) in half.items():
                        us[a, e, col] += vr[a, k]
                        us[a, e, U + col] += vi[a, k]
        for j in range(j0, j1):
            for mb in range(j + 1):
                for ma in range(j + 1):
                    col = off[j] + mb * (j + 1) + ma
                    if 2 * mb <= j:
                        src, sg = col, 1.0
                    else:
                        src = off[j] + (j - mb) * (j + 1) + j - ma
                        sg = -1.0 if (ma + mb) % 2 else 1.0
                    ut[..., col] = sg * us[..., src]
                    ut[..., U + col] = -sg * us[..., U + src] if src != col \
                        else us[..., U + src]
    return J, ut.reshape(N, -1)


@pytest.mark.parametrize("twojmax,nelem,chem,wself,nsplit", [
    (2, 1, False, False, 1), (6, 1, False, False, 3), (8, 1, False, False, 2),
    (4, 2, True, False, 2), (4, 2, True, True, 1), (3, 3, True, True, 4)])
def test_k1_recursion_schedule_matches_jax(twojmax, nelem, chem, wself,
                                           nsplit):
    """The recursion shape's schedule against the JAX package's recursion,
    `compute_ulist_duals` on the same prologue values and tangents, with J
    = w dU + dw U and utot by `_utot_from_wu`: one channel and chemflag
    (wselfallflag 0 and 1), one to four level splits."""
    jp, p = plans(twojmax, nelem, chem, wself)
    x = block(5, nelem, A=4, K=12)
    args = tuple(torch.from_numpy(v) for v in x)
    J, ut = emulate_k1_recursion(p, args, nsplit)
    vals, tans = (v.numpy() for v in tsnap._prologue_duals(*args, p))
    duals = [(jnp.asarray(vals[v]), jnp.asarray(tans[:, v])) for v in range(4)]
    u = jsnap.compute_ulist_duals(duals[:2], duals[2:], twojmax)
    up = jsnap.flatten_ulist([(r[0], i[0]) for r, i in u])
    utan = jsnap.flatten_ulist([(r[1], i[1]) for r, i in u])
    U0 = np.concatenate([np.asarray(up[0]), np.asarray(up[1])], -1)
    Ut = np.concatenate([np.asarray(utan[0]), np.asarray(utan[1])], -1)
    w, wt = vals[4], tans[:, 4]
    Jref = w[None, ..., None] * Ut + wt[..., None] * U0[None]
    Jref = np.where(x[2][None, ..., None], Jref, 0.0)
    utref = jsnap._utot_from_wu(jnp.asarray(w[..., None] * U0),
                                jnp.asarray(x[1]), jnp.asarray(x[3]), jp)
    close(J, Jref)
    close(ut, np.asarray(utref))


@pytest.mark.parametrize("twojmax", [13, 14, 16])
def test_k1_recursion_schedule_matches_plain_large(large_plans, twojmax):
    """The recursion shape at twojmax 13, 14 and 16, the planner's split at
    a chunk of 3 atoms, against the plain version (the monomial form) on 3
    atoms x 6 slots."""
    p = large_plans[twojmax] if twojmax in large_plans \
        else light_k1_params(twojmax)
    args = tuple(torch.from_numpy(x) for x in block(9, 1, A=3, K=6))
    shape, nsplit = sk.pair_u_plan(p, 3, 6, 132)
    assert shape == "recursion" and nsplit == sk.K1_RECUR_SPLITS
    J, ut = emulate_k1_recursion(p, args, nsplit)
    J0, ut0 = sk.pair_u_duals_plain(*args, p)
    close(J, J0)
    close(ut, ut0)
    assert (J.transpose(1, 2, 0, 3)[~args[2].numpy()] == 0).all()


def test_k1_recursion_plan_levels_and_caps():
    """The recursion plan's coefficients are `rootpq_tables`' (the JAX
    package's), its splits cover the levels in order, a level at least
    each, and at twojmax 13-16 its shared memory takes 13, 10, 8 and 7
    channels at K = 64 (K1's shapes before it took 8, 6, 5 and 4)."""
    from fitsnap_tpu.ops.cg import rootpq_tables

    for tj in (6, 13, 16):
        p = light_k1_params(tj)
        rt = sk.pair_u_recur_plan(p, 1).rt.numpy().reshape(tj + 1, tj + 1)
        for j, (ca, cb) in enumerate(rootpq_tables(tj), start=1):
            for mb in range(j // 2 + 1):
                ma = np.arange(j + 1)
                assert np.array_equal(rt[j - ma, j - mb], ca[mb])
                assert np.array_equal(rt[ma, j - mb], cb[mb])
        for s in range(1, tj + 2):
            lv = sk.pair_u_recur_plan(p, s).lv.numpy()
            assert lv[0] == 0 and lv[-1] == tj + 1 and len(lv) == s + 1
            assert (np.diff(lv) >= 1).all()
    for tj, cap in ((13, 13), (14, 10), (15, 8), (16, 7)):
        pl = sk.pair_u_recur_plan(light_k1_params(tj), 1)
        assert sk.pair_u_smem(pl, cap, 64) <= sk._SMEM_LIMIT \
            < sk.pair_u_smem(pl, cap + 1, 64)


def emulate_k3_level(p, ut, zr, zi, J):
    """csrc/dbdd.cu's level shape over `dbdd_levels`, in torch: B from each
    row's layer-0 terms; per chunk, y's tile from the records (each
    thread's in order: set, then add), the group's product over the
    chunk's real and imaginary columns, the group's sums written into dB/dD
    at a row's first group and added at its later ones, in chunk order."""
    lv = sk.dbdd_levels(p)
    N, K = J.shape[1:3]
    U, W, LDY = p.u_len, p.nb_base, sk._K3_LDY
    bzero = p.bzero if p.bzeroflag else torch.zeros_like(p.bzero)
    bp = lv.b_ptr.long()

    def b_row(w):
        q = slice(bp[w], bp[w + 1])
        u, src, f = lv.b_u[q].long(), lv.b_src[q].long(), lv.b_fac[q]
        return (ut[:, u] * (f * zr[:, src])
                + ut[:, U + u] * (f * zi[:, src])).sum(1) - bzero[w]

    B = torch.stack([b_row(w) for w in range(W)], 1)
    out = torch.full((N, W, 3 * K), float("nan"), dtype=J.dtype)
    Jn = J.permute(1, 2, 0, 3).reshape(N, 3 * K, 2 * U)   # column 3k + c
    rows, rec = lv.rows.tolist(), lv.rec[:, :2].long()
    rfac = torch.from_numpy(lv.rec[:, 2:].numpy().copy().view(np.float64))
    rfac = rfac[:, 0]
    acc = 0
    for rb, nrt, g, L, r0, m, flush, _ in lv.chunk.tolist():
        lp8 = -(-L // 8) * 8
        y = torch.zeros((N, 16 * nrt * LDY), dtype=J.dtype)
        rr = rec[r0:r0 + m * 256].reshape(m, 256, 2).transpose(0, 1)
        ff = rfac[r0:r0 + m * 256].reshape(m, 256).transpose(0, 1)
        for th in range(256):
            for (x, src), f in zip(rr[th].tolist(), ff[th].tolist()):
                if x < 0:
                    continue
                pos = x & 0x3fffffff
                v = (f * zr[:, src], f * zi[:, src]) if src >= 0 else (0, 0)
                for part in (0, 1):
                    if x >> 30:
                        y[:, pos + part * lp8] = v[part]
                    else:
                        y[:, pos + part * lp8] += v[part]
        y = y.reshape(N, 16 * nrt, LDY)
        ya = torch.cat([y[..., :L], y[..., lp8:lp8 + L]], -1)
        jb = torch.cat([Jn[..., g:g + L], Jn[..., U + g:U + g + L]], -1)
        acc = acc + torch.einsum("ari,ani->arn", ya, jb)
        if flush:
            for i, e in enumerate(rows[rb:rb + 16 * nrt]):
                if e >= 0:
                    w = e & 0x3fffffff
                    out[:, w] = acc[:, i] if e >> 30 else out[:, w] + acc[:, i]
            acc = 0
    return B, out.reshape(N, W, K, 3)


def check_level_plan(p):
    """Every row of W in a group of each level its targets touch and no
    other, first at its lowest level; at most 64 rows a group; the chunks
    in level order covering each level's columns once, 16 at most."""
    lv = sk.dbdd_levels(p)
    tg = sk.dbdd_tables(p)
    ptr, tu = tg.tg_ptr.numpy(), tg.tg_u.numpy()
    off = [j * (j + 1) * (2 * j + 1) // 6 for j in range(p.twojmax + 2)]
    lev = np.searchsorted(off, tu, "right") - 1
    t_of = np.repeat(np.arange(p.nb_base), np.diff(ptr))
    rows = lv.rows.numpy()
    seen, cols = {}, []
    for rb, nrt, g, L, _, _, flush, _ in lv.chunk.tolist():
        j = int(np.searchsorted(off, g, "right")) - 1
        assert 1 <= L <= 16 and g + L <= off[j + 1] and nrt <= 4
        cols.append((j, rb, g, L))
        if flush:
            group = rows[rb:rb + 16 * nrt]
            for e in group[group >= 0]:
                w = e & 0x3fffffff
                assert bool(e >> 30) == (w not in seen)
                seen.setdefault(w, []).append(j)
    for w in range(p.nb_base):
        assert seen[w] == sorted(set(lev[t_of == w]))
    for j in range(p.twojmax + 1):
        for rb in sorted({rb for jj, rb, _, _ in cols if jj == j}):
            gs = sorted((g, L) for jj, b, g, L in cols if jj == j and b == rb)
            assert [g for g, _ in gs] == list(range(off[j], off[j + 1], 16))
            assert sum(L for _, L in gs) == (j + 1) ** 2


@pytest.mark.parametrize("twojmax", [13, 14])
def test_k3_level_schedule_matches_plain_large(large_plans, twojmax):
    """K3's level shape at twojmax 13 and 14: its plan's layout, and its
    schedule against the plain version (1e-12) on 2 atoms x 5 slots."""
    p = large_plans[twojmax]
    assert sk.dbdd_shape(p, 64) == "level"
    check_level_plan(p)
    args = tuple(torch.from_numpy(x) for x in block(11, 1, A=2, K=5))
    J, ut = sk.pair_u_duals_plain(*args, p)
    z = sk.zlist_plain(ut, p)
    B, dBdD = emulate_k3_level(p, ut, *z, J)
    B0, dBdD0 = sk.dbdd_plain(ut, *z, J, p)
    close(B, B0)
    close(dBdD, dBdD0)


@pytest.mark.parametrize("twojmax", [2, 6])
def test_k3_level_schedule_matches_jax(twojmax):
    """K3's level schedule at twojmax 2 and 6 (the plan takes whole rows
    there; the level plan is built all the same) against the JAX
    package's `_dbdu_ylist` and its contraction (einsum("awu,caku->awkc"))
    and B (bzeroflag on), on JAX's own J, utot and z-lists."""
    jp, p = plans(twojmax)
    check_level_plan(p)
    x = block(6, 1, A=4, K=12)

    def reference(disp, jelem, mask, ielem):
        wu, J = jsnap._pair_wu_duals(disp, jelem, mask, ielem, jp)
        ut = jsnap._utot_from_wu(wu, jelem, ielem, jp)
        zcat = jsnap._compute_zcat(ut, jp.plan)
        dbdu = jsnap._dbdu_ylist(ut, jp.plan, zcat)
        # Bbase of `descriptors_with_jacobian` (ops/snap.py:956-964)
        U = jp.plan.u_len
        src0 = jnp.asarray(jp.plan.y_src[0])
        fac0 = jnp.asarray(jp.plan.y_fac[0])
        B = (jnp.einsum("au,atu->at", ut[:, :U], fac0 * zcat[0][:, src0])
             + jnp.einsum("au,atu->at", ut[:, U:], fac0 * zcat[1][:, src0])
             - jnp.asarray(jp.plan.bzero))
        return (J, ut, zcat[0], zcat[1], B,
                jnp.einsum("awu,caku->awkc", dbdu, J))

    J, ut, zr, zi, B0, dBdD0 = (torch.from_numpy(np.array(v)) for v in
                                jax.jit(reference)(*(jnp.asarray(v)
                                                     for v in x)))
    B, dBdD = emulate_k3_level(p, ut, zr, zi, J)
    close(B, B0)
    close(dBdD, dBdD0)
