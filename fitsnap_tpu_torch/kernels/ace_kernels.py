"""Wrappers of the CUDA kernels of the ACE linear fit, with their plain
PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K13 ace_pair_basis | csrc/ace_pair_basis.cu | ops/ace.py ace_pair_phi (with chebexpcos_basis, spline_radial_basis, sph_harm), ace_a_basis, the jvp of ace_descriptors_with_jacobian |
| K14 ace_b_dbdd | csrc/ace_b_dbdd.cu (+ atom_gemm.cuh) | ops/ace.py ace_b_and_dbda, the einsum and live mask of ace_descriptors_with_jacobian |

As in `kernels/snap_kernels.py`, each wrapper takes its plain version for
tensors on the CPU, launches its kernel for tensors on a CUDA device, and
raises for anything else; every launch adds one to the wrapper's
`launches` count.  K13 takes every convention of the plan (the six
closed-form radial variants, the spline radials, the three Ylm
normalisations) and any lmax whose working set fits a block's shared
memory.
"""

import math
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.ops import ace as ops

# float64 only: float32 names its ROADMAP.md queue item
_check = partial(kl.check, queue=kl.QUEUE_ACE)

_K13_WARPS = 8   # warps a block of csrc/ace_pair_basis.cu where they fit
_K13_ENTRY = 9   # doubles of an (l, m) entry of its records (ENTRY)

kl.register("ace_pair_basis", "ace_pair_basis",
            [kl.P] * 8 + [kl.I] * 3 + [kl.P] * 3 + [kl.I, kl.D]
            + [kl.I] * 3 + [kl.LL] + [kl.I] * 5 + [kl.P] * 3)
kl.register("ace_b_dbdd", "ace_b_dbdd",
            [kl.P] * 12 + [kl.I] * 4 + [kl.LL] + [kl.I] * 4 + [kl.P] * 3)


def radial_code(variant):
    """csrc/ace_pair_basis.cu's code of a ChebExpCos radial variant, the
    predicates of `ops.ace._radial_and_derivative`: 1 x runs as
    e^{lambda r / rc} (pace_x*), 2 x negated (every pace* but pace_px), 4
    the PACE stack g_1 = env, g_n = (1 - T_{n-1}(x)) / 2 env (pace*), 8 the
    T stack from T_1 (*_t1)."""
    pace = variant.startswith("pace")
    return (int(variant.startswith("pace_x"))
            | 2 * int(pace and variant != "pace_px") | 4 * int(pace)
            | 8 * int(variant.endswith("_t1")))


def ylm_table(lmax, ylm):
    """(3, (lmax + 1)(lmax + 2) / 2) float64 rows of each (l, m >= 0) at
    l (l + 1) / 2 + m: the normalisation c_lm = s_l (-1)^m sqrt((2l + 1) /
    (4 pi) (l - m)! / (l + m)!) of the `ylm` convention (s_l = sqrt(4 pi)
    for '4pi', sqrt(4 pi / (2l + 1)) for 'racah', else 1), and the
    coefficients a, b of the Legendre recursion (sin^m factored out)
    P_lm = a z P_{l-1,m} - b P_{l-2,m}, a = (2l - 1) / (l - m), b =
    (l + m - 1) / (l - m); at l = m, a holds P_mm = (2m - 1)!!.  The
    arithmetic of `ops.ace._ylm_and_gradient`."""
    tab = np.zeros((3, (lmax + 1) * (lmax + 2) // 2))
    pmm = 1.0
    for m in range(lmax + 1):
        if m > 0:
            pmm = pmm * (2 * m - 1)
        for l in range(m, lmax + 1):
            e = l * (l + 1) // 2 + m
            scale = {"4pi": math.sqrt(4.0 * math.pi),
                     "racah": math.sqrt(4.0 * math.pi / (2 * l + 1))
                     }.get(ylm, 1.0)
            tab[0, e] = scale * (-1.0) ** m * math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m))
            if l == m:
                tab[1, e] = pmm
            else:
                tab[1, e] = (2 * l - 1) / (l - m)
                tab[2, e] = (l + m - 1) / (l - m)
    return tab


def k13_record(plan):
    """(record length, offset of the Yhat entries, offset of the constant
    entry) of a neighbor's record in csrc/ace_pair_basis.cu, in doubles:
    g, dg/dr (nradbase each), the unit vector and 1 / r, an entry of 9
    doubles per (l, m >= 0) (Yhat re, im, their gradients, a pad), the
    constant entry (1, 0, ..., 0), padded to an odd length (records of
    neighboring lanes then start in different banks)."""
    ne = (plan.lmax + 1) * (plan.lmax + 2) // 2
    y0 = 2 * plan.nradbase + 4
    c0 = y0 + _K13_ENTRY * ne
    return (c0 + 8) | 1, y0, c0


def k13_columns(plan):
    """(2 nA, 4) int32 column table of csrc/ace_pair_basis.cu, one row per
    Jp column (real parts of the A-slots, then imaginary): the record
    offsets of the slot's Yhat part and of its gradient's three
    directions, n - 1, and sign * (mu + 1), the sign (-1)^m of m < 0 (and
    of the imaginary part's conjugate), 0 for slot 0 (always zero).  A
    rank-1 radial slot (l = -1) reads the constant entry."""
    _, y0, c0 = k13_record(plan)
    nA = plan.nA
    cols = np.zeros((2 * nA, 4), np.int32)
    for part in (0, 1):
        for s, (mu, n, l, m) in enumerate(ops.slot_table(plan)):
            if s == 0:
                cols[part * nA] = (c0 + 1, c0 + 2, 0, 0)
                continue
            if l < 0:
                yo, go, sg = c0 + part, c0 + 2, 1
            else:
                e = y0 + _K13_ENTRY * (l * (l + 1) // 2 + abs(m))
                yo, go = e + part, e + 2 + 3 * part
                sg = 1 if m >= 0 else (-1) ** abs(m) * (1 - 2 * part)
            cols[part * nA + s] = (yo, go, n - 1, sg * (mu + 1))
    return cols


def k13_shape(plan, K):
    """csrc/ace_pair_basis.cu's launch shape for K neighbor slots: (warps a
    block, log2 of the neighbors a warp's tile, record length,
    shared-memory bytes).  A tile holds 8 neighbors, halved while its
    Legendre items ((lmax + 1) a neighbor) exceed 48, and a block has a
    warp a tile up to 8 (measured on the H100, `PERF.md` §6: 8
    warps of 8 neighbors at lmax 2, of 4 at lmax 8); warps, then the tile,
    halve until the working set (the column table, a partial sum of A per
    warp, the warps' records and neighbor elements) fits a block; raises
    where one warp with one-neighbor tiles does not fit."""
    rl, _, _ = k13_record(plan)
    two_a = 2 * plan.nA
    nw_log = 3
    while nw_log and (plan.lmax + 1) << nw_log > 48:
        nw_log -= 1

    def smem(warps, nw_log):
        nw = 1 << nw_log
        return 8 * (2 * two_a + warps * two_a + warps * nw * rl) \
            + 4 * warps * nw

    warps = max(1, min(_K13_WARPS, -(-K // (1 << nw_log))))
    while smem(warps, nw_log) > kl.SMEM_LIMIT and (warps > 1 or nw_log):
        if warps > 1:
            warps //= 2
        else:
            nw_log -= 1
    need = smem(warps, nw_log)
    if need > kl.SMEM_LIMIT:
        raise ValueError(
            f"ace_pair_basis: lmax {plan.lmax}, {plan.nradbase} radial "
            f"functions and {plan.nA} A-slots need {need} bytes of shared "
            f"memory a block, more than {kl.SMEM_LIMIT}")
    return warps, nw_log, rl, need


def kernel_tables(plan):
    """Host-built tables of the two kernels (numpy, kept on the plan).

    K13: ytab (`ylm_table` of the plan's lmax and convention), radial (the
    `radial_code` of its variant), cols (`k13_columns`).  K14: lab_t
    (nl + 1): the terms of label l, whose rows of t_fact are sorted by
    label; the nonzero entries of
    dB/dA: lab_e (nl + 1) the entries of label l, e_slot the A-slot of each
    entry (the distinct slots of the label's terms in increasing order,
    slot 0, the padding factor's, where Jp is zero, left out), e_lab its
    label, e_c (nE + 1) its contributions, c_tr = term * R + factor in
    increasing order; el_l (numtypes + 1) the labels of central element e
    (labels are sorted by element).
    """
    tabs = plan.tables.get("kernel_tables")
    if tabs is not None:
        return tabs
    nl, R = len(plan.labels), plan.rank_max
    lab = np.asarray(plan.t_label, np.int64)
    if np.any(np.diff(lab) < 0):
        raise ValueError("ACE plan: terms are not sorted by label")
    lab_t = np.searchsorted(lab, np.arange(nl + 1)).astype(np.int32)
    mu0 = np.asarray(plan.t_mu0, np.int64)
    if np.any(np.diff(mu0) < 0):
        raise ValueError("ACE plan: labels are not sorted by element")
    el_l = np.searchsorted(mu0, np.arange(plan.numtypes + 1))
    fact = np.asarray(plan.t_fact, np.int64)
    lab_e, e_slot, e_lab, e_c, c_tr = [0], [], [], [0], []
    for li in range(nl):
        by_slot = {}
        for t in range(lab_t[li], lab_t[li + 1]):
            for r in range(R):
                if fact[t, r] != 0:
                    by_slot.setdefault(int(fact[t, r]), []).append(t * R + r)
        for s in sorted(by_slot):
            e_slot.append(s)
            e_lab.append(li)
            c_tr += by_slot[s]
            e_c.append(len(c_tr))
        lab_e.append(len(e_slot))

    def i32(x):
        return np.asarray(x, np.int32)

    tabs = SimpleNamespace(
        ytab=ylm_table(plan.lmax, plan.ylm), radial=radial_code(plan.radial),
        cols=k13_columns(plan),
        lab_t=lab_t, lab_e=i32(lab_e), e_slot=i32(e_slot),
        e_lab=i32(e_lab), e_c=i32(e_c), c_tr=i32(c_tr), el_l=i32(el_l),
        nE=len(e_slot), nC=len(c_tr))
    plan.tables["kernel_tables"] = tabs
    return tabs


def ace_b_dbdd_tiles(plan):
    """(labels per block, blocks per atom, scratch terms) of
    csrc/ace_b_dbdd.cu: the dense dB/dA rows of the element with the most
    labels (2 nA + pad doubles each) beside A and a scratch for the terms
    of a segment of labels (cofactors, values, factor slots, entries and
    contributions), two blocks an SM where they fit; the scratch holds the
    most terms of a label and the product's epilogue stage at least, and
    fills the rest of that budget."""
    tabs = kernel_tables(plan)
    R = plan.rank_max
    per_term = 8 * (2 * R + 1) + 4 * 5 * R
    row_bytes = 8 * kl.ag_ldl(2 * plan.nA)
    fixed = 16 * plan.nA + 4 * 36
    seg = max(int(np.diff(tabs.lab_t).max()),
              -(-kl.AG_STAGE_BYTES // (8 * (2 * R + 1))))
    mt, tiles = kl.row_plan(int(np.diff(tabs.el_l).max()), row_bytes,
                            fixed + seg * per_term, "ace_b_dbdd")
    limit = (kl.SMEM_PAIR if mt * row_bytes + fixed + seg * per_term
             <= kl.SMEM_PAIR else kl.SMEM_LIMIT)
    seg = max(seg, min(len(plan.t_coef),
                       (limit - mt * row_bytes - fixed) // per_term))
    return mt, tiles, seg


def _device_tables(plan, device):
    key = f"kernel_tables:{device}"
    tabs = plan.tables.get(key)
    if tabs is None:
        h = kernel_tables(plan)

        def i32(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                                   device=device)

        tabs = SimpleNamespace(
            ytab=torch.as_tensor(h.ytab, device=device), cols=i32(h.cols),
            spline=(ops.spline_tensor(plan, device) if plan.spline_delta
                    else None),
            lab_t=i32(h.lab_t), lab_e=i32(h.lab_e),
            e_slot=i32(h.e_slot), e_lab=i32(h.e_lab), e_c=i32(h.e_c),
            c_tr=i32(h.c_tr), el_l=i32(h.el_l), fact=i32(plan.t_fact),
            coef=torch.as_tensor(np.asarray(plan.t_coef, np.float64),
                                 device=device))
        plan.tables[key] = tabs
    return tabs


# ---------------------------------------------------------------------------
# K13: per-pair basis, its tangents and the neighbor sum A
# ---------------------------------------------------------------------------


def ace_pair_basis_plain(disp, jelem, mask, ielem, plan):
    """Plain K13: (A (N, 2nA) [Re | Im] with A[:, 0] = 1, Jp (3, N, K,
    2nA) the pair tangents d phi / d disp)."""
    phi, Jp = ops.pair_phi_tangents(disp, jelem, mask, ielem, plan)
    A = phi.sum(dim=-2)
    A[..., 0] = 1.0
    return A, Jp


def ace_pair_basis(disp, jelem, mask, ielem, plan):
    """K13 on the card: disp (N, K, 3) f64, jelem (N, K) i32, mask (N, K)
    bool, ielem (N,) i32.  Same outputs as `ace_pair_basis_plain`."""
    if kl.on_cpu(disp, jelem, mask, ielem):
        return ace_pair_basis_plain(disp, jelem, mask, ielem, plan)
    N, K = mask.shape
    _check(disp, "disp", torch.float64, (N, K, 3))
    _check(jelem, "jelem", torch.int32, (N, K))
    _check(mask, "mask", torch.bool, (N, K))
    _check(ielem, "ielem", torch.int32, (N,))
    nA = plan.nA
    warps, nw_log, rl, smem = k13_shape(plan, K)
    dev = disp.device
    bonds = ops.plan_tensors(plan, dev)
    tabs = _device_tables(plan, dev)
    A = torch.empty((N, 2 * nA), dtype=torch.float64, device=dev)
    Jp = torch.empty((3, N, K, 2 * nA), dtype=torch.float64, device=dev)
    inner = int(np.any(np.asarray(plan.rcinner) > 0.0))
    spline = tabs.spline
    kl.launch("ace_pair_basis", dev, kl.ptr(disp), kl.ptr(jelem),
              kl.ptr(mask), kl.ptr(ielem), kl.ptr(bonds.rcut),
              kl.ptr(bonds.lmbda), kl.ptr(bonds.rcinner),
              kl.ptr(bonds.drcinner), plan.numtypes, inner,
              kernel_tables(plan).radial, kl.ptr(tabs.ytab),
              kl.ptr(tabs.cols), None if spline is None else kl.ptr(spline),
              0 if spline is None else spline.shape[1],
              float(plan.spline_delta or 0.0), nA, plan.nradbase, plan.lmax,
              N, K, warps, nw_log, rl, smem, kl.ptr(A), kl.ptr(Jp))
    ace_pair_basis.launches += 1
    return A, Jp


ace_pair_basis.launches = 0


# ---------------------------------------------------------------------------
# K14: B, dB/dA and the contraction into dB/dD
# ---------------------------------------------------------------------------


def ace_b_dbdd_plain(A, Jp, ielem, plan):
    """Plain K14: (B (N, nl), dBdD (N, nl, K, 3)), labels of another
    central element zero."""
    nA = plan.nA
    B, dBdA = ops.ace_b_and_dbda(A[:, :nA], A[:, nA:], plan)
    dBdD = torch.einsum("alp,cakp->alkc", dBdA, Jp)
    mu0 = ops.plan_tensors(plan, A.device).t_mu0
    live = (mu0[None, :] == ielem.long()[:, None]).to(A.dtype)
    return B * live, dBdD * live[:, :, None, None]


def ace_b_dbdd(A, Jp, ielem, plan):
    """K14 on the card: A (N, 2nA), Jp (3, N, K, 2nA) f64, ielem (N,) i32.
    Same outputs as `ace_b_dbdd_plain`."""
    if kl.on_cpu(A, Jp, ielem):
        return ace_b_dbdd_plain(A, Jp, ielem, plan)
    N, K = Jp.shape[1], Jp.shape[2]
    nA, nl = plan.nA, len(plan.labels)
    _check(A, "A", torch.float64, (N, 2 * nA))
    _check(Jp, "Jp", torch.float64, (3, N, K, 2 * nA))
    _check(ielem, "ielem", torch.int32, (N,))
    dev = A.device
    tabs = _device_tables(plan, dev)
    mt, ntiles, seg = ace_b_dbdd_tiles(plan)
    B = torch.empty((N, nl), dtype=torch.float64, device=dev)
    dBdD = torch.empty((N, nl, K, 3), dtype=torch.float64, device=dev)
    kl.launch("ace_b_dbdd", dev, kl.ptr(A), kl.ptr(Jp), kl.ptr(ielem),
              kl.ptr(tabs.fact), kl.ptr(tabs.coef), kl.ptr(tabs.lab_t),
              kl.ptr(tabs.lab_e), kl.ptr(tabs.e_slot), kl.ptr(tabs.e_lab),
              kl.ptr(tabs.e_c), kl.ptr(tabs.c_tr), kl.ptr(tabs.el_l),
              plan.numtypes, plan.rank_max, nl, nA, N, K, mt, ntiles,
              seg, kl.ptr(B), kl.ptr(dBdD))
    ace_b_dbdd.launches += 1
    return B, dBdD


ace_b_dbdd.launches = 0

KERNELS = (ace_pair_basis, ace_b_dbdd)


def reset_launches():
    """Set both ACE kernels' launch counts to 0."""
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}
