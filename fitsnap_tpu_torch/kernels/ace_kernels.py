"""Wrappers of the CUDA kernels of the ACE linear fit, with their plain
PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K13 ace_pair_basis | csrc/ace_pair_basis.cu | ops/ace.py ace_pair_phi (with chebexpcos_basis, sph_harm), ace_a_basis, the jvp of ace_descriptors_with_jacobian |
| K14 ace_b_dbdd | csrc/ace_b_dbdd.cu (+ atom_gemm.cuh) | ops/ace.py ace_b_and_dbda, the einsum and live mask of ace_descriptors_with_jacobian |

As in `kernels/snap_kernels.py`, each wrapper takes its plain version for
tensors on the CPU, launches its kernel for tensors on a CUDA device, and
raises for anything else; every launch adds one to the wrapper's
`launches` count.  The kernels take ML-PACE's conventions, the plan
defaults (`radial="pace_px"`, `ylm="4pi"`, no spline radials, lmax <= 6);
their wrappers raise for others, which the plain versions keep.
"""

from types import SimpleNamespace

import numpy as np
import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.ops import ace as ops

_LMAX = 6        # largest l of csrc/ace_pair_basis.cu
_K13_TILE = 16   # neighbors per tile of csrc/ace_pair_basis.cu

kl.register("ace_pair_basis", "ace_pair_basis",
            [kl.P] * 8 + [kl.I, kl.I, kl.P, kl.I, kl.I, kl.I, kl.LL, kl.I]
            + [kl.P] * 3)
kl.register("ace_b_dbdd", "ace_b_dbdd",
            [kl.P] * 12 + [kl.I] * 4 + [kl.LL] + [kl.I] * 4 + [kl.P] * 3)


def kernel_tables(plan):
    """Host-built tables of the two kernels (numpy, kept on the plan).

    slot (nA, 4): `ops.ace.slot_table`; lab_t (nl + 1): the terms of label
    l, whose rows of t_fact are sorted by label; the nonzero entries of
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
    slot = ops.slot_table(plan)
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
        slot=slot, lab_t=lab_t, lab_e=i32(lab_e), e_slot=i32(e_slot),
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
            slot=i32(h.slot), lab_t=i32(h.lab_t), lab_e=i32(h.lab_e),
            e_slot=i32(h.e_slot), e_lab=i32(h.e_lab), e_c=i32(h.e_c),
            c_tr=i32(h.c_tr), el_l=i32(h.el_l), fact=i32(plan.t_fact),
            coef=torch.as_tensor(np.asarray(plan.t_coef, np.float64),
                                 device=device))
        plan.tables[key] = tabs
    return tabs


def _kernel_conventions(plan):
    if plan.radial != "pace_px" or plan.ylm != "4pi" or plan.spline_delta:
        raise NotImplementedError(
            f"ACE kernels take radial='pace_px', ylm='4pi' and no spline "
            f"radials; this plan has radial={plan.radial!r}, "
            f"ylm={plan.ylm!r}, spline_delta={plan.spline_delta!r} (the "
            f"plain versions keep them)")
    if plan.lmax > _LMAX:
        raise ValueError(f"ACE kernels: lmax {plan.lmax} > {_LMAX}")


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
    _kernel_conventions(plan)
    N, K = mask.shape
    kl.check(disp, "disp", torch.float64, (N, K, 3))
    kl.check(jelem, "jelem", torch.int32, (N, K))
    kl.check(mask, "mask", torch.bool, (N, K))
    kl.check(ielem, "ielem", torch.int32, (N,))
    nA, nrad, ny = plan.nA, plan.nradbase, (plan.lmax + 1) ** 2
    smem = 8 * (_K13_TILE * (2 * nrad + 3 + 8 * ny)
                + (_K13_TILE + 1) * 2 * nA) + 4 * _K13_TILE
    if smem > kl.SMEM_LIMIT:
        raise ValueError(f"ace_pair_basis: {smem} bytes of shared memory "
                         f"per block")
    dev = disp.device
    bonds = ops.plan_tensors(plan, dev)
    tabs = _device_tables(plan, dev)
    A = torch.empty((N, 2 * nA), dtype=torch.float64, device=dev)
    Jp = torch.empty((3, N, K, 2 * nA), dtype=torch.float64, device=dev)
    inner = int(np.any(np.asarray(plan.rcinner) > 0.0))
    kl.launch("ace_pair_basis", dev, kl.ptr(disp), kl.ptr(jelem),
              kl.ptr(mask), kl.ptr(ielem), kl.ptr(bonds.rcut),
              kl.ptr(bonds.lmbda), kl.ptr(bonds.rcinner),
              kl.ptr(bonds.drcinner), plan.numtypes, inner,
              kl.ptr(tabs.slot), nA, nrad, plan.lmax, N, K, kl.ptr(A),
              kl.ptr(Jp))
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
    kl.check(A, "A", torch.float64, (N, 2 * nA))
    kl.check(Jp, "Jp", torch.float64, (3, N, K, 2 * nA))
    kl.check(ielem, "ielem", torch.int32, (N,))
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
