"""Wrappers of the CUDA kernels of the linear SNAP fit, with their plain
PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K1 pair_u_duals (_chem) | csrc/pair_u_duals.cu | ops/snap.py _ck_prologue, _pair_wu_duals, _utot_from_wu |
| K2 zlist (_chem) | csrc/zlist.cu | ops/snap.py _compute_zcat_pair (channel pairs :1005-1010) |
| K3 dbdd (_chem) | csrc/dbdd.cu (+ atom_gemm.cuh) | ops/snap.py _dbdu_ylist, _chem_b_and_dbdu + the contractions at :956-982 |
| K6q quad_chain | csrc/quad_chain.cu | ops/snap.py _quad_chain |
| K4 pair_scatter_rows | csrc/pair_scatter.cu | calculators/snap.py:326-343, ops/refpot.py:295-302 |
| K5 zbl_pair_grad | csrc/zbl_pair.cu | ops/refpot.py reference_eav (vjp), zbl_pair_energy |
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

_P, _I, _LL, _D = kl.P, kl.I, kl.LL, kl.D
kl.register("pair_u_duals", "pair_u_duals",
            [_P] * 5 + [_D] * 3 + [_I, _I, _LL, _I] + [_P] * 3 + [_I, _I]
            + [_P] * 3 + [_I] * 3 + [_P] * 5)
kl.register("zlist", "zlist", [_P, _LL, _I, _I] + [_P] * 4 + [_I] + [_P] * 3)
kl.register("dbdd", "dbdd", [_P] * 14 + [_LL] + [_I] * 7 + [_P] * 3)
kl.register("quad_chain", "quad_chain", [_P] * 5 + [_LL] + [_I] * 3
            + [_P] * 3)
kl.register("pair_scatter_rows", "pair_scatter",
            [_P] * 5 + [_I] * 7 + [_P] * 4)
kl.register("zbl_pair_grad", "zbl_pair",
            [_P] * 5 + [_I] * 4 + [_D, _D] + [_P] * 4)
kl.register("device_neighbors", "device_neighbors",
            [_P] * 5 + [_I] * 4 + [_D] + [_P] * 4)
kl.register("reverse_table", "device_neighbors",
            [_P, _P] + [_I] * 4 + [_P] * 3)
kl.register("normal_contrib", "normal_contrib",
            [_P] * 15 + [_I] * 14 + [_P] * 6)


# ---------------------------------------------------------------------------
# K1: pair U expansion with tangents, and its neighbor sum
# ---------------------------------------------------------------------------


def _channels(p, chem, name):
    """Refuse a plan whose channel count is not the wrapper's mode."""
    if (p.nchem > 1) != chem:
        other = name[:-len("_chem")] if chem else name + "_chem"
        raise ValueError(f"{name}: the plan has {p.nchem} utot channel(s); "
                         f"use {other}")


def pair_u_duals_plain(disp, jelem, mask, ielem, p):
    """Plain K1, both modes: (wu (N, K, 2U), J (3, N, K, 2U), ut (N,
    nchem*2U))."""
    wu, J = ops._pair_wu_duals(disp, jelem, mask, ielem, p)
    return wu, J, ops._utot_from_wu(wu, jelem, ielem, p)


_K1_THREADS = 640   # threads (U columns) of a block of csrc/pair_u_duals.cu
_K1_CHEM = 4        # utot channels it is compiled for


def _pair_u_duals_launch(disp, jelem, mask, ielem, p):
    N, K = mask.shape
    two_u = 2 * p.u_len
    if two_u > _K1_THREADS:
        raise ValueError(f"pair_u_duals: 2U = {two_u} exceeds the "
                         f"{_K1_THREADS} columns of a block (twojmax <= 8)")
    if p.nchem > _K1_CHEM:
        raise ValueError(f"pair_u_duals_chem: {p.nchem} element channels; "
                         f"the kernel takes at most {_K1_CHEM}")
    _check(disp, "disp", torch.float64, (N, K, 3))
    _check(jelem, "jelem", torch.int32, (N, K))
    _check(mask, "mask", torch.bool, (N, K))
    _check(ielem, "ielem", torch.int32, (N,))
    dev = disp.device
    wu = torch.empty((N, K, two_u), dtype=torch.float64, device=dev)
    J = torch.empty((3, N, K, two_u), dtype=torch.float64, device=dev)
    ut = torch.empty((N, p.nchem * two_u), dtype=torch.float64, device=dev)
    _launch("pair_u_duals", dev,
            _ptr(disp), _ptr(jelem), _ptr(mask), _ptr(ielem), _ptr(p.elem),
            p.rcutfac, p.rfac0, p.rmin0, int(p.switchflag),
            int(p.switchinnerflag), N, K, _ptr(p.mono_parent),
            _ptr(p.mono_var), _ptr(p.mono_levels_t),
            len(p.mono_levels) - 1, p.mono_parent.shape[0],
            _ptr(p.l_ptr), _ptr(p.l_row), _ptr(p.l_val), two_u, p.nchem,
            int(p.wselfallflag), _ptr(p.selfvec), _ptr(wu), _ptr(J), _ptr(ut))
    return wu, J, ut


def pair_u_duals(disp, jelem, mask, ielem, p):
    """K1 on the card, one channel: disp (N, K, 3) f64, jelem (N, K) i32,
    mask (N, K) bool, ielem (N,) i32.  Same outputs as
    `pair_u_duals_plain`."""
    if _on_cpu(disp, jelem, mask, ielem):
        return pair_u_duals_plain(disp, jelem, mask, ielem, p)
    _channels(p, False, "pair_u_duals")
    out = _pair_u_duals_launch(disp, jelem, mask, ielem, p)
    pair_u_duals.launches += 1
    return out


def pair_u_duals_chem(disp, jelem, mask, ielem, p):
    """K1 on the card, chemflag mode: each neighbor summed into the utot
    channel of its element; ut (N, nchem*2U).  Arguments as
    `pair_u_duals`."""
    if _on_cpu(disp, jelem, mask, ielem):
        return pair_u_duals_plain(disp, jelem, mask, ielem, p)
    _channels(p, True, "pair_u_duals_chem")
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


def _zlist_launch(ut, p):
    N, nc = ut.shape[0], p.nchem
    _check(ut, "ut", torch.float64, (N, nc * 2 * p.u_len))
    zr = torch.empty((N, nc * nc, p.nz), dtype=torch.float64,
                     device=ut.device)
    zi = torch.empty_like(zr)
    _launch("zlist", ut.device, _ptr(ut), N, 2 * p.u_len, nc, _ptr(p.z_ptr),
            _ptr(p.z_i1), _ptr(p.z_i2), _ptr(p.z_c), p.nz, _ptr(zr),
            _ptr(zi))
    return zr, zi


def zlist(ut, p):
    """K2 on the card: ut (N, 2U) f64 -> (z_r, z_i) (N, nz)."""
    if _on_cpu(ut):
        return zlist_plain(ut, p)
    _channels(p, False, "zlist")
    zr, zi = _zlist_launch(ut, p)
    zlist.launches += 1
    return zr[:, 0], zi[:, 0]


def zlist_chem(ut, p):
    """K2 on the card, chemflag mode: ut (N, nchem*2U) f64 -> (z_r, z_i)
    (N, nchem^2, nz), every ordered channel pair in one launch."""
    if _on_cpu(ut):
        return zlist_chem_plain(ut, p)
    _channels(p, True, "zlist_chem")
    out = _zlist_launch(ut, p)
    zlist_chem.launches += 1
    return out


zlist.launches = 0
zlist_chem.launches = 0


# ---------------------------------------------------------------------------
# K3: dB/dutot, B and the pair jacobian dB/dD
# ---------------------------------------------------------------------------

def dbdd_tiles(p, K=64):
    """(rows of W per block, blocks per atom) of csrc/dbdd.cu at K neighbor
    slots: one channel's y rows (2U + pad doubles each) beside the neighbor
    lists, the zero-block flags and the product's epilogue stage, two
    blocks an SM where they fit."""
    ldl = kl.ag_ldl(2 * p.u_len)
    return kl.row_plan(p.nb_base, 8 * ldl, kl.AG_STAGE_BYTES
                       + 4 * (2 * K + 2) + 2 * ldl // 8, "dbdd")


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
        tg_ptr=torch.as_tensor(np.searchsorted(t, np.arange(p.ntriples + 1)),
                               dtype=i32, device=p.device),
        tg_u=torch.as_tensor(u, dtype=i32, device=p.device),
        tg_src=torch.as_tensor(np.ascontiguousarray(src[:, t, u].T),
                               dtype=i32, device=p.device),
        tg_fac=torch.as_tensor(np.ascontiguousarray(fac[:, t, u].T),
                               device=p.device))
    return p.k3


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
    _check(ut, "ut", torch.float64, (N, nc * 2 * U))
    zshape = (N, nc * nc, p.nz) if nc > 1 else (N, p.nz)
    _check(z_r, "z_r", torch.float64, zshape)
    _check(z_i, "z_i", torch.float64, zshape)
    _check(J, "J", torch.float64, (3, N, K, 2 * U))
    if jelem is not None:
        _check(jelem, "jelem", torch.int32, (N, K))
    mt, tiles = dbdd_tiles(p, K)
    tg = dbdd_tables(p)
    dev = ut.device
    bzero = p.bzero if p.bzeroflag else torch.zeros_like(p.bzero)
    B = torch.empty((N, W), dtype=torch.float64, device=dev)
    dBdD = torch.empty((N, W, K, 3), dtype=torch.float64, device=dev)
    _launch("dbdd", dev, _ptr(ut), _ptr(z_r), _ptr(z_i), _ptr(J),
            _ptr(jelem) if jelem is not None else None, _ptr(tg.tg_ptr),
            _ptr(tg.tg_u), _ptr(tg.tg_src), _ptr(tg.tg_fac), _ptr(p.y_src),
            _ptr(p.y_fac), _ptr(p.blk_chan), _ptr(p.blk_pair), _ptr(bzero),
            N, K, p.ntriples, U, p.nz, nc, mt, tiles, _ptr(B), _ptr(dBdD))
    return B, dBdD


def dbdd(ut, z_r, z_i, J, p):
    """K3 on the card: ut (N, 2U), z_r, z_i (N, nz), J (3, N, K, 2U)."""
    if _on_cpu(ut, z_r, z_i, J):
        return dbdd_plain(ut, z_r, z_i, J, p)
    _channels(p, False, "dbdd")
    out = _dbdd_launch(ut, z_r, z_i, J, None, p)
    dbdd.launches += 1
    return out


def dbdd_chem(ut, z_r, z_i, J, jelem, p):
    """K3 on the card, chemflag mode: ut (N, nchem*2U), z_r, z_i (N,
    nchem^2, nz), J (3, N, K, 2U), jelem (N, K) int32 (the neighbors'
    elements, their utot channels)."""
    if _on_cpu(ut, z_r, z_i, J, jelem):
        return dbdd_chem_plain(ut, z_r, z_i, J, jelem, p)
    _channels(p, True, "dbdd_chem")
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
    N, W, K = dBdD.shape[:3]
    if not p.quadraticflag or W != p.nb_base:
        raise ValueError(f"quad_chain: width {W} is not the plan's base "
                         f"width {p.nb_base} with quadraticflag")
    _check(B, "B", torch.float64, (N, W))
    _check(dBdD, "dBdD", torch.float64, (N, W, K, 3))
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


def pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes):
    """Plain K4: (force (C, A, 3, T, X), virial (C, 6, T, X)).

    g (C, A, X, K, 3) per-pair gradients; disp (C, A, K, 3); vmask
    (C, A, K) pairs that enter the virial; rev (C, A, R) reverse neighbor
    table (flat slots i*K + k, -1 padded); types (C, A) source types.
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


def pair_scatter_rows(g, disp, vmask, rev, types, ntypes):
    """K4 on the card; same arguments and outputs as the plain version."""
    if _on_cpu(g, disp, vmask, rev, types):
        return pair_scatter_rows_plain(g, disp, vmask, rev, types, ntypes)
    C, A, X, K, _ = g.shape
    R = rev.shape[2]
    _check(g, "g", torch.float64, (C, A, X, K, 3))
    _check(disp, "disp", torch.float64, (C, A, K, 3))
    _check(vmask, "vmask", torch.bool, (C, A, K))
    _check(rev, "rev", torch.int32, (C, A, R))
    _check(types, "types", torch.int32, (C, A))
    dev = g.device
    force = torch.empty((C, A, 3, ntypes, X), dtype=torch.float64,
                        device=dev)
    virial = torch.empty((C, 6, ntypes, X), dtype=torch.float64, device=dev)
    vpart = torch.empty((C, A, 6, X), dtype=torch.float64, device=dev)
    _launch("pair_scatter_rows", dev, _ptr(g), _ptr(disp), _ptr(vmask),
            _ptr(rev), _ptr(types), C, A, X, K, R, ntypes,
            pair_scatter_tile(X, K), _ptr(vpart), _ptr(force), _ptr(virial))
    pair_scatter_rows.launches += 1
    return force, virial


pair_scatter_rows.launches = 0

# ---------------------------------------------------------------------------
# K5: ZBL pair energy and its gradient in closed form
# ---------------------------------------------------------------------------

# LAMMPS pair_zbl universal screening function (the constants of
# csrc/zbl_pair.cu)
ZBL_C = (0.02817, 0.28022, 0.50986, 0.18175)
ZBL_D = (0.20162, 0.40290, 0.94229, 3.19980)


def zbl_pair_grad_plain(disp, jidx, mask, types, table, cut_inner,
                        cut_outer):
    """Plain K5: (g (C, A, K, 3), energy (C,)).

    disp (C, A, K, 3) pair displacements; jidx, mask (C, A, K); types
    (C, A); table (T, T, 6) rows (pre, a, sw3, sw4, sw5, active) per type
    pair.  g = 0.5 e'(r) D / r per pair (zero for masked pairs), energy =
    0.5 sum e per config.
    """
    C, A, K = mask.shape
    ti = types.long()[:, :, None].expand(C, A, K)
    tj = torch.gather(types.long(), 1, jidx.long().reshape(C, A * K))
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
    g = (0.5 * de / r)[..., None] * safe
    return g, 0.5 * e.sum(dim=(1, 2))


def zbl_pair_grad(disp, jidx, mask, types, table, cut_inner, cut_outer):
    """K5 on the card; same arguments and outputs as the plain version."""
    if _on_cpu(disp, jidx, mask, types, table):
        return zbl_pair_grad_plain(disp, jidx, mask, types, table,
                                   cut_inner, cut_outer)
    C, A, K = mask.shape
    T = table.shape[0]
    _check(disp, "disp", torch.float64, (C, A, K, 3))
    _check(jidx, "jidx", torch.int32, (C, A, K))
    _check(mask, "mask", torch.bool, (C, A, K))
    _check(types, "types", torch.int32, (C, A))
    _check(table, "table", torch.float64, (T, T, 6))
    dev = disp.device
    e_atom = torch.empty((C, A), dtype=torch.float64, device=dev)
    g = torch.empty((C, A, K, 3), dtype=torch.float64, device=dev)
    energy = torch.zeros((C,), dtype=torch.float64, device=dev)
    _launch("zbl_pair_grad", dev, _ptr(disp), _ptr(jidx), _ptr(mask),
            _ptr(types), _ptr(table), C, A, K, T, float(cut_inner),
            float(cut_outer), _ptr(e_atom), _ptr(g), _ptr(energy))
    zbl_pair_grad.launches += 1
    return g, energy


zbl_pair_grad.launches = 0

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


def device_neighbors(pos_hi, pos_lo, svec_hi, svec_lo, natoms, cutoff,
                     k_pad):
    """K8 on the card; same arguments and outputs as the plain version
    (natoms int32)."""
    C, A, S = _neighbor_args(pos_hi, svec_hi, k_pad)
    if _on_cpu(pos_hi, pos_lo, svec_hi, svec_lo, natoms):
        return device_neighbors_plain(pos_hi, pos_lo, svec_hi, svec_lo,
                                      natoms, cutoff, k_pad)
    for t, name, shape in ((pos_hi, "pos_hi", (C, A, 3)),
                           (pos_lo, "pos_lo", (C, A, 3)),
                           (svec_hi, "svec_hi", (C, S, 3)),
                           (svec_lo, "svec_lo", (C, S, 3))):
        _check(t, name, torch.float64, shape)
    _check(natoms, "natoms", torch.int32, (C,))
    if 12 * S * A > _SMEM_LIMIT - 1024:
        raise ValueError(f"device_neighbors: {S} x {A} candidates exceed "
                         f"one block's shared memory")
    dev = pos_hi.device
    disp = torch.empty((C, A, k_pad, 3), dtype=torch.float64, device=dev)
    jidx = torch.empty((C, A, k_pad), dtype=torch.int32, device=dev)
    mask = torch.empty((C, A, k_pad), dtype=torch.bool, device=dev)
    _launch("device_neighbors", dev, _ptr(pos_hi), _ptr(pos_lo),
            _ptr(svec_hi), _ptr(svec_lo), _ptr(natoms), C, A, S, k_pad,
            float(cutoff), _ptr(disp), _ptr(jidx), _ptr(mask))
    device_neighbors.launches += 1
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
    """Plain K7: (AtA (W, W), Atb (W,), nrows ()) of a batch, float64.

    rows, truths, const_cols, layout: as for `full_rows`; weights, flags:
    as for `row_weights`.  With `coeff`, b is replaced by the residual
    b - a . coeff.
    """
    a, b = full_rows(rows, truths, natoms, types, numtypes, const_cols,
                     layout)
    A = types.shape[1]
    w = row_weights(weights, natoms, A, flags)
    if coeff is not None:
        b = b - a @ coeff
    aw = a * w[..., None]
    bw = b * w
    W = a.shape[2]
    AtA = torch.einsum("crp,crq->pq", aw, aw) if with_ata \
        else a.new_zeros((W, W))
    ones = torch.ones_like(weights[0])
    nrows = row_weights((ones, ones, ones), natoms, A, flags).sum()
    return AtA, torch.einsum("crp,cr->p", aw, bw), nrows


def normal_contrib(rows, truths, weights, natoms, types, numtypes,
                   const_cols, flags, coeff=None, with_ata=True,
                   layout="snap"):
    """K7 on the card; same arguments and outputs as the plain version
    (natoms and types int32)."""
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
    for t, name, shape in zip(tensors, names, shapes):
        _check(t, name, torch.float64, shape)
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
    # without AtA the kernel writes Atb only, and AtA is zero
    AtA = (torch.empty if with_ata else torch.zeros)(
        (W, W), dtype=torch.float64, device=dev)
    Atb = torch.empty((W,), dtype=torch.float64, device=dev)
    nrows = torch.empty((), dtype=torch.float64, device=dev)
    _launch("normal_contrib", dev, *[_ptr(t) for t in tensors[:14]],
            _ptr(coeff) if coeff is not None else None, C, A, T, Wr, W,
            0 if not const_cols else (2 if layout == "ace" else 1),
            int(bool(flags["energy"])),
            int(bool(flags["force"])), int(bool(flags["stress"])),
            int(bool(with_ata)), _NC_TILE, ntiles, nslab, slab_rows,
            _ptr(aw), _ptr(partial), _ptr(AtA), _ptr(Atb), _ptr(nrows))
    normal_contrib.launches += 1
    return AtA, Atb, nrows


normal_contrib.launches = 0

KERNELS = (pair_u_duals, zlist, dbdd, pair_scatter_rows, zbl_pair_grad,
           normal_contrib, device_neighbors, reverse_table, pair_u_duals_chem,
           zlist_chem, dbdd_chem, quad_chain)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}
