"""SNAP bispectrum descriptors and their pair jacobian, in plain PyTorch.

Counterpart of `fitsnap_tpu/ops/snap.py` for the linear path: one element
channel or explicit multi-element channels (chemflag), with or without the
quadratic extension (quadraticflag).  A config is a padded (A, K) block of
atoms x neighbors; complex values are carried as (real, imag) pairs with the
same flat layouts as the JAX package, so every intermediate can be compared
with its JAX twin element by element.

The functions here are the plain versions: they run on any device and are
what the CPU takes.  `descriptors_with_jacobian` composes the kernels of
`fitsnap_tpu_torch.kernels.snap_kernels` (K1 pair U duals, K2 z-lists, K3
dB/dD, each with a chemflag mode, and K6q the quadratic product rule);
their wrappers launch the hand-written CUDA kernels for CUDA tensors and
fall to these plain versions only for CPU tensors.
"""

import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from fitsnap_tpu_torch.ops.cg import build_snap_plan, rootpq_tables, sym_signs
from fitsnap_tpu_torch.ops.mono import mono_plan


@dataclass
class SnapParams:
    """SNAP hyperparameters and plan tables, as tensors on one device.

    Scalars stay Python numbers; every table is a tensor on `device`.
    """

    twojmax: int
    u_len: int
    ntriples: int
    rcutfac: float
    rfac0: float
    rmin0: float
    switchflag: bool
    switchinnerflag: bool
    bzeroflag: bool
    wself: float
    device: torch.device
    radelem: torch.Tensor            # (nelem,) f64
    wj: torch.Tensor                 # (nelem,) f64
    sinner: Optional[torch.Tensor]   # (nelem,) f64 or None
    dinner: Optional[torch.Tensor]
    elem: torch.Tensor               # (nelem, 4): radelem, wj, sinner, dinner
    # element channels (chemflag) and the quadratic extension
    chemflag: bool                   # explicit multi-element descriptors
    nchem: int                       # channels of utot: nelements or 1
    wselfallflag: bool               # self term in every channel
    nb_base: int                     # columns before the quadratic ones
    quadraticflag: bool
    iq1: torch.Tensor                # (nq,) int32: first factor of each product
    iq2: torch.Tensor                # (nq,) int32: second factor
    qcoef: torch.Tensor              # (nq,) f64: 0.5 on the diagonal, else 1
    blk_chan: torch.Tensor           # (nchem^3, 3) int32: channel of each y-layer
    blk_pair: torch.Tensor           # (nchem^3, 3) int32: z channel pair it reads
    # trilinear B plan (recursion oracle)
    i1: torch.Tensor
    i2: torch.Tensor
    i3: torch.Tensor
    mmat: torch.Tensor               # (nterms_base, ntriples)
    bzero: torch.Tensor              # (nb_base,)
    self_idx: torch.Tensor           # (ndiag,) long: real diagonal of U
    selfvec: torch.Tensor            # (2U,) f64: wself on the real diagonal
    # y-list plan: dB/dutot gathered from the z-lists
    y_src: torch.Tensor              # (3, ntriples, U) int32 into the flat z layout
    y_fac: torch.Tensor              # (3, ntriples, U) f64
    # z-list as a compact term list, CSR over the flat z output index
    nz: int
    z_ptr: torch.Tensor              # (nz+1,) int32
    z_i1: torch.Tensor               # (nterms,) int32 into u (first factor)
    z_i2: torch.Tensor               # (nterms,) int32 into u (second factor)
    z_c: torch.Tensor                # (nterms,) f64 CG*CG coefficient
    z_out: torch.Tensor              # (nterms,) long: output index of each term
    # monomial change of basis (ops/mono.py)
    mono_parent: torch.Tensor        # (n_mono,) int32
    mono_var: torch.Tensor           # (n_mono,) int32
    mono_levels: tuple               # degree-level boundaries into the monomials
    L: torch.Tensor                  # (n_mono, 2U) f64 dense
    # pair-grid tables of the NN cached mode, built at first use
    # (`nn_tables`)
    nn: Optional["NnTables"] = None
    # K1's column entries and split plans, K2's term schedule and K3's
    # compact y targets, built at first use (`kernels.snap_kernels`
    # `pair_u_tables`, `zlist_tables`, `dbdd_tables`)
    k1: Optional[dict] = None
    k2: Optional[object] = None
    k3: Optional[object] = None
    # the type of the float tables, and the copies at other types (`cast`)
    dtype: torch.dtype = torch.float64
    casts: Optional[dict] = None

    def cast(self, dtype):
        """The plan at `dtype`, the rows' type: itself at its own type,
        else (float32 from the float64 plan) a copy whose float tables are
        each rounded once from the float64 values, as the JAX package's
        `jnp.asarray(x, float32)` rounds its host tables, kept on this plan
        (one copy a type; the plan lives on one device).  The copy builds
        its kernels' host plans (`k1`, `k2`, `k3`) anew from its own
        tables at first use."""
        if dtype == self.dtype:
            return self
        if self.dtype != torch.float64 or dtype != torch.float32:
            raise TypeError(f"SnapParams: no {dtype} copy of a {self.dtype} "
                            f"plan (float32 copies of the float64 plan)")
        if self.casts is None:
            self.casts = {}
        if dtype not in self.casts:
            vals = {}
            for f in fields(self):
                v = getattr(self, f.name)
                if torch.is_tensor(v) and v.is_floating_point():
                    v = v.to(dtype)
                vals[f.name] = v
            vals.update(dtype=dtype, nn=None, k1=None, k2=None, k3=None,
                        casts=None)
            self.casts[dtype] = SnapParams(**vals)
        return self.casts[dtype]


def z_term_list(z_groups, D):
    """Compact (out, i1, i2, coef) z-list terms from the padded TPU tables.

    `z_groups` are the grouped term GEMM tables of `cg.build_snap_plan`
    (gi1, gi2 (Tg, P) and M (Tg, P, D*D)), in z-triple order.  Each nonzero
    of M becomes one term of the flat output index t * D*D + column, so the
    layout equals `_compute_zcat`'s and `y_src` indexes it unchanged.
    Returns numpy arrays sorted by output index.
    """
    outs, a1, a2, cs = [], [], [], []
    t0 = 0
    for g in z_groups:
        gi1, gi2, M = (np.asarray(g["gi1"]), np.asarray(g["gi2"]),
                       np.asarray(g["M"]))
        ti, k, col = np.nonzero(M)
        outs.append((t0 + ti) * D * D + col)
        a1.append(gi1[ti, k])
        a2.append(gi2[ti, k])
        cs.append(M[ti, k, col])
        t0 += M.shape[0]
    out = np.concatenate(outs)
    order = np.argsort(out, kind="stable")
    return (out[order].astype(np.int64), np.concatenate(a1)[order],
            np.concatenate(a2)[order], np.concatenate(cs)[order], t0 * D * D)


def params_from_arrays(d: dict, device) -> SnapParams:
    """Build `SnapParams` from host numpy arrays (see `convert.py`).

    Keys: twojmax, rcutfac, rfac0, rmin0, switchflag, switchinnerflag,
    bzeroflag, wself, radelem, wj, sinner, dinner (or None), and the plan
    fields i1, i2, i3, mmat, bzero, self_idx, y_src, y_fac, z_dense,
    nelements, chemflag, wselfallflag, quadraticflag, nb_base, iq1, iq2,
    qcoef.
    """
    device = torch.device(device)
    f64, i32 = torch.float64, torch.int32

    def t(x, dtype=f64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    twojmax = int(d["twojmax"])
    y_src = np.asarray(d["y_src"])
    u_len = y_src.shape[2]
    exps, parent, var, L = mono_plan(twojmax)
    deg = np.asarray(exps).sum(1)
    levels = tuple(int(x) for x in np.searchsorted(deg, np.arange(twojmax + 2)))
    z_out, z_i1, z_i2, z_c, nz = z_term_list(d["z_dense"]["groups"],
                                             int(d["z_dense"]["D"]))
    z_ptr = np.searchsorted(z_out, np.arange(nz + 1))
    self_idx = np.asarray(d["self_idx"], np.int64)
    selfvec = np.zeros(2 * u_len)
    selfvec[self_idx] = float(d["wself"])
    sw_in = bool(d["switchinnerflag"])
    nelem = len(np.atleast_1d(d["radelem"]))
    nchem = int(d["nelements"]) if d["chemflag"] else 1
    # block (e1, e2, e3) of the chemflag columns: y-layer 0 reads z^(e1,e2)
    # into channel e3, layer 1 z^(e3,e2) into e1, layer 2 z^(e3,e1) into e2
    blocks = [(e1, e2, e3) for e1 in range(nchem) for e2 in range(nchem)
              for e3 in range(nchem)]
    blk_chan = [(e3, e1, e2) for e1, e2, e3 in blocks]
    blk_pair = [(e1 * nchem + e2, e3 * nchem + e2, e3 * nchem + e1)
                for e1, e2, e3 in blocks]
    inner = [d["sinner"], d["dinner"]] if sw_in else [np.zeros(nelem)] * 2
    elem = np.stack([np.atleast_1d(np.asarray(x, np.float64))
                     for x in [d["radelem"], d["wj"]] + inner], 1)
    return SnapParams(
        twojmax=twojmax, u_len=u_len, ntriples=y_src.shape[1],
        rcutfac=float(d["rcutfac"]), rfac0=float(d["rfac0"]),
        rmin0=float(d["rmin0"]), switchflag=bool(d["switchflag"]),
        switchinnerflag=sw_in, bzeroflag=bool(d["bzeroflag"]),
        wself=float(d["wself"]), device=device,
        chemflag=bool(d["chemflag"]), nchem=nchem,
        wselfallflag=bool(d["wselfallflag"]),
        nb_base=int(d["nb_base"]), quadraticflag=bool(d["quadraticflag"]),
        iq1=t(d["iq1"], i32), iq2=t(d["iq2"], i32),
        qcoef=t(d["qcoef"]), blk_chan=t(blk_chan, i32),
        blk_pair=t(blk_pair, i32),
        radelem=t(d["radelem"]), wj=t(d["wj"]),
        sinner=t(d["sinner"]) if sw_in else None,
        dinner=t(d["dinner"]) if sw_in else None, elem=t(elem),
        i1=t(d["i1"], torch.long), i2=t(d["i2"], torch.long),
        i3=t(d["i3"], torch.long), mmat=t(d["mmat"]), bzero=t(d["bzero"]),
        self_idx=t(self_idx, torch.long), selfvec=t(selfvec),
        y_src=t(y_src, i32), y_fac=t(d["y_fac"]),
        nz=int(nz), z_ptr=t(z_ptr, i32), z_i1=t(z_i1, i32),
        z_i2=t(z_i2, i32), z_c=t(z_c), z_out=t(z_out, torch.long),
        mono_parent=t(parent, i32), mono_var=t(var, i32),
        mono_levels=levels, L=t(L),
    )


def make_params(section, device) -> SnapParams:
    """Build SnapParams from a BISPECTRUM config section on `device`."""
    twojmax = int(max(int(t) for t in section.twojmax))
    plan = build_snap_plan(
        twojmax=twojmax, nelements=section.numtypes,
        chemflag=bool(section.chemflag), bnormflag=bool(section.bnormflag),
        bzeroflag=bool(section.bzeroflag),
        wselfallflag=bool(section.wselfallflag),
        quadraticflag=bool(section.quadraticflag))
    sw_in = bool(section.switchinnerflag)
    d = {name: getattr(plan, name) for name in (
        "i1", "i2", "i3", "mmat", "bzero", "self_idx", "y_src", "y_fac",
        "z_dense", "bzeroflag", "nelements", "chemflag", "wselfallflag",
        "quadraticflag", "nb_base", "iq1", "iq2", "qcoef")}
    d.update(
        twojmax=twojmax, rcutfac=float(section.rcutfac),
        rfac0=float(section.rfac0), rmin0=float(section.rmin0),
        switchflag=bool(section.switchflag), switchinnerflag=sw_in,
        wself=1.0,
        wj=[float(x) for x in section.wj],
        radelem=[float(x) for x in section.radelem],
        sinner=[float(x) for x in section.sinner.split()] if sw_in else None,
        dinner=[float(x) for x in section.dinner.split()] if sw_in else None)
    return params_from_arrays(d, device)


# ---------------------------------------------------------------------------
# Scalar prologue and the recursion oracle
# ---------------------------------------------------------------------------


def compute_sfac(r, rcutij, rmin0, switchflag, sinnerij=None, dinnerij=None,
                 switchinnerflag=False):
    """LAMMPS SNA switching function (outer cosine ramp, optional inner)."""
    if switchflag:
        rscale = math.pi / (rcutij - rmin0)
        ramp = 0.5 * (torch.cos((r - rmin0) * rscale) + 1.0)
        sfac = torch.where(r <= rmin0, torch.ones_like(r),
                           torch.where(r > rcutij, torch.zeros_like(r), ramp))
    else:
        sfac = torch.ones_like(r)
    if switchinnerflag:
        arg = torch.clamp((r - sinnerij) * (0.5 * math.pi) / dinnerij,
                          -0.5 * math.pi, 0.5 * math.pi)
        inner = 0.5 * (1.0 - torch.cos(0.5 * math.pi + arg))
        inner = torch.where(r >= sinnerij + dinnerij, torch.ones_like(r),
                            inner)
        inner = torch.where(r <= sinnerij - dinnerij, torch.zeros_like(r),
                            inner)
        sfac = sfac * inner
    return sfac


def _ck_prologue(disp, jelem, mask, ielem, p: SnapParams):
    """Per-pair Cayley-Klein parameters and switching weight.

    Returns (ar, ai, br, bi, w), each (A, K).  Masked pairs get the safe
    displacement (1, 0, 0) and weight 0.
    """
    safe = torch.where(mask[..., None], disp,
                       disp.new_tensor([1.0, 0.0, 0.0]))
    x, y, z = safe[..., 0], safe[..., 1], safe[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    rcutij = (p.radelem[ielem][:, None] + p.radelem[jelem]) * p.rcutfac
    theta0 = (r - p.rmin0) * (p.rfac0 * math.pi) / (rcutij - p.rmin0)
    z0 = r / torch.tan(theta0)
    r0inv = 1.0 / torch.sqrt(r * r + z0 * z0)
    ar, ai = r0inv * z0, -r0inv * z
    br, bi = r0inv * y, -r0inv * x
    sinnerij = dinnerij = None
    if p.switchinnerflag:
        sinnerij = 0.5 * (p.sinner[ielem][:, None] + p.sinner[jelem])
        dinnerij = 0.5 * (p.dinner[ielem][:, None] + p.dinner[jelem])
    sfac = compute_sfac(r, rcutij, p.rmin0, p.switchflag,
                        sinnerij, dinnerij, p.switchinnerflag)
    w = torch.where(mask, sfac * p.wj[jelem], torch.zeros_like(r))
    return ar, ai, br, bi, w


def compute_ulist(ar, ai, br, bi, twojmax):
    """Wigner-U expansion per pair via the LAMMPS two-term recursion.

    Returns a list over j of (ur, ui), each (..., j+1, j+1) indexed [mb, ma].
    """
    dtype, device = ar.dtype, ar.device
    tables = rootpq_tables(twojmax)
    signs = sym_signs(twojmax)
    batch = ar.shape
    u = [(torch.ones(batch + (1, 1), dtype=dtype, device=device),
          torch.zeros(batch + (1, 1), dtype=dtype, device=device))]
    arx, aix = ar[..., None, None], ai[..., None, None]
    brx, bix = br[..., None, None], bi[..., None, None]
    pad = torch.nn.functional.pad
    for j in range(1, twojmax + 1):
        pr, pi = u[j - 1]
        # a-term source: prev at [mb, ma]; b-term source: prev at [mb, ma-1]
        pr_a, pi_a = pad(pr, (0, 1, 0, 1)), pad(pi, (0, 1, 0, 1))
        pr_b, pi_b = pad(pr, (1, 0, 0, 1)), pad(pi, (1, 0, 0, 1))
        ca, cb = (torch.as_tensor(c, dtype=dtype, device=device)
                  for c in tables[j - 1])
        ta_r = arx * pr_a + aix * pi_a
        ta_i = arx * pi_a - aix * pr_a
        tb_r = brx * pr_b + bix * pi_b
        tb_i = brx * pi_b - bix * pr_b
        half_r = ca * ta_r - cb * tb_r
        half_i = ca * ta_i - cb * tb_i
        # symmetry completion: u[j-mb, j-ma] = (-1)^(ma+mb) conj(u[mb, ma])
        sign = torch.as_tensor(signs[j - 1], dtype=dtype, device=device)
        sym_r = sign * half_r.flip(-1, -2)
        sym_i = -sign * half_i.flip(-1, -2)
        mb = torch.arange(j + 1, device=device)[:, None]
        low = (2 * mb <= j).expand(j + 1, j + 1)
        u.append((torch.where(low, half_r, sym_r),
                  torch.where(low, half_i, sym_i)))
    return u


def flatten_ulist(u):
    """Concatenate per-j U blocks into a flat (..., U) vector pair."""
    ur = torch.cat([x[0].flatten(-2) for x in u], -1)
    ui = torch.cat([x[1].flatten(-2) for x in u], -1)
    return ur, ui


def _channel_self(ielem, p: SnapParams, dtype):
    """Self term of every atom over the element channels: (A, nchem, 2U).

    wself on the real diagonal of U, in every channel under wselfallflag
    and in the atom's own channel otherwise (JAX `ops/snap.py:779-787`)."""
    if p.nchem == 1 or p.wselfallflag:
        on = torch.ones((ielem.shape[0], p.nchem), dtype=dtype,
                        device=ielem.device)
    else:
        on = torch.nn.functional.one_hot(ielem.long(), p.nchem).to(dtype)
    return on[:, :, None] * p.selfvec[None, None, :]


def compute_utot(disp, jelem, mask, ielem, p: SnapParams):
    """Neighbor-summed U expansion by the recursion: (utot_r, utot_i), each
    (A, nchem*U) with channel-major columns."""
    ar, ai, br, bi, w = _ck_prologue(disp, jelem, mask, ielem, p)
    ur, ui = flatten_ulist(compute_ulist(ar, ai, br, bi, p.twojmax))
    A, U = ur.shape[0], p.u_len
    if p.nchem == 1:
        chan = w[..., None]
    else:
        chan = torch.nn.functional.one_hot(jelem.long(), p.nchem).to(
            w.dtype) * w[..., None]
    self_term = _channel_self(ielem, p, w.dtype)[..., :U]
    utr = torch.einsum("akc,aku->acu", chan, ur) + self_term
    uti = torch.einsum("akc,aku->acu", chan, ui)
    return utr.reshape(A, -1), uti.reshape(A, -1)


def bispectrum_from_utot(utr, uti, p: SnapParams):
    """Trilinear CG contraction: utot (A, nchem*U) -> per-atom bispectrum B
    (A, nb_base), before the quadratic extension."""
    a_r, a_i = utr[:, p.i1], uti[:, p.i1]
    b_r, b_i = utr[:, p.i2], uti[:, p.i2]
    c_r, c_i = utr[:, p.i3], uti[:, p.i3]
    ab_r = a_r * b_r - a_i * b_i
    ab_i = a_r * b_i + a_i * b_r
    re = ab_r * c_r + ab_i * c_i               # Re[(u1*u2) * conj(u3)]
    A = re.shape[0]
    B = (re.reshape(A, p.nchem ** 3, -1) @ p.mmat).reshape(A, p.nb_base)
    if p.bzeroflag:
        B = B - p.bzero[None, :]
    return B


def _quad_extend(B, p: SnapParams):
    """B with its quadratic columns qcoef * B[iq1] * B[iq2] appended."""
    if not p.quadraticflag:
        return B
    return torch.cat([B, B[:, p.iq1] * B[:, p.iq2] * p.qcoef], 1)


def quad_fold(dEdB, B, p: SnapParams):
    """dE/dB (M, W + nq) of `_quad_extend(B)` -> dE/dB (M, W) of the base
    columns B (M, W), by the product rule: with q_m = qcoef_m B[iq1_m]
    B[iq2_m], dE/dq_m qcoef_m B[iq2_m] adds at iq1_m and dE/dq_m qcoef_m
    B[iq1_m] at iq2_m.  Differentiable in dE/dB (B takes no gradient)."""
    if not p.quadraticflag:
        return dEdB
    W = B.shape[1]
    dq = dEdB[:, W:] * p.qcoef
    return (dEdB[:, :W].index_add(1, p.iq1, dq * B[:, p.iq2])
            .index_add(1, p.iq2, dq * B[:, p.iq1]))


def atom_descriptors(disp, jelem, mask, ielem, p: SnapParams):
    """Per-atom SNAP descriptors by the recursion (the independent oracle),
    with the quadratic extension: (A, ncoeff)."""
    utr, uti = compute_utot(disp, jelem, mask, ielem, p)
    return _quad_extend(bispectrum_from_utot(utr, uti, p), p)


# ---------------------------------------------------------------------------
# Factorized derivatives: dB/dD = dB/dutot . d(utot)/dD  (plain versions)
# ---------------------------------------------------------------------------


def _prologue_duals(disp, jelem, mask, ielem, p: SnapParams):
    """Prologue values and their 3 displacement tangents.

    Returns (vals (5, A, K), tans (3, 5, A, K)) for (ar, ai, br, bi, w).
    """
    def scal(d):
        return torch.stack(_ck_prologue(d, jelem, mask, ielem, p))

    eye = torch.eye(3, dtype=disp.dtype, device=disp.device)
    tg = eye[:, None, None, :].expand((3,) + disp.shape)
    vals = scal(disp)
    tans = torch.func.vmap(
        lambda t: torch.func.jvp(scal, (disp,), (t,))[1])(tg)
    return vals, tans


def _pair_wu_duals(disp, jelem, mask, ielem, p: SnapParams):
    """Weighted per-pair U expansion with its displacement tangents.

    Returns (wu (A, K, 2U), J (3, A, K, 2U)).  The monomial chain of
    `ops/mono.py` runs level by level (monomials of one degree at a time)
    and the dense change of basis L maps it to U.
    """
    vals, tans = _prologue_duals(disp, jelem, mask, ielem, p)
    v = vals[:4].permute(1, 2, 0)                    # (A, K, 4)
    vt = tans[:, :4].permute(0, 2, 3, 1)             # (3, A, K, 4)
    wp, wt = vals[4], tans[:, 4]
    n_mono = p.mono_parent.shape[0]
    M = disp.new_zeros(disp.shape[:2] + (n_mono,))
    Mt = disp.new_zeros((3,) + disp.shape[:2] + (n_mono,))
    M[..., 0] = 1.0
    lv = p.mono_levels
    for s, e in zip(lv[1:-1], lv[2:]):
        pa, vi = p.mono_parent[s:e], p.mono_var[s:e]
        Mt[..., s:e] = Mt[..., pa] * v[..., vi][None] + M[..., pa][None] * vt[..., vi]
        M[..., s:e] = M[..., pa] * v[..., vi]
    U = M @ p.L
    Ut = Mt @ p.L
    wu = wp[..., None] * U
    J = wp[None, ..., None] * Ut + wt[..., None] * U[None]
    return wu, J


def _utot_from_wu(wu, jelem, ielem, p: SnapParams):
    """Sum pair contributions and the self term into (A, nchem*2U), channel
    major (chem, real|imag U): under chemflag each neighbor goes into the
    channel of its element."""
    if p.nchem == 1:
        return wu.sum(dim=1) + p.selfvec[None, :]
    oh = torch.nn.functional.one_hot(jelem.long(), p.nchem).to(wu.dtype)
    ut = torch.einsum("akc,aku->acu", oh, wu)
    return (ut + _channel_self(ielem, p, wu.dtype)).reshape(wu.shape[0], -1)


def _compute_zcat_pair(u1r, u1i, u2r, u2i, p: SnapParams):
    """z-lists of u1 with u2: sum over the compact CG*CG term list.

    Returns (z_r, z_i), each (A, nz) in the flat layout `y_src` indexes.
    """
    a_r, a_i = u1r[:, p.z_i1.long()], u1i[:, p.z_i1.long()]
    b_r, b_i = u2r[:, p.z_i2.long()], u2i[:, p.z_i2.long()]
    pr = (a_r * b_r - a_i * b_i) * p.z_c
    pi = (a_r * b_i + a_i * b_r) * p.z_c
    zr = u1r.new_zeros((u1r.shape[0], p.nz)).index_add_(1, p.z_out, pr)
    zi = u1r.new_zeros((u1r.shape[0], p.nz)).index_add_(1, p.z_out, pi)
    return zr, zi


def _compute_zcat(ut, p: SnapParams):
    """Flattened z-lists of utot (A, 2U) with itself: (z_r, z_i) (A, nz)."""
    U = p.u_len
    return _compute_zcat_pair(ut[:, :U], ut[:, U:], ut[:, :U], ut[:, U:], p)


def _dbdu_ylist(ut, p: SnapParams, zcat=None):
    """Analytic dB/dutot (A, W, 2U) from the three y-layers of the z-lists."""
    z_r, z_i = zcat if zcat is not None else _compute_zcat(ut, p)
    y_r = sum(p.y_fac[layer] * z_r[:, p.y_src[layer]] for layer in range(3))
    y_i = sum(p.y_fac[layer] * z_i[:, p.y_src[layer]] for layer in range(3))
    return torch.cat([y_r, y_i], dim=-1)


def _bispectrum_from_zcat(ut, zcat, p: SnapParams):
    """B as the contraction of utot with the fac-0 y-layer, minus bzero."""
    z_r, z_i = zcat
    U = p.u_len
    src0, fac0 = p.y_src[0], p.y_fac[0]
    B = (torch.einsum("au,atu->at", ut[:, :U], fac0 * z_r[:, src0])
         + torch.einsum("au,atu->at", ut[:, U:], fac0 * z_i[:, src0]))
    if p.bzeroflag:
        B = B - p.bzero[None, :]
    return B


def _compute_zcat_chem(ut, p: SnapParams):
    """z-lists of every ordered channel pair of utot (A, nchem*2U):
    (z_r, z_i), each (A, nchem^2, nz); pair ea*nchem + eb is the z-list of
    u_ea with u_eb."""
    A, U, nc = ut.shape[0], p.u_len, p.nchem
    uc = ut.reshape(A, nc, 2, U)
    pairs = [_compute_zcat_pair(uc[:, ea, 0], uc[:, ea, 1], uc[:, eb, 0],
                                uc[:, eb, 1], p)
             for ea in range(nc) for eb in range(nc)]
    return (torch.stack([z[0] for z in pairs], 1),
            torch.stack([z[1] for z in pairs], 1))


def _chem_b_and_dbdu(ut, p: SnapParams, zcat=None):
    """chemflag (explicit multi-element) descriptors and the analytic
    dB/dutot from the channel-paired z-lists.

    ut (A, nchem*2U).  Returns (B (A, nb_base), dBdu (A, nb_base, nchem,
    2U)).  Columns are blocks (e1, e2, e3) in loop order, each with the
    ntriples base triples; block (e1, e2, e3) reads z^(e1,e2) into channel
    e3, z^(e3,e2) into e1 and z^(e3,e1) into e2, and its B is u_e3 against
    the fac-0 layer of z^(e1,e2).
    """
    A, U, nc = ut.shape[0], p.u_len, p.nchem
    uc = ut.reshape(A, nc, 2, U)
    z_r, z_i = zcat if zcat is not None else _compute_zcat_chem(ut, p)
    s0, s1, s2 = p.y_src
    f0, f1, f2 = p.y_fac
    zeros = ut.new_zeros((A, p.ntriples, U))
    blocks_y, blocks_b = [], []
    for e1 in range(nc):
        for e2 in range(nc):
            for e3 in range(nc):
                z0r, z0i = z_r[:, e1 * nc + e2], z_i[:, e1 * nc + e2]
                z1r, z1i = z_r[:, e3 * nc + e2], z_i[:, e3 * nc + e2]
                z2r, z2i = z_r[:, e3 * nc + e1], z_i[:, e3 * nc + e1]
                chans = []
                for c in range(nc):
                    yr, yi = zeros, zeros
                    if c == e3:
                        yr = yr + f0 * z0r[:, s0]
                        yi = yi + f0 * z0i[:, s0]
                    if c == e1:
                        yr = yr + f1 * z1r[:, s1]
                        yi = yi + f1 * z1i[:, s1]
                    if c == e2:
                        yr = yr + f2 * z2r[:, s2]
                        yi = yi + f2 * z2i[:, s2]
                    chans.append(torch.cat([yr, yi], -1))
                blocks_y.append(torch.stack(chans, 2))
                blocks_b.append(
                    torch.einsum("au,atu->at", uc[:, e3, 0], f0 * z0r[:, s0])
                    + torch.einsum("au,atu->at", uc[:, e3, 1],
                                   f0 * z0i[:, s0]))
    B = torch.cat(blocks_b, 1)
    if p.bzeroflag:
        B = B - p.bzero[None, :]
    return B, torch.cat(blocks_y, 1)


def _quad_chain(B, dBdx, p: SnapParams):
    """Quadratic extension of descriptors and their jacobian by the
    product rule: B (A, W), dBdx (A, W, ...) with any trailing axes.
    Returns (B_ext (A, W + nq), dBdx_ext (A, W + nq, ...)), base columns
    first; column W + q is qcoef * B[iq1] * B[iq2]."""
    qc = p.qcoef
    tail = (None,) * (dBdx.ndim - 2)
    q = B[:, p.iq1] * B[:, p.iq2] * qc
    b1 = B[(slice(None), p.iq1) + tail]
    b2 = B[(slice(None), p.iq2) + tail]
    dq = qc[(None, slice(None)) + tail] * (b1 * dBdx[:, p.iq2]
                                           + b2 * dBdx[:, p.iq1])
    return torch.cat([B, q], 1), torch.cat([dBdx, dq], 1)


def descriptors_with_jacobian(disp, jelem, mask, ielem, p: SnapParams,
                              plain=False):
    """Per-atom descriptors and their per-pair gradients.

    Returns B (A, W) and dBdD (A, W, K, 3) = d B[a] / d disp[a, k, c], W the
    descriptor width (nb_base, plus the quadratic columns).  The steps are
    the kernels K1-K3 (their chemflag modes under chemflag), then K6q for
    the quadratic columns: the pair tangents are contracted at the base
    width first, so the (A, W, 2U) quadratic dB/dutot never exists.
    `plain=True` runs the plain versions on any device (the reference the
    kernels are checked against).  At disp's type: float64, or float32 with
    the plan's float32 tables (`SnapParams.cast`).
    """
    from fitsnap_tpu_torch.kernels import snap_kernels as sk

    p = p.cast(disp.dtype)
    if p.nchem == 1:
        k1, k2, k3, k6 = ((sk.pair_u_duals_plain, sk.zlist_plain,
                           sk.dbdd_plain, sk.quad_chain_plain) if plain else
                          (sk.pair_u_duals, sk.zlist, sk.dbdd, sk.quad_chain))
        J, ut = k1(disp, jelem, mask, ielem, p)
        z_r, z_i = k2(ut, p)
        B, dBdD = k3(ut, z_r, z_i, J, p)
    else:
        k1, k2, k3, k6 = ((sk.pair_u_duals_plain, sk.zlist_chem_plain,
                           sk.dbdd_chem_plain, sk.quad_chain_plain) if plain
                          else (sk.pair_u_duals_chem, sk.zlist_chem,
                                sk.dbdd_chem, sk.quad_chain))
        J, ut = k1(disp, jelem, mask, ielem, p)
        z_r, z_i = k2(ut, p)
        B, dBdD = k3(ut, z_r, z_i, J, jelem, p)
    if p.quadraticflag:
        B, dBdD = k6(B, dBdD, p)
    return B, dBdD


# ---------------------------------------------------------------------------
# Monomial pair-grid path and the analytic-force NN kit (cached mode)
#
# Every monomial ar^p ai^q br^r bi^s of the U expansion factors on the pair
# grid as T1[(p, q)] * T2[(r, s)], so utot of an atom is the neighbor sum
# wg = sum_k w T1 (x) T2 mapped once through the change of basis Lg.  The NN
# solver's cached mode keeps ut and B per atom (positions never move during
# training) and, per step, takes dE/dB back to the grid (nn_dEdu, nn_vg) and
# to the pairs (nn_grid_pair, nn_pair_force).  These are the plain versions
# of kernels K9-K11 (`kernels/nn_kernels.py`) and the CPU path.
# ---------------------------------------------------------------------------


@dataclass
class Dealt:
    """Entries grouped by key (CSR) dealt to the threads of a kernel's block
    (`deal`): each group's entries cut into segments of at most `per`, one
    segment a slot, entry j of slot s at [j * stride + s] (padding: key 0,
    factor 0); `seg` (groups + 1,) the slots of each group.  The kernel
    launches `threads` threads (`stride` >= threads: a thread takes slots
    tid, tid + threads, ...)."""

    per: int
    threads: int
    stride: int
    key: torch.Tensor       # (per * stride,) int32 or int64
    fac: torch.Tensor       # (per * stride,) at the plan's type
    seg: torch.Tensor       # (groups + 1,) int32


@dataclass
class NnTables:
    """Pair-grid tables of one plan on its device (`nn_tables`).

    T1[d] = ar^pidx[d] ai^qidx[d] (T2 the same in br, bi) over the n_t
    exponent pairs of degree <= twojmax.  Lg2 (n_t^2, 2U) maps the grid to
    utot: dense for the plain versions, as CSR by column (K9, K10T) and by
    row (K10: the nonzero rows alone, `lgr_row`, longest first) for the
    kernels.  `yblocks` is `_y_block_plan`; its nonzero entries (t, u,
    src, fac) are listed on the host by U column (`yu_*`)
    and by descriptor (`yt_*`), and the B terms (i1, i2, i3, coefficient)
    by descriptor (`bt_*`, over the element channels' nb_base
    descriptors under chemflag): numpy, the inputs of the
    dealt schedules, which the kernels read.  `yz_src` lists the z entries
    the y entries reference (sorted, each once); a y key is `low |
    zc << key_bits`, zc an index into `yz_src` and low u (K10T, `ydesc`:
    by descriptor) or t (K10, `ycol`: by U column).  K9's B terms
    (`bterm`) key i1 | i2 << 16 | i3 << 32, indices into the channel-major
    ut (A, nchem U)."""

    n_t: int
    pidx: torch.Tensor      # (n_t,) int32
    qidx: torch.Tensor      # (n_t,) int32
    Lg2: torch.Tensor       # (n_t^2, 2U) at the plan's type
    lgc_ptr: torch.Tensor   # (2U+1,) int32: Lg2 by column
    lgc_row: torch.Tensor
    lgc_val: torch.Tensor
    lgr_row: torch.Tensor   # (nrows,) int32: Lg2's nonzero rows, longest first
    lgr_ptr: torch.Tensor   # (nrows+1,) int32: their entries
    lgr_col: torch.Tensor
    lgr_val: torch.Tensor
    yblocks: list           # [(c0, c1, ts, src_b, fac_b)], tensors
    yu_ptr: np.ndarray      # (U+1,): y entries of each u, host
    yu_t: np.ndarray
    yu_src: np.ndarray
    yu_fac: np.ndarray
    yt_ptr: np.ndarray      # (W+1,): y entries of each descriptor, host
    yt_u: np.ndarray
    yt_src: np.ndarray
    yt_fac: np.ndarray
    yz_src: torch.Tensor    # (nzr,) int32: the referenced z entries
    key_bits: int           # the low field of a y key
    ycol: Dealt             # K10: the y entries by U column
    ydesc: Dealt            # K10T: the y entries by descriptor
    bt_ptr: np.ndarray      # (nb_base+1,): B terms of each descriptor, host
    bt_i1: np.ndarray
    bt_i2: np.ndarray
    bt_i3: np.ndarray
    bt_c: np.ndarray
    bterm: Dealt            # K9: the B terms by descriptor


def _y_block_plan(p: SnapParams):
    """Host block structure of the y-list contraction (JAX `ops/snap.py`
    `_y_block_plan`): each (layer, triple) touches one (j+1)^2 u-block, so
    src and fac are kept on the nonzero blocks only.  Returns numpy
    [(c0, c1, ts, src_b, fac_b)]."""
    srcs = p.y_src.cpu().numpy()
    facs = p.y_fac.cpu().numpy()
    offs = list(np.cumsum([0] + [(j + 1) ** 2 for j in range(p.twojmax + 1)]))
    out = []
    for lay in range(3):
        by_j = {}
        for t in range(facs.shape[1]):
            nz = np.nonzero(facs[lay, t])[0]
            if len(nz) == 0:
                continue
            j = next(jj for jj in range(len(offs) - 1)
                     if offs[jj] <= nz[0] < offs[jj + 1])
            assert nz[-1] < offs[j + 1], "y_fac straddles u-blocks"
            by_j.setdefault(j, []).append(t)
        for j, ts in sorted(by_j.items()):
            ts = np.array(ts, np.int64)
            c0, c1 = int(offs[j]), int(offs[j + 1])
            out.append((c0, c1, ts, srcs[lay][ts][:, c0:c1],
                        facs[lay][ts][:, c0:c1]))
    return out


def _csr(keys, nkeys, *cols):
    """CSR of entries grouped by `keys` (stable): (ptr, *cols sorted)."""
    keys = np.asarray(keys, np.int64)
    order = np.argsort(keys, kind="stable")
    ptr = np.searchsorted(keys[order], np.arange(nkeys + 1))
    return (ptr,) + tuple(np.asarray(c)[order] for c in cols)


DEAL_PER = 8           # a dealt schedule's least entries a slot
DEAL_MOST = 16         # its most where the segments fit its block
DEAL_BLOCK = 288       # the block K10's and K10T's schedules fill where
                       # they can (csrc/nn_dedu.cu's narrow launch bounds
                       # hold four an SM)
K9_BLOCK = 256         # K9's (csrc/nn_grid.cu's narrow launch bounds hold
                       # four an SM at the 64 registers its mma needs)
DEAL_THREADS = 1024    # a block's most threads


def _warps(n):
    return -(-max(int(n), 1) // 32) * 32


def deal(ptr, keys, fac, order=None, block=DEAL_BLOCK):
    """Deal entries grouped by CSR `ptr` (keys, factors `fac`; within a
    group in `order`, stable, where given) to the slots of a kernel's
    block: each group's entries dealt round-robin to near-equal segments
    of at most `per`, so that at each step a group's slots take
    neighboring entries in `order`; segment i of the list in slot i.  per
    is the least from DEAL_PER up whose segments fit `block` slots, up
    to DEAL_MOST entries, else the least whose segments fit DEAL_THREADS
    (at most one segment a group: groups past DEAL_THREADS then share
    threads).  threads covers the slots and the groups, rounded up to a
    warp, at most DEAL_THREADS; stride covers the slots, at least threads.
    Returns numpy (per, threads, stride, key (per * stride,), fac, seg
    (groups + 1,))."""
    cnt = np.diff(ptr)

    def nseg(per):
        return -(-cnt // per)

    per = DEAL_PER
    while per < DEAL_MOST and nseg(per).sum() > block:
        per += 1
    if nseg(per).sum() > block:
        per = DEAL_PER
        top = max(int(cnt.max(initial=0)), 1)
        while per < top and nseg(per).sum() > DEAL_THREADS:
            per += 1
    n = nseg(per)
    seg = np.concatenate([[0], np.cumsum(n)])
    threads = min(_warps(max(seg[-1], len(cnt))), DEAL_THREADS)
    stride = max(_warps(seg[-1]), threads)
    key = np.zeros((per, stride), np.int64)
    val = np.zeros((per, stride))
    for g, m in enumerate(n):
        q = np.arange(ptr[g], ptr[g + 1])
        if order is not None:
            q = q[np.argsort(order[q], kind="stable")]
        for i in range(m):
            mine = q[i::m]
            key[:len(mine), seg[g] + i] = keys[mine]
            val[:len(mine), seg[g] + i] = fac[mine]
    return per, threads, stride, key.ravel(), val.ravel(), seg


def nn_tables(p: SnapParams) -> NnTables:
    """The pair-grid tables of `p`, built once and kept on it; their float
    tables at the plan's type, each rounded once from its float64 values
    (as the JAX package's `jnp.asarray(x, dtype)`)."""
    if p.nn is not None:
        return p.nn
    from fitsnap_tpu_torch.ops.mono import grid_plan

    dev, ft, i32 = p.device, p.dtype, torch.int32

    def t(x, dtype=i32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def dealt(ptr, keys, fac, order=None, dtype=i32, block=DEAL_BLOCK):
        per, threads, stride, key, val, seg = deal(ptr, keys, fac, order,
                                                   block)
        return Dealt(per=per, threads=threads, stride=stride,
                     key=t(key, dtype), fac=t(val, ft), seg=t(seg))

    pidx, qidx, Lg = grid_plan(p.twojmax)
    n_t = len(pidx)
    Lg2 = Lg.reshape(n_t * n_t, -1)
    rows, cols = np.nonzero(Lg2)
    vals = Lg2[rows, cols]
    lgc = _csr(cols, Lg2.shape[1], rows, vals)
    # by row for K10, a thread a row: the nonzero rows alone (574 of 784 are
    # empty at twojmax 6), longest first, so that a warp's rows are of like
    # length
    length = np.bincount(rows, minlength=Lg2.shape[0])
    lgr_row = np.nonzero(length)[0]
    lgr_row = lgr_row[np.argsort(-length[lgr_row], kind="stable")]
    place = np.zeros(Lg2.shape[0], np.int64)
    place[lgr_row] = np.arange(len(lgr_row))
    lgr = _csr(place[rows], len(lgr_row), cols, vals)
    blocks = _y_block_plan(p)
    ent = [(tt, c0 + uu, src[ti, uu], fac[ti, uu])
           for c0, c1, ts, src, fac in blocks
           for ti, tt in enumerate(ts) for uu in range(c1 - c0)
           if fac[ti, uu] != 0]
    et, eu, es, ef = (np.array(x) for x in zip(*ent))
    yu = _csr(eu, p.u_len, et, es, ef)
    yt = _csr(et, p.ntriples, eu, es, ef)
    yz_src = np.unique(es)
    # a y key: u (K10T) or t (K10) in the low bits, the compact z index
    # above them
    key_bits = max(p.u_len - 1, p.ntriples - 1, 1).bit_length()
    assert len(yz_src) << key_bits < 1 << 31
    zcol, zdesc = (np.searchsorted(yz_src, y[2]) for y in (yu, yt))
    ycol = dealt(yu[0], yu[1] | zcol << key_bits, yu[3], zcol)
    ydesc = dealt(yt[0], yt[1] | zdesc << key_bits, yt[3], zdesc)
    # K9's B terms: block blk of the nchem^3 channel triples holds terms
    # blk * nterms + k of i1, i2, i3, and descriptor blk * ntriples + t sums
    # its terms k with mmat[k, t] (`bispectrum_from_utot`)
    mmat = p.mmat.cpu().numpy()
    ks, ts = np.nonzero(mmat)
    nterms, nblk = mmat.shape[0], p.nchem ** 3
    blk = np.repeat(np.arange(nblk), len(ks))
    ptr, k_s, c_s = _csr(np.tile(ts, nblk) + blk * p.ntriples, p.nb_base,
                         np.tile(ks, nblk) + blk * nterms,
                         np.tile(mmat[ks, ts], nblk))
    bt = [ptr] + [getattr(p, n).cpu().numpy()[k_s].astype(np.int64)
                  for n in ("i1", "i2", "i3")] + [c_s]
    # a term's key packs three 16-bit indices into the channel-major ut (K9
    # refuses a plan whose nchem U passes 2^16)
    bterm = dealt(ptr, bt[1] | bt[2] << 16 | bt[3] << 32, c_s,
                  dtype=torch.int64, block=K9_BLOCK)
    p.nn = NnTables(
        n_t=n_t, pidx=t(pidx), qidx=t(qidx), Lg2=t(Lg2, ft),
        lgc_ptr=t(lgc[0]), lgc_row=t(lgc[1]), lgc_val=t(lgc[2], ft),
        lgr_row=t(lgr_row), lgr_ptr=t(lgr[0]), lgr_col=t(lgr[1]),
        lgr_val=t(lgr[2], ft),
        yblocks=[(c0, c1, t(ts, torch.long), t(src, torch.long), t(fac, ft))
                 for c0, c1, ts, src, fac in blocks],
        yu_ptr=yu[0], yu_t=yu[1], yu_src=yu[2], yu_fac=yu[3],
        yt_ptr=yt[0], yt_u=yt[1], yt_src=yt[2], yt_fac=yt[3],
        yz_src=t(yz_src), key_bits=key_bits, ycol=ycol, ydesc=ydesc,
        bt_ptr=bt[0], bt_i1=bt[1], bt_i2=bt[2], bt_i3=bt[3], bt_c=bt[4],
        bterm=bterm)
    return p.nn


def _powers(x, n):
    """(..., n+1) powers x^0..x^n by a running product."""
    ones = torch.ones_like(x)[..., None]
    rep = x[..., None].expand(x.shape + (n,))
    return torch.cumprod(torch.cat([ones, rep], -1), -1)


def _powers_tan(P, xt):
    """Tangent of `_powers`: d(x^k) = k x^(k-1) dx, from the power table.

    P: (..., n+1); xt: tangent stack (T, ...).  Returns (T, ..., n+1)."""
    shifted = torch.cat([torch.zeros_like(P[..., :1]), P[..., :-1]], -1)
    k = torch.arange(P.shape[-1], dtype=P.dtype, device=P.device)
    return k * shifted[None] * xt[..., None]


def _exp_onehot(idx, n, dtype):
    """(n+1, n_t) selection matrix: column i picks power idx[i]."""
    return (torch.arange(n + 1, device=idx.device)[:, None]
            == idx[None, :]).to(dtype)


def _grid_tensors(ar, ai, br, bi, twojmax, pidx, qidx):
    """Pair-grid factors T1[(p, q)] = ar^p ai^q, T2[(r, s)] = br^r bi^s.

    Returns (raw, proj, T1, T2): raw = the (..., twojmax+1) power tables,
    proj = their (..., n_t) projections on the grid's exponents."""
    dtype = ar.dtype
    Ep = _exp_onehot(pidx, twojmax, dtype)
    Eq = _exp_onehot(qidx, twojmax, dtype)
    Pa, Pai = _powers(ar, twojmax), _powers(ai, twojmax)
    Pb, Pbi = _powers(br, twojmax), _powers(bi, twojmax)
    PaE, PaiE = Pa @ Ep, Pai @ Eq
    PbE, PbiE = Pb @ Ep, Pbi @ Eq
    return ((Pa, Pai, Pb, Pbi), (PaE, PaiE, PbE, PbiE),
            PaE * PaiE, PbE * PbiE)


def compute_utot_mono(disp, jelem, mask, ielem, p: SnapParams):
    """`compute_utot` on the pair grid: ut = (sum_k w T1 (x) T2) . Lg plus
    the self term.  Returns (utot_r, utot_i), each (A, nchem*U), as
    `compute_utot` (element channels under chemflag)."""
    tb = nn_tables(p)
    A, U, n_t = disp.shape[0], p.u_len, tb.n_t
    ar, ai, br, bi, w = _ck_prologue(disp, jelem, mask, ielem, p)
    _, _, T1, T2 = _grid_tensors(ar, ai, br, bi, p.twojmax, tb.pidx,
                                 tb.qidx)
    if p.nchem == 1:
        wg = torch.einsum("ak,akd,ake->ade", w, T1, T2)
        ut = wg.reshape(A, n_t * n_t) @ tb.Lg2
        return ut[:, :U] + p.selfvec[None, :U], ut[:, U:]
    chan = torch.nn.functional.one_hot(jelem.long(), p.nchem).to(
        w.dtype) * w[..., None]
    wg = torch.einsum("akc,akd,ake->acde", chan, T1, T2)
    ut = wg.reshape(A, p.nchem, n_t * n_t) @ tb.Lg2
    ut = ut + _channel_self(ielem, p, w.dtype)
    return ut[..., :U].reshape(A, -1), ut[..., U:].reshape(A, -1)


def atom_descriptors_fast(disp, jelem, mask, ielem, p: SnapParams):
    """`atom_descriptors` on the pair grid (with the quadratic columns)."""
    utr, uti = compute_utot_mono(disp, jelem, mask, ielem, p)
    return _quad_extend(bispectrum_from_utot(utr, uti, p), p)


def nn_ut_b(disp, jelem, mask, ielem, p: SnapParams):
    """Per-atom (ut (A, 2 nchem U), B (A, nb_base)): the cached atom-side
    state of the NN cached mode, and the descriptors of `nn_desc` (the base
    ones; under chemflag over the element channels, ut's real parts
    channel-major, then its imaginary parts).  Plain K9."""
    utr, uti = compute_utot_mono(disp, jelem, mask, ielem, p)
    return torch.cat([utr, uti], -1), bispectrum_from_utot(utr, uti, p)


def nn_dEdu(dEdB, ut, p: SnapParams, zcat=None):
    """dE/dutot (A, 2U) from dE/dB (A, W): the z-lists of ut (or `zcat`)
    contracted with dE/dB through the block-restricted y plan."""
    z_r, z_i = zcat if zcat is not None else _compute_zcat(ut, p)
    A, U = dEdB.shape[0], p.u_len
    der = dEdB.new_zeros((A, U))
    dei = dEdB.new_zeros((A, U))
    for c0, c1, ts, src_b, fac_b in nn_tables(p).yblocks:
        wb = dEdB[:, ts, None] * fac_b[None]
        der[:, c0:c1] += torch.einsum("atu,atu->au", wb, z_r[:, src_b])
        dei[:, c0:c1] += torch.einsum("atu,atu->au", wb, z_i[:, src_b])
    return torch.cat([der, dei], -1)


def nn_vg(dEdu, p: SnapParams):
    """dE/dutot -> the pair-grid cotangent vg (A, n_t, n_t)."""
    tb = nn_tables(p)
    return (dEdu @ tb.Lg2.T).reshape(dEdu.shape[0], tb.n_t, tb.n_t)


def nn_grid_pair(disp, jelem, mask, ielem, p: SnapParams):
    """Per-pair grid tensors and their displacement tangents.

    Returns (T1, T2 (A, K, n_t), T1t, T2t (3, A, K, n_t), wp (A, K), wt
    (3, A, K)); the prologue's tangents are `_prologue_duals`'."""
    tb = nn_tables(p)
    vals, tans = _prologue_duals(disp, jelem, mask, ielem, p)
    raw, proj, T1, T2 = _grid_tensors(vals[0], vals[1], vals[2], vals[3],
                                      p.twojmax, tb.pidx, tb.qidx)
    Pa, Pai, Pb, Pbi = raw
    PaE, PaiE, PbE, PbiE = proj
    Ep = _exp_onehot(tb.pidx, p.twojmax, disp.dtype)
    Eq = _exp_onehot(tb.qidx, p.twojmax, disp.dtype)
    PatE = _powers_tan(Pa, tans[:, 0]) @ Ep
    PaitE = _powers_tan(Pai, tans[:, 1]) @ Eq
    PbtE = _powers_tan(Pb, tans[:, 2]) @ Ep
    PbitE = _powers_tan(Pbi, tans[:, 3]) @ Eq
    T1t = PatE * PaiE[None] + PaE[None] * PaitE
    T2t = PbtE * PbiE[None] + PbE[None] * PbitE
    return T1, T2, T1t, T2t, vals[4], tans[:, 4]


def nn_pair_force(vg, grid):
    """dE/ddisp (A, K, 3) from the grid cotangent vg (A, n_t, n_t):
    g = wp sum_m Mt v + wt sum_m M v, evaluated on the grid."""
    T1, T2, T1t, T2t, wp, wt = grid
    tmp = torch.einsum("akd,ade->ake", T1, vg)
    sp = torch.einsum("ake,ake->ak", tmp, T2)
    st = (torch.einsum("cake,ake->cak",
                       torch.einsum("cakd,ade->cake", T1t, vg), T2)
          + torch.einsum("ake,cake->cak", tmp, T2t))
    g = wp[None] * st + wt * sp[None]
    return g.permute(1, 2, 0)


def snap_nn_parts(disp, jelem, mask, ielem, p: SnapParams):
    """(B, ut, grid) of one block of atoms: the kit composed, for tests."""
    assert p.nchem == 1 and not p.quadraticflag, \
        "the analytic NN path covers the one-channel base descriptors"
    ut, B = nn_ut_b(disp, jelem, mask, ielem, p)
    return B, ut, nn_grid_pair(disp, jelem, mask, ielem, p)


def nn_pair_grad(dEdB, parts, p: SnapParams):
    """dE/ddisp (A, K, 3) from dE/dB and `snap_nn_parts` (test oracle)."""
    _, ut, grid = parts
    return nn_pair_force(nn_vg(nn_dEdu(dEdB, ut, p), p), grid)
