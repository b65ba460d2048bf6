"""Wrappers of the NN solver's CUDA kernels, with their plain PyTorch
versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K12 nn_force | csrc/nn_force.cu | solvers/network.py _forward_batch (:737-741) |
| K12T nn_force_t | csrc/nn_force.cu | its transpose (autodiff of the same lines) |
| nn_pair_gather | csrc/nn_force.cu | the force scatter of _forward_batch (:739-741) and _forward_batch_cached (:811-816) |
| K9 nn_ut_b | csrc/nn_grid.cu | ops/snap.py compute_utot_mono (element channels too), _grid_tensors, nn_ut_b |
| K10 nn_dedu_vg | csrc/nn_dedu.cu | ops/snap.py nn_dEdu, nn_vg |
| K10T nn_dedu_vg_t | csrc/nn_dedu.cu | their transpose |
| K11 nn_pair_force | csrc/nn_grid.cu | ops/snap.py nn_grid_pair, nn_pair_force |
| K11T nn_pair_force_t | csrc/nn_grid.cu | their transpose, with the gather's |

`NnForce` is the precompute mode's autograd function (forward K12, backward
K12T; G, jidx and rev take no gradient).  `NnCachedForce` is the cached
mode's (forward: K2 z-lists of the cached ut, K10, K11, the gather;
backward: K11T, then K10T on the z-lists the forward formed).  Each wrapper
takes its plain version for tensors on the CPU, launches its kernel for
tensors on a CUDA device, and raises for anything else.  Every launch adds
one to the wrapper's `launches` count.

Working types: K9, K10, K10T, K11, K11T and the gather take float64 or
float32 inputs (`kl.float_type`; the plan at their type,
`SnapParams.cast`), each type its own entry point (`_f32`), launches
counted apart (`launches()["<name>_f32"]`).  At float32 they take one
element channel up to twojmax F32_TWOJMAX (the linear SNAP networks'
cached and OTF modes); K12 and K12T refuse float32 with QUEUE_NN.
"""

from functools import partial

import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.kernels.launch import (launch as _launch,
                                              on_cpu as _on_cpu, ptr as _ptr)
from fitsnap_tpu_torch.ops import snap as ops

_P, _I, _LL, _D = kl.P, kl.I, kl.LL, kl.D
# K12 and K12T: float64 only, float32 names its ROADMAP.md queue item
_check = partial(kl.check, queue=kl.QUEUE_NN)
# the largest twojmax of the float32 entry points (that of K1's window
# shape, which the float32 streamed fit takes)
F32_TWOJMAX = 12
kl.register("nn_force", "nn_force", [_P] * 2 + [_I] * 4 + [_P] * 2)
kl.register("nn_force_t", "nn_force", [_P] * 3 + [_I] * 4 + [_P] * 2)
_PAIRS = [_D] * 3 + [_I] * 2 + [_LL]    # prologue scalars, pair count
for _sfx in ("", "_f32"):
    kl.register("nn_pair_gather" + _sfx, "nn_force",
                [_P] * 2 + [_I] * 4 + [_P] * 2)
    kl.register("nn_ut_b" + _sfx, "nn_grid",
                [_P] * 5 + _PAIRS + [_I] * 2 + [_P] * 5 + [_I] + [_P]
                + [_I] * 5 + [_P] * 3 + [_I] + [_P] * 4)
    kl.register("nn_pair_force" + _sfx, "nn_grid",
                [_P] * 6 + _PAIRS + [_I] * 2 + [_P] * 4)
    kl.register("nn_pair_force_t" + _sfx, "nn_grid",
                [_P] * 7 + _PAIRS + [_I] * 3 + [_P] * 4)
    kl.register("nn_dedu_vg" + _sfx, "nn_dedu",
                [_P] * 3 + [_LL] + [_I] * 6 + [_P] * 4 + [_I] + [_P]
                + [_I] * 4 + [_P] * 5)
    kl.register("nn_dedu_vg_t" + _sfx, "nn_dedu",
                [_P] * 3 + [_LL] + [_I] * 4 + [_P] * 3 + [_I] * 2 + [_P]
                + [_I] * 3 + [_P] * 5)


def _working_type(name, p, *tensors):
    """The float type of a pair-grid wrapper's inputs (`kl.float_type`),
    with the plan at that type; float32 takes one element channel up to
    twojmax F32_TWOJMAX, else names the ROADMAP.md queue item that ports
    it."""
    dt = kl.float_type(name, *tensors)
    sk._plan_type(p, dt, name)
    if dt == torch.float32:
        if p.nchem != 1:
            raise kl.f32_refusal(f"{name} with {p.nchem} element channels",
                                 kl.QUEUE_CHEM)
        if p.twojmax > F32_TWOJMAX:
            raise kl.f32_refusal(f"{name} at twojmax {p.twojmax}",
                                 kl.QUEUE_LARGE)
    return dt


# ---------------------------------------------------------------------------
# K12, K12T and the force gather
# ---------------------------------------------------------------------------


def nn_pair_gather_plain(g, rev):
    """Plain force gather: F (N, A, 3) from pair gradients g (N, A, K, 3)
    and the reverse table rev (N, A, R) of flat slots a*K + k (-1 padded):
    F[m] = sum_k g[m, k] - sum over the slots whose neighbor is m."""
    N, A, K, _ = g.shape
    R = rev.shape[2]
    flat = torch.cat([g.reshape(N, A * K, 3), g.new_zeros((N, 1, 3))], 1)
    idx = torch.where(rev < 0, A * K, rev).long().reshape(N, A * R, 1)
    scat = torch.gather(flat, 1, idx.expand(N, A * R, 3))
    return g.sum(2) - scat.reshape(N, A, R, 3).sum(2)


def nn_force_plain(dEdB, G, jidx, rev):
    """Plain K12: forces F (N, A, 3) from dE/dB (N, A, W), G (N, A, W, K,
    3) and the reverse table rev (N, A, R); jidx is not read (rev carries
    the neighbor map)."""
    return nn_pair_gather_plain(torch.einsum("naw,nawkc->nakc", dEdB, G),
                                rev)


def nn_force_t_plain(gF, G, jidx):
    """Plain K12T: the cotangent of dE/dB (N, A, W) from that of the forces
    gF (N, A, 3)."""
    N, A, W, K, _ = G.shape
    gj = torch.gather(gF, 1, jidx.long().reshape(N, A * K, 1)
                      .expand(N, A * K, 3)).reshape(N, A, K, 3)
    return torch.einsum("nakc,nawkc->naw", gF[:, :, None, :] - gj, G)


def _check_pairs(G, jidx_or_rev, name):
    N, A, W, K, _ = G.shape
    _check(G, "G", torch.float64, (N, A, W, K, 3))
    _check(jidx_or_rev, name, torch.int32,
           (N, A, jidx_or_rev.shape[2] if name == "rev" else K))
    return N, A, W, K


def nn_pair_gather(g, rev):
    """The force gather on the card; same arguments and output as the plain
    version, g f64 or f32 (the forces at its type)."""
    if _on_cpu(g, rev):
        return nn_pair_gather_plain(g, rev)
    N, A, K, _ = g.shape
    dt = kl.float_type("nn_pair_gather", g)
    kl.check(g, "g", dt, (N, A, K, 3))
    kl.check(rev, "rev", torch.int32, (N, A, rev.shape[2]))
    force = torch.empty((N, A, 3), dtype=dt, device=g.device)
    _launch(kl.entry("nn_pair_gather", dt), g.device, _ptr(g), _ptr(rev), N,
            A, K, rev.shape[2], _ptr(force))
    kl.count(nn_pair_gather, dt)
    return force


def nn_force(dEdB, G, jidx, rev):
    """K12 on the card: the contraction, then `nn_pair_gather`; same
    arguments and output as the plain version."""
    if _on_cpu(dEdB, G, jidx, rev):
        return nn_force_plain(dEdB, G, jidx, rev)
    N, A, W, K = _check_pairs(G, rev, "rev")
    _check(dEdB, "dEdB", torch.float64, (N, A, W))
    fpair = torch.empty((N, A, K, 3), dtype=torch.float64, device=G.device)
    _launch("nn_force", G.device, _ptr(dEdB), _ptr(G), N, A, W, K,
            _ptr(fpair))
    nn_force.launches += 1
    return nn_pair_gather(fpair, rev)


def nn_force_t(gF, G, jidx):
    """K12T on the card; same arguments and output as the plain version."""
    if _on_cpu(gF, G, jidx):
        return nn_force_t_plain(gF, G, jidx)
    N, A, W, K = _check_pairs(G, jidx, "jidx")
    _check(gF, "gF", torch.float64, (N, A, 3))
    dev = G.device
    out = torch.empty((N, A, W), dtype=torch.float64, device=dev)
    _launch("nn_force_t", dev, _ptr(gF), _ptr(G), _ptr(jidx), N, A, W, K,
            _ptr(out))
    nn_force_t.launches += 1
    return out


class NnForce(torch.autograd.Function):
    """F = K12(dE/dB); its backward is K12T (F is linear in dE/dB)."""

    @staticmethod
    def forward(ctx, dEdB, G, jidx, rev):
        ctx.save_for_backward(G, jidx)
        return nn_force(dEdB.contiguous(), G, jidx, rev)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gF):
        G, jidx = ctx.saved_tensors
        return nn_force_t(gF.contiguous(), G, jidx), None, None, None


# ---------------------------------------------------------------------------
# K9, K10, K11 and their transposes: the cached mode
# ---------------------------------------------------------------------------


def _one_channel(p, name):
    """The plan's pair-grid tables; K10, K10T, K11 and K11T refuse element
    channels (chemflag), which they do not have."""
    if p.nchem != 1:
        raise ValueError(f"{name}: the pair-grid kernels take one element "
                         f"channel (the plan has {p.nchem})")
    return ops.nn_tables(p)


def _check_block(disp, jelem, mask, ielem, dt):
    N, K = mask.shape
    kl.check(disp, "disp", dt, (N, K, 3))
    kl.check(jelem, "jelem", torch.int32, (N, K))
    kl.check(mask, "mask", torch.bool, (N, K))
    kl.check(ielem, "ielem", torch.int32, (N,))
    return N, K


def _prologue_args(p):
    return (_ptr(p.elem), p.rcutfac, p.rfac0, p.rmin0, int(p.switchflag),
            int(p.switchinnerflag))


def nn_ut_b_plain(disp, jelem, mask, ielem, p):
    """Plain K9: (ut (N, 2 nchem U), B (N, nb_base)) of atoms with neighbor
    slots disp (N, K, 3), jelem (N, K), mask (N, K), ielem (N,); under
    chemflag over the element channels."""
    return ops.nn_ut_b(disp, jelem, mask, ielem, p)


def nn_ut_b(disp, jelem, mask, ielem, p):
    """K9 on the card, in one element channel or (chemflag, float64)
    several; same arguments and outputs as the plain version (disp f64 or
    f32, the plan and the outputs at its type; jelem, ielem int32, mask
    bool).  B holds the base descriptors also under quadraticflag."""
    if _on_cpu(disp, jelem, mask, ielem):
        return nn_ut_b_plain(disp, jelem, mask, ielem, p)
    sk.check_twojmax(p, "K9")
    dt = _working_type("nn_ut_b", p, disp)
    tb = ops.nn_tables(p)
    N, K = _check_block(disp, jelem, mask, ielem, dt)
    two_u, W, dev = 2 * p.u_len, p.nb_base, disp.device
    ut = torch.empty((N, p.nchem * two_u), dtype=dt, device=dev)
    B = torch.empty((N, W), dtype=dt, device=dev)
    bs = tb.bterm
    _launch(kl.entry("nn_ut_b", dt), dev, _ptr(disp), _ptr(jelem),
            _ptr(mask), _ptr(ielem), *_prologue_args(p), N, K, tb.n_t,
            _ptr(tb.pidx), _ptr(tb.qidx),
            _ptr(tb.lgc_ptr), _ptr(tb.lgc_row), _ptr(tb.lgc_val), two_u,
            _ptr(p.selfvec), p.nchem, int(p.nchem == 1 or p.wselfallflag),
            bs.threads, bs.per, bs.stride, _ptr(bs.key), _ptr(bs.fac),
            _ptr(bs.seg), W, _ptr(p.bzero) if p.bzeroflag else None,
            _ptr(ut), _ptr(B))
    kl.count(nn_ut_b, dt)
    return ut, B


def nn_dedu_vg_plain(dEdB, z_r, z_i, p):
    """Plain K10: the grid cotangent vg (N, n_t, n_t) from dE/dB (N, W) and
    the z-lists (N, nz) of the atoms' ut."""
    return ops.nn_vg(ops.nn_dEdu(dEdB, None, p, (z_r, z_i)), p)


def _check_z(z_r, z_i, N, p, dt):
    kl.check(z_r, "z_r", dt, (N, p.nz))
    kl.check(z_i, "z_i", dt, (N, p.nz))


def nn_dedu_vg(dEdB, z_r, z_i, p):
    """K10 on the card; same arguments and output as the plain version
    (f64 or f32, the plan at their type)."""
    if _on_cpu(dEdB, z_r, z_i):
        return nn_dedu_vg_plain(dEdB, z_r, z_i, p)
    sk.check_twojmax(p, "K10")
    dt = _working_type("nn_dedu_vg", p, dEdB, z_r, z_i)
    tb = _one_channel(p, "nn_dedu_vg")
    N, W = dEdB.shape
    kl.check(dEdB, "dEdB", dt, (N, p.ntriples))
    _check_z(z_r, z_i, N, p, dt)
    vg = torch.empty((N, tb.n_t, tb.n_t), dtype=dt, device=dEdB.device)
    yc = tb.ycol
    _launch(kl.entry("nn_dedu_vg", dt), dEdB.device, _ptr(dEdB), _ptr(z_r),
            _ptr(z_i), N, W, p.nz, 2 * p.u_len, tb.n_t ** 2,
            tb.lgr_row.numel(),
            tb.lgr_val.numel(), _ptr(tb.lgr_row), _ptr(tb.lgr_ptr),
            _ptr(tb.lgr_col), _ptr(tb.lgr_val),
            tb.yz_src.numel(), _ptr(tb.yz_src), yc.threads, yc.per, yc.stride,
            tb.key_bits, _ptr(yc.key), _ptr(yc.fac), _ptr(yc.seg), _ptr(vg))
    kl.count(nn_dedu_vg, dt)
    return vg


def nn_dedu_vg_t_plain(vgc, z_r, z_i, p):
    """Plain K10T: the cotangent of dE/dB (N, W) from that of vg (N, n_t,
    n_t), through the same block plan."""
    tb = ops.nn_tables(p)
    N, U = vgc.shape[0], p.u_len
    du = vgc.reshape(N, -1) @ tb.Lg2
    out = vgc.new_zeros((N, p.ntriples))
    for c0, c1, ts, src_b, fac_b in tb.yblocks:
        out = out.index_add(1, ts, (
            torch.einsum("atu,au->at", fac_b * z_r[:, src_b], du[:, c0:c1])
            + torch.einsum("atu,au->at", fac_b * z_i[:, src_b],
                           du[:, U + c0:U + c1])))
    return out


def nn_dedu_vg_t(vgc, z_r, z_i, p):
    """K10T on the card; same arguments and output as the plain version
    (f64 or f32, the plan at their type)."""
    if _on_cpu(vgc, z_r, z_i):
        return nn_dedu_vg_t_plain(vgc, z_r, z_i, p)
    sk.check_twojmax(p, "K10T")
    dt = _working_type("nn_dedu_vg_t", p, vgc, z_r, z_i)
    tb = _one_channel(p, "nn_dedu_vg_t")
    N = vgc.shape[0]
    kl.check(vgc, "vgc", dt, (N, tb.n_t, tb.n_t))
    _check_z(z_r, z_i, N, p, dt)
    out = torch.empty((N, p.ntriples), dtype=dt, device=vgc.device)
    ys = tb.ydesc
    if ys.stride != ys.threads:
        raise ValueError(f"nn_dedu_vg_t: {p.ntriples} descriptors exceed a "
                         f"block (one slot a thread)")
    _launch(kl.entry("nn_dedu_vg_t", dt), vgc.device, _ptr(vgc), _ptr(z_r),
            _ptr(z_i), N, p.ntriples, p.nz, 2 * p.u_len, tb.lgc_val.numel(),
            _ptr(tb.lgc_ptr), _ptr(tb.lgc_row), _ptr(tb.lgc_val), tb.n_t ** 2,
            tb.yz_src.numel(), _ptr(tb.yz_src), ys.threads, ys.per,
            tb.key_bits, _ptr(ys.key), _ptr(ys.fac), _ptr(ys.seg), _ptr(out))
    kl.count(nn_dedu_vg_t, dt)
    return out


def nn_pair_force_plain(vg, disp, jelem, mask, ielem, p):
    """Plain K11: dE/ddisp g (N, K, 3) from the grid cotangent vg (N, n_t,
    n_t) and the atoms' neighbor slots (as `nn_ut_b_plain`'s)."""
    return ops.nn_pair_force(vg, ops.nn_grid_pair(disp, jelem, mask, ielem,
                                                  p))


def nn_pair_force(vg, disp, jelem, mask, ielem, p):
    """K11 on the card; same arguments and output as the plain version
    (vg and disp f64 or f32, the plan at their type)."""
    if _on_cpu(vg, disp, jelem, mask, ielem):
        return nn_pair_force_plain(vg, disp, jelem, mask, ielem, p)
    sk.check_twojmax(p, "K11")
    dt = _working_type("nn_pair_force", p, vg, disp)
    tb = _one_channel(p, "nn_pair_force")
    N, K = _check_block(disp, jelem, mask, ielem, dt)
    kl.check(vg, "vg", dt, (N, tb.n_t, tb.n_t))
    g = torch.empty((N, K, 3), dtype=dt, device=disp.device)
    _launch(kl.entry("nn_pair_force", dt), disp.device, _ptr(vg),
            _ptr(disp), _ptr(jelem), _ptr(mask), _ptr(ielem),
            *_prologue_args(p), N, K, tb.n_t, _ptr(tb.pidx), _ptr(tb.qidx),
            _ptr(g))
    kl.count(nn_pair_force, dt)
    return g


def nn_pair_force_t_plain(gF, jidx, disp, jelem, mask, ielem, p):
    """Plain K11T: the cotangent of vg (N*A, n_t, n_t) from that of the
    forces gF (N, A, 3), through the force gather (jidx (N, A, K)) and K11;
    the neighbor slots are flat (N*A, K) as K11's."""
    N, A, K = jidx.shape
    gj = torch.gather(gF, 1, jidx.long().reshape(N, A * K, 1)
                      .expand(N, A * K, 3)).reshape(N, A, K, 3)
    gh = (gF[:, :, None, :] - gj).reshape(N * A, K, 3)
    T1, T2, T1t, T2t, wp, wt = ops.nn_grid_pair(disp, jelem, mask, ielem, p)
    s = torch.einsum("akc,cak->ak", gh, wt)
    h = gh * wp[..., None]
    X = s[..., None] * T2 + torch.einsum("akc,cake->ake", h, T2t)
    Y = torch.einsum("akc,cakd->akd", h, T1t)
    return (torch.einsum("akd,ake->ade", T1, X)
            + torch.einsum("akd,ake->ade", Y, T2))


def nn_pair_force_t(gF, jidx, disp, jelem, mask, ielem, p):
    """K11T on the card; same arguments and output as the plain version
    (gF and disp f64 or f32, the plan at their type)."""
    if _on_cpu(gF, jidx, disp, jelem, mask, ielem):
        return nn_pair_force_t_plain(gF, jidx, disp, jelem, mask, ielem, p)
    sk.check_twojmax(p, "K11T")
    dt = _working_type("nn_pair_force_t", p, gF, disp)
    tb = _one_channel(p, "nn_pair_force_t")
    N, A, K = jidx.shape
    _check_block(disp, jelem, mask, ielem, dt)
    kl.check(jidx, "jidx", torch.int32, (N, A, K))
    kl.check(gF, "gF", dt, (N, A, 3))
    kl.check(mask, "mask", torch.bool, (N * A, K))
    vgc = torch.empty((N * A, tb.n_t, tb.n_t), dtype=dt, device=disp.device)
    _launch(kl.entry("nn_pair_force_t", dt), disp.device, _ptr(gF),
            _ptr(jidx), _ptr(disp), _ptr(jelem), _ptr(mask), _ptr(ielem),
            *_prologue_args(p), N * A, A, K, tb.n_t, _ptr(tb.pidx),
            _ptr(tb.qidx), _ptr(vgc))
    kl.count(nn_pair_force_t, dt)
    return vgc


class NnCachedForce(torch.autograd.Function):
    """Forces (N, A, 3) of the cached mode from dE/dB (N*A, W): K2's
    z-lists of the cached ut (N*A, 2U), K10, K11 on the neighbor slots
    (disp (N*A, K, 3), jelem, mask (N*A, K), ielem (N*A,)), then the gather
    through rev (N, A, R).  F is linear in dE/dB: its backward is K11T
    (with the gather's transpose through jidx (N, A, K)), then K10T on the
    forward's z-lists.  Only dE/dB takes a gradient."""

    @staticmethod
    def forward(ctx, dEdB, ut, disp, jidx, jelem, mask, ielem, rev, p):
        N, A, K = jidx.shape
        p = p.cast(dEdB.dtype)
        z_r, z_i = sk.zlist(ut, p)
        vg = nn_dedu_vg(dEdB.contiguous(), z_r, z_i, p)
        g = nn_pair_force(vg, disp, jelem, mask, ielem, p)
        ctx.save_for_backward(z_r, z_i, disp, jidx, jelem, mask, ielem)
        ctx.p = p
        return nn_pair_gather(g.reshape(N, A, K, 3), rev)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gF):
        z_r, z_i, disp, jidx, jelem, mask, ielem = ctx.saved_tensors
        vgc = nn_pair_force_t(gF.contiguous(), jidx, disp, jelem, mask,
                              ielem, ctx.p)
        return (nn_dedu_vg_t(vgc, z_r, z_i, ctx.p),) + (None,) * 8


KERNELS = (nn_force, nn_force_t, nn_pair_gather, nn_ut_b, nn_dedu_vg,
           nn_dedu_vg_t, nn_pair_force, nn_pair_force_t)
# the kernels with a float32 instantiation: their float32 launches also
# count apart (`launches_f32`), reported as "<name>_f32" by `launches`
F32_KERNELS = (nn_pair_gather, nn_ut_b, nn_dedu_vg, nn_dedu_vg_t,
               nn_pair_force, nn_pair_force_t)
for _k in KERNELS:
    _k.launches = 0
for _k in F32_KERNELS:
    _k.launches_f32 = 0


def reset_launches():
    """Set every kernel's launch counts to 0."""
    for k in KERNELS:
        k.launches = 0
    for k in F32_KERNELS:
        k.launches_f32 = 0


def launches():
    """{kernel name: float64 launches since the last reset}, and
    {"<name>_f32": float32 launches} of the kernels with a float32
    instantiation."""
    out = {k.__name__: k.launches for k in KERNELS}
    for k in F32_KERNELS:
        out[k.__name__] -= k.launches_f32
        out[k.__name__ + "_f32"] = k.launches_f32
    return out
