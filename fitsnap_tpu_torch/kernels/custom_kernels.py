"""Wrappers of the custom pairwise NN's CUDA kernels, with their plain
PyTorch versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K15 pair_desc | csrc/pair_desc.cu | ops/custom_desc.py pair_descriptors (:67, with :25, :33, :38, :46) |
| K15V pair_desc_vjp | csrc/pair_desc.cu | its derivative in solvers/network.py _forward_pairwise (:706-707) |
| K15T pair_desc_jvp | csrc/pair_desc.cu | the transpose of K15V (autodiff of the same lines) |

`PairDescForce` is the pairwise mode's autograd function: forward K15V,
then the force gather `nn_pair_gather` (K12's); backward the gather's
transpose folded into K15T.  disp, mask, jidx and rev take no gradient.
Each wrapper takes its plain version for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else.  Every
launch adds one to the wrapper's `launches` count.  Shapes: disp (..., K,
3), mask (..., K) bool, any leading axes (the kernels see them flat).
"""

import math
from functools import partial

import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels.launch import (launch as _launch,
                                              on_cpu as _on_cpu, ptr as _ptr)
from fitsnap_tpu_torch.kernels.nn_kernels import nn_pair_gather
from fitsnap_tpu_torch.ops import custom_desc as ops

_P, _I, _LL, _D = kl.P, kl.I, kl.LL, kl.D
# float64 only: float32 names its ROADMAP.md queue item
_check = partial(kl.check, queue=kl.QUEUE_NN)
_SHAPE = [_LL, _I, _I, _I, _D]       # atoms, K, R, M, cutoff
kl.register("pair_desc", "pair_desc", [_P] * 3 + _SHAPE + [_P] * 3)
kl.register("pair_desc_vjp", "pair_desc", [_P] * 5 + _SHAPE + [_P] * 2)
kl.register("pair_desc_jvp", "pair_desc", [_P] * 3 + [_I] + [_P] * 3
            + _SHAPE + [_P] * 3)

_MU = {}


def _mu(num_3body, device):
    """The Gaussians' centres on `device`, the plain version's table."""
    key = (num_3body, device)
    if key not in _MU:
        _MU[key] = ops.gauss_centres(num_3body, torch.float64, device)
    return _MU[key]


def _check_pairs(disp, mask):
    K = disp.shape[-2]
    lead = tuple(disp.shape[:-2])
    _check(disp, "disp", torch.float64, lead + (K, 3))
    _check(mask, "mask", torch.bool, lead + (K,))
    return lead, math.prod(lead), K


def pair_desc_plain(disp, mask, cutoff, num_radial, num_3body):
    """Plain K15: (descriptors (..., K, R + M), envelope fc (..., K))."""
    return (ops.pair_descriptors(disp, mask, cutoff, num_radial, num_3body),
            ops.envelope(disp, mask, cutoff))


def pair_desc(disp, mask, cutoff, num_radial, num_3body):
    """K15 on the card; same arguments and outputs as the plain version."""
    if _on_cpu(disp, mask):
        return pair_desc_plain(disp, mask, cutoff, num_radial, num_3body)
    lead, n, K = _check_pairs(disp, mask)
    D, dev = num_radial + num_3body, disp.device
    desc = torch.empty(lead + (K, D), dtype=torch.float64, device=dev)
    fc = torch.empty(lead + (K,), dtype=torch.float64, device=dev)
    _launch("pair_desc", dev, _ptr(disp), _ptr(mask),
            _ptr(_mu(num_3body, dev)), n, K, num_radial, num_3body,
            float(cutoff), _ptr(desc), _ptr(fc))
    pair_desc.launches += 1
    return desc, fc


def pair_desc_vjp_plain(g_desc, e_env, disp, mask, cutoff, num_radial,
                        num_3body):
    """Plain K15V: the pair gradient (..., K, 3) = J^T g_desc + e_env *
    grad fc (`ops.custom_desc.pair_desc_vjp`)."""
    return ops.pair_desc_vjp(g_desc, e_env, disp, mask, cutoff, num_radial,
                             num_3body)


def pair_desc_vjp(g_desc, e_env, disp, mask, cutoff, num_radial, num_3body):
    """K15V on the card; same arguments and output as the plain version."""
    if _on_cpu(g_desc, e_env, disp, mask):
        return pair_desc_vjp_plain(g_desc, e_env, disp, mask, cutoff,
                                   num_radial, num_3body)
    lead, n, K = _check_pairs(disp, mask)
    _check(g_desc, "g_desc", torch.float64,
           lead + (K, num_radial + num_3body))
    _check(e_env, "e_env", torch.float64, lead + (K,))
    dev = disp.device
    g = torch.empty(lead + (K, 3), dtype=torch.float64, device=dev)
    _launch("pair_desc_vjp", dev, _ptr(g_desc), _ptr(e_env), _ptr(disp),
            _ptr(mask), _ptr(_mu(num_3body, dev)), n, K, num_radial,
            num_3body, float(cutoff), _ptr(g))
    pair_desc_vjp.launches += 1
    return g


def _gather_t(gF, jidx):
    """The force gather's transpose: per pair gF[a] - gF[jidx[a, k]]
    (N, A, K, 3) from gF (N, A, 3) and jidx (N, A, K)."""
    N, A, K = jidx.shape
    gj = torch.gather(gF, 1, jidx.long().reshape(N, A * K, 1)
                      .expand(N, A * K, 3)).reshape(N, A, K, 3)
    return gF[:, :, None, :] - gj


def pair_desc_jvp_plain(h, disp, mask, cutoff, num_radial, num_3body,
                        jidx=None):
    """Plain K15T: (J h (..., K, R + M), grad fc . h (..., K)) for a
    tangent h (..., K, 3) of the displacements; with jidx (N, A, K), h is
    the forces' cotangent gF (N, A, 3) and the tangent the gather's
    transpose gF[a] - gF[jidx[a, k]]."""
    if jidx is not None:
        h = _gather_t(h, jidx)
    return ops.pair_desc_jvp(h, disp, mask, cutoff, num_radial, num_3body)


def pair_desc_jvp(h, disp, mask, cutoff, num_radial, num_3body, jidx=None):
    """K15T on the card; same arguments and outputs as the plain version
    (with jidx the gather's transpose runs inside the kernel)."""
    tensors = (h, disp, mask) + ((jidx,) if jidx is not None else ())
    if _on_cpu(*tensors):
        return pair_desc_jvp_plain(h, disp, mask, cutoff, num_radial,
                                   num_3body, jidx)
    lead, n, K = _check_pairs(disp, mask)
    dev = disp.device
    if jidx is None:
        _check(h, "h", torch.float64, lead + (K, 3))
        hp, gp, jp, A = _ptr(h), None, None, 1
    else:
        N, A = jidx.shape[:2]
        _check(jidx, "jidx", torch.int32, (N, A, K))
        _check(h, "gF", torch.float64, (N, A, 3))
        if N * A != n:
            raise ValueError(f"jidx {tuple(jidx.shape)} does not match disp "
                             f"{tuple(disp.shape)}")
        hp, gp, jp = None, _ptr(h), _ptr(jidx)
    D = num_radial + num_3body
    out = torch.empty(lead + (K, D), dtype=torch.float64, device=dev)
    fcdot = torch.empty(lead + (K,), dtype=torch.float64, device=dev)
    _launch("pair_desc_jvp", dev, hp, gp, jp, A, _ptr(disp), _ptr(mask),
            _ptr(_mu(num_3body, dev)), n, K, num_radial, num_3body,
            float(cutoff), _ptr(out), _ptr(fcdot))
    pair_desc_jvp.launches += 1
    return out, fcdot


class PairDescForce(torch.autograd.Function):
    """Forces (N, A, 3) of the pairwise model from g_desc = dE/d(descriptor)
    (N, A, K, R + M) and e_env (N, A, K), the pair energies on live slots:
    K15V's pair gradient, then the gather through rev (N, A, R).  F is
    linear in (g_desc, e_env): its backward is K15T on the gather's
    transpose (through jidx (N, A, K)).  Only g_desc and e_env take a
    gradient."""

    @staticmethod
    def forward(ctx, g_desc, e_env, disp, mask, jidx, rev, cutoff,
                num_radial, num_3body):
        ctx.save_for_backward(disp, mask, jidx)
        ctx.shape = (cutoff, num_radial, num_3body)
        g = pair_desc_vjp(g_desc.contiguous(), e_env.contiguous(), disp,
                          mask, cutoff, num_radial, num_3body)
        return nn_pair_gather(g, rev)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gF):
        disp, mask, jidx = ctx.saved_tensors
        out, fcdot = pair_desc_jvp(gF.contiguous(), disp, mask, *ctx.shape,
                                   jidx=jidx)
        return (out, fcdot) + (None,) * 7


KERNELS = (pair_desc, pair_desc_vjp, pair_desc_jvp)
for _k in KERNELS:
    _k.launches = 0


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}
