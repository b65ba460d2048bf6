"""Wrappers of the NN solver's CUDA kernels, with their plain PyTorch
versions beside them.

| kernel | source | replaces (fitsnap_tpu) |
| K12 nn_force | csrc/nn_force.cu | solvers/network.py _forward_batch (:737-741) |
| K12T nn_force_t | csrc/nn_force.cu | its transpose (autodiff of the same lines) |

`NnForce` is the autograd function of the pair: forward K12, backward
K12T; G, jidx and rev take no gradient.  Each wrapper takes its plain
version for tensors on the CPU, launches its kernel for tensors on a CUDA
device, and raises for anything else.  Every launch adds one to the
wrapper's `launches` count.
"""

import torch

from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels.launch import (check as _check,
                                              launch as _launch,
                                              on_cpu as _on_cpu, ptr as _ptr)

_P, _I = kl.P, kl.I
kl.register("nn_force", "nn_force", [_P] * 3 + [_I] * 5 + [_P] * 3)
kl.register("nn_force_t", "nn_force", [_P] * 3 + [_I] * 4 + [_P] * 2)


def nn_force_plain(dEdB, G, jidx, rev):
    """Plain K12: forces F (N, A, 3) from dE/dB (N, A, W), G (N, A, W, K,
    3) and the reverse table rev (N, A, R) of flat slots a*K + k (-1
    padded); jidx is not read (rev carries the neighbor map)."""
    N, A, W, K, _ = G.shape
    R = rev.shape[2]
    fpair = torch.einsum("naw,nawkc->nakc", dEdB, G)
    flat = torch.cat([fpair.reshape(N, A * K, 3),
                      fpair.new_zeros((N, 1, 3))], 1)
    idx = torch.where(rev < 0, A * K, rev).long().reshape(N, A * R, 1)
    scat = torch.gather(flat, 1, idx.expand(N, A * R, 3))
    return fpair.sum(2) - scat.reshape(N, A, R, 3).sum(2)


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


def nn_force(dEdB, G, jidx, rev):
    """K12 on the card; same arguments and output as the plain version."""
    if _on_cpu(dEdB, G, jidx, rev):
        return nn_force_plain(dEdB, G, jidx, rev)
    N, A, W, K = _check_pairs(G, rev, "rev")
    _check(dEdB, "dEdB", torch.float64, (N, A, W))
    R = rev.shape[2]
    dev = G.device
    fpair = torch.empty((N, A, K, 3), dtype=torch.float64, device=dev)
    force = torch.empty((N, A, 3), dtype=torch.float64, device=dev)
    _launch("nn_force", dev, _ptr(dEdB), _ptr(G), _ptr(rev), N, A, W, K, R,
            _ptr(fpair), _ptr(force))
    nn_force.launches += 1
    return force


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


nn_force.launches = 0
nn_force_t.launches = 0


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


KERNELS = (nn_force, nn_force_t)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


def launches():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}
