"""Per-atom MLP potential on descriptor inputs (PyTorch).

Counterpart of `fitsnap_tpu/models/mlp.py`: per-element subnetworks over
per-atom descriptors, softplus between layers, the output layer initialised
at zero.  Parameters are a list over layers of (W (nelem, nin, nout), b
(nelem, nout)); a single shared network is nelem = 1 with every atom mapped
to element 0 (multi_element_option 1).

Initial weights are drawn from a `torch.Generator`.  JAX's threefry draws
cannot be reproduced without JAX, so the same seed gives other initial
weights than the JAX package's; a test that compares the two packages
hands both the same parameters.
"""

import pickle

import numpy as np
import torch

from fitsnap_tpu_torch.utils.torchsetup import open_output


def init_mlp(layer_sizes, nelements, generator, device,
             dtype=torch.float64):
    """He-initialised per-element MLP stacks: [(W, b), ...] as `dtype`
    tensors on `device`, drawn at float64 and rounded once to `dtype`, so
    that one seed gives the same parameters at both types up to rounding.

    The output layer's W is zero, so the model starts at its bias (set to
    the mean target by the solver)."""
    params = []
    nlayers = len(layer_sizes) - 1
    for i, (nin, nout) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        if i == nlayers - 1:
            w = torch.zeros((nelements, nin, nout), dtype=torch.float64)
        else:
            w = torch.randn((nelements, nin, nout), generator=generator,
                            dtype=torch.float64) * np.sqrt(2.0 / nin)
        b = torch.zeros((nelements, nout), dtype=torch.float64)
        params.append((w.to(device, dtype), b.to(device, dtype)))
    return params


def softplus(h):
    """log(1 + e^h) without overflow, as `jax.nn.softplus` computes it
    (torch.nn.Softplus switches to the identity above h = 20)."""
    return torch.logaddexp(h, torch.zeros_like(h))


def _layer_stack(params, x, e):
    h = x
    n = len(params)
    for i, (w, b) in enumerate(params):
        h = h @ w[e] + b[e]
        if i < n - 1:
            h = softplus(h)
    return h[..., 0]


def atom_energies(params, x, elem):
    """Per-atom energies: x (..., A, nin), elem (..., A) -> (..., A).

    Each atom goes through its element's network.  With one element that
    is one product per layer; with several, the atoms of each element are
    selected and their energies put back in place, so no per-atom copy of
    the weights is made.  Differentiable twice (the force loss's gradient
    runs through dE/dx)."""
    nelem = params[0][0].shape[0]
    if nelem == 1:
        return _layer_stack(params, x, 0)
    shape = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    ef = elem.reshape(-1)
    out = xf.new_zeros(xf.shape[0])
    for e in range(nelem):
        sel = torch.nonzero(ef == e).squeeze(1)
        if sel.numel():
            out = out.index_put((sel,), _layer_stack(params, xf[sel], e))
    return out.reshape(shape)


class PerElementMLP(torch.nn.Module):
    """The model as a module: `layers` holds W0, b0, W1, b1, ... in the
    JAX package's leaf order, at the parameters' own type."""

    def __init__(self, params):
        super().__init__()
        self.layers = torch.nn.ParameterList()
        for w, b in params:
            self.layers.append(torch.nn.Parameter(w.clone()))
            self.layers.append(torch.nn.Parameter(b.clone()))

    @property
    def params(self):
        """[(W, b), ...] of the live parameters."""
        ls = list(self.layers)
        return list(zip(ls[0::2], ls[1::2]))

    def forward(self, x, elem):
        return atom_energies(self.params, x, elem)


def params_to_numpy(params):
    """[(W, b), ...] as float64 numpy arrays."""
    return [(w.detach().cpu().numpy().astype(np.float64),
             b.detach().cpu().numpy().astype(np.float64)) for w, b in params]


def save_params(path, params, meta):
    """The JAX package's pickle: {"params": [(w, b) numpy], "meta": {...}},
    the parameters at their own type, as the JAX package saves them."""
    flat = [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
            for w, b in params]
    with open_output(path, "wb") as f:
        pickle.dump({"params": flat, "meta": meta}, f)


def load_params(path):
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["params"], d["meta"]
