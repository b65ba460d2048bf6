"""Export trained MLP potentials as LAMMPS ML-IAP torch modules.

Copy of `fitsnap_tpu/io/export_torch.py` for the per-atom MLP (the
pairwise `PairNNWrapper` comes with the custom pairwise NN, ROADMAP.md
"Custom pairwise NN").  The saved `.pt` is a module whose
`forward(elems, descriptors, beta, energy)` fills per-atom energies and
betas (dE/dB) for `pair_style mliap model mliappy`.  Descriptor standardization is folded into the first
linear layer so LAMMPS can feed raw descriptors.  The activation is the
training's softplus (`models.mlp.softplus`), not `torch.nn.Softplus`, which
is the identity above 20 (about 2e-9 off there), so the module computes the
trained function.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.models.mlp import softplus


class Softplus(torch.nn.Module):
    """log(1 + e^h) at every h, as the MLP is trained with."""

    def forward(self, h):
        return softplus(h)


class Elementwise(torch.nn.Module):
    """Per-element subnetwork dispatch (single subnet = shared net)."""

    def __init__(self, subnets):
        super().__init__()
        self.subnets = torch.nn.ModuleList(subnets)

    def forward(self, descriptors, elems):
        if len(self.subnets) == 1:
            return self.subnets[0](descriptors).flatten()
        out = torch.zeros(descriptors.shape[0], dtype=descriptors.dtype)
        for e, net in enumerate(self.subnets):
            m = elems == e
            if m.any():
                out[m] = net(descriptors[m]).flatten()
        return out


class MliapWrapper(torch.nn.Module):
    """LAMMPS mliappy-compatible wrapper (reference `write.py:17`)."""

    def __init__(self, model, n_descriptors, n_elements):
        super().__init__()
        self.model = model
        self.device = "cpu"
        self.dtype = torch.float64
        self.n_params = sum(p.nelement() for p in model.parameters())
        self.n_descriptors = n_descriptors
        self.n_elements = n_elements

    def forward(self, elems, descriptors, beta, energy):
        d = torch.from_numpy(descriptors).to(self.dtype) \
            .requires_grad_(True)
        el = torch.from_numpy(elems).to(torch.long)
        with torch.autograd.enable_grad():
            e_nn = self.model(d, el)
            beta_nn = torch.autograd.grad(e_nn.sum(), d)[0]
        beta[:] = beta_nn.detach().cpu().numpy().astype(np.float64)
        energy[:] = e_nn.detach().cpu().numpy().astype(np.float64)


def build_torch_model(params, mean, std):
    """MLP params [(W (nelem, nin, nout), b (nelem, nout)), ...] as numpy
    arrays -> list of per-element torch Sequential nets on the CPU."""
    nelem = params[0][0].shape[0]
    nets = []
    for e in range(nelem):
        layers = []
        nlayers = len(params)
        for i, (w, b) in enumerate(params):
            wt = np.asarray(w[e], np.float64)        # (nin, nout)
            bt = np.asarray(b[e], np.float64)
            if i == 0:
                # fold standardization: x = (B - mean)/std
                # (B @ (W/std) + (b - mean @ (W/std)))
                wt = wt / np.asarray(std, np.float64)[:, None]
                bt = bt - np.asarray(mean, np.float64) @ wt
            lin = torch.nn.Linear(wt.shape[0], wt.shape[1]).double()
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(wt.T.copy()))
                lin.bias.copy_(torch.from_numpy(bt.copy()))
            layers.append(lin)
            if i < nlayers - 1:
                layers.append(Softplus())
        nets.append(torch.nn.Sequential(*layers))
    return nets


def export_mliap(path, params, mean, std, n_elements):
    nets = build_torch_model(params, mean, std)
    ndesc = params[0][0].shape[1]
    wrapper = MliapWrapper(Elementwise(nets), ndesc, n_elements)
    torch.save(wrapper, path)
    return wrapper
