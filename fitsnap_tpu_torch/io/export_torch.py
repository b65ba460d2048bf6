"""Export trained MLP potentials as LAMMPS ML-IAP torch modules.

Copy of `fitsnap_tpu/io/export_torch.py`: the per-atom MLP's
`MliapWrapper`, whose `forward(elems, descriptors, beta, energy)` fills
per-atom energies and betas (dE/dB) for `pair_style mliap model mliappy`,
and the pairwise (CUSTOM) NN's `PairNNWrapper`, which computes its
descriptors from the pair displacements LAMMPS passes and fills dE/drij.
Descriptor standardization is folded into the first linear layer so LAMMPS
can feed raw descriptors.  The saved modules run on the CPU in LAMMPS: the
pairwise one's descriptor math is plain torch, not the training kernels.
The activation is the training's softplus (`models.mlp.softplus`), not
`torch.nn.Softplus`, which is the identity above 20 (about 2e-9 off
there), so the module computes the trained function.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.models.mlp import softplus
from fitsnap_tpu_torch.utils.torchsetup import open_output


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



class PairNNWrapper(torch.nn.Module):
    """LAMMPS mliappy wrapper for pairwise-NN (CUSTOM) potentials.

    Deployment parity with reference `write.py:189 PairNN`, with one
    deliberate deviation: cutoff/num_radial/num_3body come from the
    trained model (the reference hardcodes 3.0/5/12 regardless of what
    was fit).  The descriptor math is the training math
    (`ops/custom_desc.py`), which matches the reference formulas: rmin=3.5
    envelope on the radial/eij legs (bessel.py:76-87), rmin=0 cosine on
    the 3-body leg (g3b.py:105), zeroed-diagonal 3-body term, plus an
    r >= c clamp the reference omits (its neighbor list cannot produce
    such pairs).  Standardization is folded into layer 1 of `model`.

    forward(elems, descriptors, beta, energy, rij, unique_i, unique_j,
    tag_i, tag_j) fills `beta[:, :] = dE/drij` (the reference's
    convention; LAMMPS assembles forces from the pair gradients) and
    `energy[:]` with per-atom energies (sum of eij over pairs of i).
    """

    RMIN = 3.5
    ETA = 4.0

    def __init__(self, model, cutoff, num_radial, num_3body, n_elements):
        super().__init__()
        self.model = model
        self.device = "cpu"
        self.dtype = torch.float64
        self.cutoff = float(cutoff)
        self.num_radial_descriptors = int(num_radial)
        self.num_3body_descriptors = int(num_3body)
        self.n_descriptors = int(num_radial + num_3body)
        self.n_elements = n_elements
        self.n_params = sum(p.nelement() for p in model.parameters())
        self.mu = torch.linspace(-1, 1, int(num_3body)).double()

    def cutoff_function(self, r):
        c = self.cutoff
        ramp = 0.5 + 0.5 * torch.cos(
            torch.pi * (r - self.RMIN) / (c - self.RMIN))
        fc = torch.where(r > self.RMIN, ramp, torch.ones_like(r))
        return torch.where(r >= c, torch.zeros_like(r), fc)

    def cutoff_function_3body(self, r):
        # the 3-body leg uses the reference's rmin=0 cosine cutoff
        # (g3b.py:105), NOT the radial rmin=3.5 envelope
        fc = 0.5 + 0.5 * torch.cos(torch.pi * r / self.cutoff)
        return torch.where(r >= self.cutoff, torch.zeros_like(r), fc)

    def pair_descriptors(self, rij, unique_i):
        r = torch.linalg.norm(rij, dim=1, keepdim=True)
        unit = rij / r
        fc = self.cutoff_function(r)
        fc3 = self.cutoff_function_3body(r)
        n = torch.arange(1, self.num_radial_descriptors + 1,
                         dtype=rij.dtype)
        c = self.cutoff
        rbf = (2.0 / c) ** 0.5 * torch.sin((n * torch.pi / c) * r) \
            / r * fc
        g3 = torch.zeros(r.shape[0], self.num_3body_descriptors,
                         dtype=rij.dtype)
        for i in torch.unique(unique_i):
            m = unique_i == i
            cos = (unit[m] @ unit[m].T).fill_diagonal_(0.0)
            gauss = torch.exp(-self.ETA * (cos[:, :, None] - self.mu) ** 2)
            g3[m] = (gauss * fc3[m][None, :, :]).sum(dim=1)
        return torch.cat([rbf, g3], dim=1), fc

    def forward(self, elems, descriptors, beta, energy, rij, unique_i,
                unique_j, tag_i, tag_j):
        d = torch.from_numpy(rij).to(self.dtype).requires_grad_(True)
        ui = torch.from_numpy(unique_i).to(torch.long)
        el = torch.from_numpy(elems).to(torch.long)
        with torch.autograd.enable_grad():
            desc, fc = self.pair_descriptors(d, ui)
            # the pair's subnet is atom i's element (the training contract,
            # solvers/network.py _forward_pairwise)
            eij = self.model(desc, el[ui])[:, None] * fc
            etot = eij.sum()
            dEdr = torch.autograd.grad(etot, d)[0]
        beta[:, :] = dEdr.detach().cpu().numpy().astype(np.float64)
        # scatter by LOCAL listed-atom index (unique_i): the mliappy energy
        # array is indexed by local atom, and with LAMMPS atom sorting or
        # MPI the global tags neither match local indices nor are bounded
        # by len(energy)
        e_i = torch.zeros(len(energy), dtype=self.dtype)
        e_i.index_add_(0, ui, eij.detach().flatten())
        energy[:] = e_i.cpu().numpy().astype(np.float64)

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
    with open_output(path, "wb") as f:
        torch.save(wrapper, f)
    return wrapper


def export_pairnn(path, params, mean, std, cutoff, num_radial, num_3body,
                  n_elements):
    """Pairwise (CUSTOM) NN -> LAMMPS mliappy module (reference
    `pairwise.py:226 write_lammps_torch` -> `write.py:189 PairNN`)."""
    nets = build_torch_model(params, mean, std)
    wrapper = PairNNWrapper(Elementwise(nets), cutoff, num_radial,
                            num_3body, n_elements)
    with open_output(path, "wb") as f:
        torch.save(wrapper, f)
    return wrapper
