"""Finite-difference force verification harness (reference
`fitsnap3lib/tools/test_tools.py`).

Displaces each coordinate of a chosen configuration by +-h, recomputes the
model energy through the whole prediction path, and compares -dE/dx
against the model force.  Works for the NN solver on SNAP or ACE
descriptors.

Counterpart of `fitsnap_tpu/tools/test_tools.py` in PyTorch: the energy and
forces come from the port's precompute prediction path on the solver's
device (`calculator.nn_prep`, then the solver's `_forward_batch`, whose
forces are K12's contraction on the card), whatever mode the fit ran in.
"""

import numpy as np


class TestTools:
    def __init__(self, input_script_or_settings, arglist=None, device=None):
        from fitsnap_tpu_torch.fitsnap import FitSnap

        self.fs = FitSnap(input_script_or_settings,
                          arglist=arglist or ["--overwrite"], device=device)

    def finite_difference(self, group, config_index=0, h=1e-5,
                          max_atoms=None, epochs=2):
        """Returns (mean_abs_err, max_abs_err, details) comparing model
        forces with central finite differences of the model energy."""
        fs = self.fs
        fs.scrape_configs()
        data = [d for d in fs.data if d["Group"] == group]
        assert config_index < len(data), "config_index out of range"
        data = data[:max(6, config_index + 1)]
        net = fs.solver.net
        net.num_epochs = epochs
        net.manual_seed_flag = 1
        fs.solver.prepare_dataset(fs.calculator, data)
        fs.solver.perform_fit(calculator=fs.calculator, data=data)

        d = data[config_index]
        pos = np.asarray(d["Positions"], float)
        cell = np.asarray(d["Lattice"], float)
        types_str = d["AtomTypes"]
        e0, f0 = self._eval(pos, cell, types_str)
        errs = []
        details = []
        natoms = len(pos)
        atoms = range(natoms) if max_atoms is None \
            else range(min(max_atoms, natoms))
        for a in atoms:
            for c in range(3):
                pp = pos.copy()
                pp[a, c] += h
                ep, _ = self._eval(pp, cell, types_str)
                pm = pos.copy()
                pm[a, c] -= h
                em, _ = self._eval(pm, cell, types_str)
                fd = -(ep - em) / (2 * h)
                errs.append(abs(fd - f0[a, c]))
                details.append((a, c, fd, float(f0[a, c])))
        errs = np.asarray(errs)
        return float(errs.mean()), float(errs.max()), details

    def _eval(self, pos, cell, types_str):
        """Total model energy and forces (N, 3) of one configuration: host
        neighbor lists, `calculator.nn_prep` (B and dB/dD) and the solver's
        `_forward_batch` on the solver's device."""
        import torch

        from fitsnap_tpu_torch.ops.neighbors import (host_neighbors,
                                                     reverse_neighbors)

        fs = self.fs
        sol = fs.solver
        calc = fs.calculator
        N = len(pos)
        types = np.array([calc.type_mapping[t] - 1 for t in types_str],
                         np.int32)
        disp, jidx, mask, _ = host_neighbors(pos, cell, N, calc.cutoff)
        rev = reverse_neighbors(jidx, mask, N)

        def put(x):
            return torch.as_tensor(x, device=sol.device)[None]

        types_t, jidx_t = put(types), put(jidx)
        nat = torch.tensor([N], device=sol.device)
        B, G, _, _ = calc.nn_prep(put(disp), jidx_t, put(mask), put(rev),
                                  types_t, nat)
        elem = types_t if sol.net.multi_element_option == 2 \
            else torch.zeros_like(types_t)
        batch = {
            "B": B, "G": G, "types": elem,
            "real": torch.ones((1, N), dtype=torch.bool, device=sol.device),
            "nat": nat, "jidx": jidx_t, "rev": put(rev),
        }
        e_per_atom, forces = sol._forward_batch(sol.model, batch)
        return float(e_per_atom[0]) * N, forces[0].cpu().numpy()
