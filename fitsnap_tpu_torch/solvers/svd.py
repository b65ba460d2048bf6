"""SVD and TfSVD solvers, as `fitsnap_tpu/solvers/svd.py`'s.

`SVD` solves the weighted system on the host with numpy's SVD-based lstsq
at singular-value cutoff 1e-13.  `TfSVD` (the reference's TensorflowSVD)
forms the normal equations on the device and solves them there with
`torch.linalg.solve`, as the JAX package does with `jnp.linalg.solve`.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.solvers.solver import Solver
from fitsnap_tpu_torch.solvers.tpu_svd import weighted_system
from fitsnap_tpu_torch.utils.torchsetup import resolve_device


class TfSVD(Solver):
    """Dense lstsq through the normal equations on the device (reference
    `solvers/tensorflowsvd.py`, tf.linalg.lstsq with fast=True)."""

    def __init__(self, name, config, device=None):
        super().__init__(name, config)
        self.device = resolve_device(device)

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        aw, bw = weighted_system(a, b, w, fs_dict, trainall, self.device)
        self.fit = torch.linalg.solve(aw.T @ aw, aw.T @ bw).cpu().numpy()
        return self.fit


class SVD(Solver):
    def perform_fit(self, a=None, b=None, w=None, fs_dict=None, trainall=False):
        if fs_dict is not None and not trainall:
            training = np.array([not t for t in fs_dict["Testing"]])
        else:
            training = np.ones(a.shape[0], bool)
        wt = w[training]
        aw, bw = wt[:, None] * a[training], wt * b[training]
        extras = self.config.sections.get("EXTRAS") if self.config else None
        if extras is not None and extras.apply_transpose:
            if np.linalg.cond(aw) ** 2 < 1 / np.finfo(aw.dtype).eps:
                bw = aw.T @ bw
                aw = aw.T @ aw
        self.fit, _, _, _ = np.linalg.lstsq(aw, bw, rcond=1.0e-13)
        return self.fit
