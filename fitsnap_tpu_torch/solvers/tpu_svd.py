"""Device linear solve through the normal equations, as
`fitsnap_tpu/solvers/tpu_svd.py`'s `TpuSVD` on one device.

The weighted rows go to the device, AtA and Atb are formed there
(`torch.matmul`, as the JAX package leaves them to XLA) and come back for
the host float64 `NormalSolver` (column equilibration and an eigh
pseudo-inverse).  Sharding the rows over several cards waits for
multi-GPU (ROADMAP.md "Multi-GPU").
"""

import numpy as np
import torch

from fitsnap_tpu_torch.parallel.fit import NormalSolver
from fitsnap_tpu_torch.solvers.solver import Solver
from fitsnap_tpu_torch.utils.torchsetup import resolve_device


def weighted_system(a, b, w, fs_dict, trainall, device):
    """(w a, w b) of the training rows, as float64 tensors on `device`."""
    if fs_dict is not None and not trainall:
        training = np.array([not t for t in fs_dict["Testing"]])
    else:
        training = np.ones(a.shape[0], bool)
    wt = w[training]
    aw = torch.as_tensor(wt[:, None] * a[training], dtype=torch.float64,
                         device=device)
    bw = torch.as_tensor(wt * b[training], dtype=torch.float64,
                         device=device)
    return aw, bw


class TpuSVD(Solver):
    def __init__(self, name, config, device=None):
        super().__init__(name, config)
        self.device = resolve_device(device)

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        aw, bw = weighted_system(a, b, w, fs_dict, trainall, self.device)
        AtA = (aw.T @ aw).cpu().numpy()
        Atb = (aw.T @ bw).cpu().numpy()
        self.fit = NormalSolver(AtA).solve(Atb)
        return self.fit
