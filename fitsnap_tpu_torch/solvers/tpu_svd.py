"""Device linear solve through the normal equations, as
`fitsnap_tpu/solvers/tpu_svd.py`'s `TpuSVD`.

The weighted rows go to the device, AtA and Atb are formed there
(`torch.matmul`, as the JAX package leaves them to XLA) and come back for
the host float64 `NormalSolver` (column equilibration and an eigh
pseudo-inverse).  Under a process group of W ranks the rows are padded
with zero rows to a multiple of W and split into contiguous blocks (the
JAX package's row sharding over its mesh): each rank squares its block,
AtA and Atb are summed over the group, and every rank solves.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.parallel.fit import NormalSolver
from fitsnap_tpu_torch.solvers.solver import Solver
from fitsnap_tpu_torch.utils.torchsetup import (all_sum, resolve_device,
                                                share, world)


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
        pad = (-len(aw)) % world()[1]
        if pad:
            aw = torch.cat([aw, aw.new_zeros((pad, aw.shape[1]))])
            bw = torch.cat([bw, bw.new_zeros((pad,))])
        own = share(len(aw), "rows")
        aw, bw = aw[own], bw[own]
        AtA, Atb = all_sum(aw.T @ aw, aw.T @ bw)
        self.fit = NormalSolver(AtA.cpu().numpy()).solve(Atb.cpu().numpy())
        return self.fit
