"""SVD (least-squares) solver, as `fitsnap_tpu/solvers/svd.py`'s `SVD`.

Solves the weighted system on the host with numpy's SVD-based lstsq at
singular-value cutoff 1e-13.  The device solvers (`TfSVD`, `TpuSVD`) come
in a later slice (ROADMAP.md, queue 1).
"""

import numpy as np

from fitsnap_tpu_torch.solvers.solver import Solver


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
