"""Carry state of the JAX package across as plain numpy arrays.

The port imports nothing of `fitsnap_tpu`; a caller that has both (the
parity tests) reads the fields of a JAX `SnapParams` and its `SnapPlan` as
numpy arrays and hands them over here, so that both packages compute from
identical tables.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.ops.snap import SnapParams, params_from_arrays

PLAN_FIELDS = ("i1", "i2", "i3", "mmat", "bzero", "self_idx", "y_src",
               "y_fac", "z_dense", "bzeroflag", "twojmax")
PARAM_FIELDS = ("radelem", "wj", "rcutfac", "rfac0", "rmin0", "switchflag",
                "switchinnerflag", "sinner", "dinner", "wself")


def snap_params_from_numpy(d: dict, device="cpu") -> SnapParams:
    """The port's SnapParams on `device` from the JAX fields in `d`.

    `d` holds PARAM_FIELDS (radelem, wj as arrays; sinner, dinner as arrays
    or None) and PLAN_FIELDS (i1, i2, i3, mmat, bzero, self_idx, y_src,
    y_fac, the z_dense dict of grouped term tables, bzeroflag, twojmax).
    Only the single-channel linear plan is taken: chemflag and
    quadraticflag are not ported yet.
    """
    missing = [k for k in PLAN_FIELDS + PARAM_FIELDS if k not in d]
    if missing:
        raise KeyError(f"snap_params_from_numpy: missing {missing}")
    return params_from_arrays(d, device)


def coeffs_from_numpy(coeffs, device="cpu") -> torch.Tensor:
    """A fitted coefficient vector as a float64 tensor on `device`."""
    return torch.as_tensor(np.asarray(coeffs, np.float64),
                           device=torch.device(device))
