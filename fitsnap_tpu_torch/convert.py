"""Carry state of the JAX package across as plain numpy arrays.

The port imports nothing of `fitsnap_tpu`; a caller that has both (the
parity tests) reads the fields of a JAX `SnapParams` and its `SnapPlan`, or
the layers of a JAX MLP, as numpy arrays and hands them over here, so that
both packages compute from identical tables and weights.
"""

import numpy as np
import torch

from fitsnap_tpu_torch.models.mlp import params_to_numpy
from fitsnap_tpu_torch.ops.ace import AcePlan
from fitsnap_tpu_torch.ops.snap import SnapParams, params_from_arrays

ACE_PLAN_FIELDS = ("numtypes", "nradbase", "nmax_per_l", "lmax", "rcut",
                   "lmbda", "rcinner", "drcinner", "labels", "a_index", "nA",
                   "t_fact", "t_coef", "t_label", "t_mu0", "rank_max", "mmat",
                   "radial", "ylm", "spline_delta")
PLAN_FIELDS = ("i1", "i2", "i3", "mmat", "bzero", "self_idx", "y_src",
               "y_fac", "z_dense", "bzeroflag", "twojmax", "nelements",
               "chemflag", "wselfallflag", "quadraticflag", "nb_base", "iq1",
               "iq2", "qcoef")
PARAM_FIELDS = ("radelem", "wj", "rcutfac", "rfac0", "rmin0", "switchflag",
                "switchinnerflag", "sinner", "dinner", "wself")


def snap_params_from_numpy(d: dict, device="cpu") -> SnapParams:
    """The port's SnapParams on `device` from the JAX fields in `d`.

    `d` holds PARAM_FIELDS (radelem, wj as arrays; sinner, dinner as arrays
    or None) and PLAN_FIELDS (i1, i2, i3, mmat, bzero, self_idx, y_src,
    y_fac, the z_dense dict of grouped term tables, bzeroflag, twojmax, and
    the chemflag / quadraticflag fields: nelements, chemflag, wselfallflag,
    quadraticflag, nb_base, iq1, iq2, qcoef).
    """
    missing = [k for k in PLAN_FIELDS + PARAM_FIELDS if k not in d]
    if missing:
        raise KeyError(f"snap_params_from_numpy: missing {missing}")
    return params_from_arrays(d, device)


def ace_plan_from_numpy(d: dict) -> AcePlan:
    """The port's AcePlan from the fields of a JAX `AcePlan` in `d`
    (ACE_PLAN_FIELDS: arrays as numpy arrays, labels and a_index as lists
    and dicts).  Its device tables are built at first use."""
    missing = [k for k in ACE_PLAN_FIELDS if k not in d]
    if missing:
        raise KeyError(f"ace_plan_from_numpy: missing {missing}")
    f = {k: d[k] for k in ACE_PLAN_FIELDS}
    for k in ("rcut", "lmbda", "rcinner", "drcinner", "t_coef", "mmat"):
        f[k] = np.array(f[k], np.float64)
    for k in ("t_fact", "t_label", "t_mu0"):
        f[k] = np.array(f[k], np.int32)
    f["labels"] = [(int(mu0), tuple(mus), tuple(ns), tuple(ls), tuple(Ls))
                   for mu0, mus, ns, ls, Ls in f["labels"]]
    f["a_index"] = {tuple(int(v) for v in k): int(i)
                    for k, i in dict(f["a_index"]).items()}
    f["nmax_per_l"] = dict(f["nmax_per_l"])
    return AcePlan(**f)


def coeffs_from_numpy(coeffs, device="cpu") -> torch.Tensor:
    """A fitted coefficient vector as a float64 tensor on `device`."""
    return torch.as_tensor(np.asarray(coeffs, np.float64),
                           device=torch.device(device))


def mlp_params_from_numpy(params, device="cpu", dtype=torch.float64):
    """MLP parameters [(W (nelem, nin, nout), b (nelem, nout)), ...] given
    as numpy arrays (a JAX MLP's, `[(np.asarray(w), np.asarray(b)) ...]`)
    as `dtype` tensors on `device` (each value rounded once from its
    float64 value), the port's layout."""
    dev = torch.device(device)
    return [tuple(torch.as_tensor(np.asarray(x, np.float64), device=dev)
                  .to(dtype) for x in (w, b))
            for w, b in params]


def mlp_params_to_numpy(params):
    """The port's MLP parameters as float64 numpy arrays, the layout the JAX
    package's `atom_energies` and its saved states take."""
    return params_to_numpy(params)
