"""fitsnap_tpu_torch.ops.snap against fitsnap_tpu.ops.snap (CPU, float64).

The same synthetic neighbor blocks (numpy seeds) go through the JAX
functions and their port twins at twojmax 6, A=8, K=24; the port's tables
come from the JAX plan through `convert.snap_params_from_numpy`.  Cases
cover bzeroflag 0/1, switchflag off, switchinnerflag with two elements,
masked pairs and a self-image neighbor (an atom's own periodic image).
Tolerance: 1e-12 relative to the largest magnitude of each array (the two
packages sum in different orders at float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.ops import snap as jsnap
from fitsnap_tpu.ops.cg import build_snap_plan
from fitsnap_tpu_torch.convert import (PARAM_FIELDS, PLAN_FIELDS,
                                       snap_params_from_numpy)
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import snap as tsnap

A, K, TJ = 8, 24, 6
RTOL = 1e-12

CASES = {
    "bzero1": dict(bzeroflag=True, switchflag=True, inner=False, nelem=1),
    "bzero0": dict(bzeroflag=False, switchflag=True, inner=False, nelem=1),
    "noswitch": dict(bzeroflag=True, switchflag=False, inner=False, nelem=1),
    "inner2el": dict(bzeroflag=False, switchflag=True, inner=True, nelem=2),
}


def close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().cpu() if torch.is_tensor(port) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(port - ref).max() / scale
    assert err <= rtol, f"relative error {err:.3e}"


def jax_params(case):
    nelem = case["nelem"]
    plan = build_snap_plan(twojmax=TJ, nelements=nelem,
                           bzeroflag=case["bzeroflag"])
    radelem = np.array([0.5, 0.42][:nelem])
    wj = np.array([1.0, 0.73][:nelem])
    sinner = dinner = None
    if case["inner"]:
        sinner = np.array([1.3, 1.5][:nelem])
        dinner = np.array([0.4, 0.5][:nelem])
    return jsnap.SnapParams(
        plan=plan, rcutfac=4.67637, rfac0=0.99363, rmin0=0.0,
        switchflag=case["switchflag"], switchinnerflag=case["inner"],
        wj=wj, radelem=radelem, sinner=sinner, dinner=dinner)


def port_params(jp):
    d = {k: getattr(jp.plan, k) for k in PLAN_FIELDS}
    d.update({k: getattr(jp, k) for k in PARAM_FIELDS})
    return snap_params_from_numpy(d, "cpu")


def make_block(seed, nelem):
    """(disp, jelem, mask, ielem) of A atoms with K neighbor slots."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(A, K, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    r = rng.uniform(1.0, 4.9, size=(A, K, 1))
    disp = dirs * r
    disp[0, 1] = [3.3, 0.0, 0.0]            # self image through the cell
    mask = rng.uniform(size=(A, K)) < 0.85
    mask[-1] = False                        # a padded atom with no pairs
    jelem = rng.integers(0, nelem, size=(A, K)).astype(np.int32)
    ielem = rng.integers(0, nelem, size=(A,)).astype(np.int32)
    return disp, jelem, mask, ielem


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    spec = CASES[request.param]
    jp = jax_params(spec)
    disp, jelem, mask, ielem = make_block(11, spec["nelem"])
    jargs = (jnp.asarray(disp), jnp.asarray(jelem), jnp.asarray(mask),
             jnp.asarray(ielem))
    targs = (torch.from_numpy(disp), torch.from_numpy(jelem),
             torch.from_numpy(mask), torch.from_numpy(ielem))
    def reference(disp, jelem, mask, ielem):
        wu, J = jsnap._pair_wu_duals(disp, jelem, mask, ielem, jp)
        ut = jsnap._utot_from_wu(wu, jelem, ielem, jp)
        zr, zi = jsnap._compute_zcat(ut, jp.plan)
        dbdu = jsnap._dbdu_ylist(ut, jp.plan, (zr, zi))
        B, dBdD = jsnap.descriptors_with_jacobian(disp, jelem, mask, ielem,
                                                  jp)
        Bo = jsnap.atom_descriptors(disp, jelem, mask, ielem, jp)
        return dict(wu=wu, J=J, ut=ut, zr=zr, zi=zi, dbdu=dbdu, B=B,
                    dBdD=dBdD, B_oracle=Bo)

    ref = {k: np.array(v) for k, v in jax.jit(reference)(*jargs).items()}
    return dict(p=port_params(jp), targs=targs, ref=ref)


def test_pair_wu_duals(case):
    wu, J = tsnap._pair_wu_duals(*case["targs"], case["p"])
    close(wu, case["ref"]["wu"])
    close(J, case["ref"]["J"])


def test_utot_from_wu(case):
    _, jelem, _, ielem = case["targs"]
    ut = tsnap._utot_from_wu(torch.from_numpy(case["ref"]["wu"]), jelem,
                             ielem, case["p"])
    close(ut, case["ref"]["ut"])


def test_compute_zcat(case):
    zr, zi = tsnap._compute_zcat(torch.from_numpy(case["ref"]["ut"]),
                                 case["p"])
    close(zr, case["ref"]["zr"])
    close(zi, case["ref"]["zi"])


def test_dbdu_ylist(case):
    dbdu = tsnap._dbdu_ylist(torch.from_numpy(case["ref"]["ut"]), case["p"])
    close(dbdu, case["ref"]["dbdu"])


def test_descriptors_with_jacobian(case):
    B, dBdD = tsnap.descriptors_with_jacobian(*case["targs"], case["p"])
    close(B, case["ref"]["B"])
    close(dBdD, case["ref"]["dBdD"])


def test_atom_descriptors_recursion_oracle(case):
    """The recursion oracle agrees with the JAX oracle and with the
    monomial path's B."""
    Bo = tsnap.atom_descriptors(*case["targs"], case["p"])
    close(Bo, case["ref"]["B_oracle"])
    B, _ = tsnap.descriptors_with_jacobian(*case["targs"], case["p"])
    close(B, Bo, rtol=1e-11)


def test_wrappers_take_plain_on_cpu(case):
    """On CPU tensors the K1-K3 wrappers return their plain versions'
    results and launch nothing."""
    sk.reset_launches()
    p, targs = case["p"], case["targs"]
    J, ut = sk.pair_u_duals(*targs, p)
    J0, ut0 = sk.pair_u_duals_plain(*targs, p)
    assert torch.equal(J, J0) and torch.equal(ut, ut0)
    close(J, case["ref"]["J"])
    close(ut, case["ref"]["ut"])
    zr, zi = sk.zlist(ut, p)
    assert all(torch.equal(a, b) for a, b in zip((zr, zi),
                                                  sk.zlist_plain(ut, p)))
    B, dBdD = sk.dbdd(ut, zr, zi, J, p)
    B0, dBdD0 = sk.dbdd_plain(ut, zr, zi, J, p)
    assert torch.equal(B, B0) and torch.equal(dBdD, dBdD0)
    assert set(sk.launches().values()) == {0}
