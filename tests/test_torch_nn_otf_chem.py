"""The NN solver's OTF mode in fitsnap_tpu_torch against fitsnap_tpu (CPU,
float64) under chemflag.

Under chemflag each OTF step rebuilds the neighbor lists (K8, K8r), forms
B and dB/dD of the minibatch with K1-K3's chemflag modes, and takes the
forces through K12 (`NnForce`, backward K12T); that dB/dD lives for one
step.  Five InP-shaped cells (two elements, twojmax 4, chemflag,
bnormflag, wselfallflag, the ZBL reference) go through both packages'
FitSnap with the same initial weights, one shared network
(multi_element_option 1) and one per element (2).  The checks and
tolerances of `tests/test_torch_nn_otf.py`: the buckets (1e-12), the
minibatch forward, the loss and its parameter gradient, two-epoch fits
(1e-10), the port's OTF against its precompute mode (1e-9), `auto` past
both limits, and `cached` falling back to OTF with the JAX package's
warning.
"""

import numpy as np
import pytest

from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn_otf import (WARNING, check_buckets, check_fit,
                                     check_forward, check_loss_and_gradient,
                                     check_other_mode, prepare_both, run_both)


def inp_otf_settings(root, option=1, dgrad_mode="otf"):
    """Five InP-shaped cells under `root`/JSON and their settings: the
    InP_JPCA2020 BISPECTRUM at twojmax 4, an MLP of widths 6 and 1."""
    rng = np.random.default_rng(59)
    counts = {"Volume_ZB": 2, "Strain_ZB": 3}
    for group, confs in synthetic.inp_configs(7, counts).items():
        (root / "JSON" / group).mkdir(parents=True)
        for i, (pos, cell, names) in enumerate(confs):
            n = len(pos)
            pos = pos + rng.normal(0.0, 0.08, pos.shape)
            (root / "JSON" / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(pos, cell, energy=-3.4 * n,
                                      forces=rng.normal(0, 0.3, (n, 3)),
                                      types=names))
    s = synthetic.inp_settings(root / "JSON", groups=list(counts))
    s["BISPECTRUM"]["twojmax"] = "4 4"
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = {"layer_sizes": "num_desc 6 1", "batch_size": 2,
                    "num_epochs": 2, "learning_rate": 1e-3,
                    "multi_element_option": option, "manual_seed_flag": 1,
                    "energy_weight": 1e-2, "force_weight": 1.0,
                    "dgrad_mode": dgrad_mode}
    s["EXTRAS"] = {"dump_peratom": 1, "dump_perconfig": 1}
    return s


@pytest.fixture(scope="module", params=[1, 2])
def fits(request, tmp_path_factory):
    """Two-epoch OTF fits with multi_element_option 1 and 2."""
    root = tmp_path_factory.mktemp(f"otf_chem_{request.param}")
    out = run_both(root, inp_otf_settings(root, request.param), seed=61)
    out["option"] = request.param
    return out


def test_otf_chem_buckets_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    check_buckets(port, jsol)
    assert port._kit is None and port._snap.chemflag
    # the network index is zeroed unless there is a network per element;
    # the atom types the descriptors read are not
    ds = port.buckets[0]
    assert ds["types"].any() and ds["elem"].any() == (fits["option"] == 2)


def test_forward_batch_otf_chem_equals_jax(fits):
    check_forward(fits["port"].solver, fits["jax"].solver, 23)


@pytest.mark.parametrize("nelem", [1, 2])
def test_otf_chem_loss_and_gradient_equal_jax(fits, nelem):
    check_loss_and_gradient(fits["port"].solver, fits["jax"].solver, nelem,
                            29)


def test_otf_chem_fit_equals_jax(fits):
    check_fit(fits)
    nets = fits["port"].solver.model.params[0][0].shape[0]
    assert nets == fits["option"]


def test_otf_chem_forces_equal_precompute(fits, tmp_path):
    check_other_mode(fits, "precompute", tmp_path)


@pytest.mark.parametrize("mode", ["auto", "cached"])
def test_chem_modes_resolve_to_otf_as_jax(tmp_path, capsys, monkeypatch,
                                          mode):
    """`auto` with dB/dD over G_LIMIT (0 bytes in both packages) and
    `cached` (no kit under chemflag) take OTF in both packages, `cached`
    with the JAX package's warning; the buckets are the same."""
    monkeypatch.setattr("fitsnap_tpu_torch.solvers.network.G_LIMIT", 0)
    monkeypatch.setenv("FITSNAP_TPU_NN_G_LIMIT", "0")
    port, jsol = prepare_both(inp_otf_settings(tmp_path, dgrad_mode=mode),
                              tmp_path)
    out = capsys.readouterr().out
    if mode == "auto":
        assert "dgrad_mode=auto -> otf" in out
    else:
        assert out.count(WARNING) == 2
    assert port.otf and jsol.otf and not (port.cached or jsol.cached)
    check_buckets(port, jsol)
