"""The NN solver's OTF mode in fitsnap_tpu_torch against fitsnap_tpu (CPU,
float64): linear SNAP and quadraticflag.

In the OTF mode the buckets keep the positions alone, and every step
rebuilds the neighbor lists (K8, K8r) and the descriptors from them.  The
JAX package takes the forces by autodiff in the positions; the port takes
K9's ut and B into the cached step (K2, K10, K11 and the gather; K11T and
K10T in the loss gradient), and under quadraticflag folds the quadratic
columns' dE/dB back onto the base columns ahead of K10.  The small Ta set
of `tests/test_torch_nn.py` (twojmax 4, layers `num_desc 8 8 1`) goes
through both packages' FitSnap with the same initial weights.  Checks,
with their tolerances (relative to the largest magnitude):

- the OTF buckets: keys, shapes, configs, positions and image shifts
  exactly, targets and the standardization within 1e-12;
- `_forward_batch_otf` and `_loss` with its parameter gradient (one and
  two network elements) against the JAX ones on the same minibatch and
  parameters, 1e-10;
- whole OTF fits, two epochs, seed 13 (`manual_seed_flag 1`): the loss
  curves, `evaluate_bucket` and the error table, 1e-10;
- the port's OTF energies and forces against its cached mode's (linear)
  and precompute mode's (quadraticflag) on the same model, 1e-9;
- `dgrad_mode = auto` resolves as in the JAX package when the cached
  mode's cache and dB/dD pass their limits (`NEIGH_LIMIT`, `G_LIMIT`
  against `FITSNAP_TPU_NN_NEIGH_LIMIT`, `FITSNAP_TPU_NN_G_LIMIT`);
- `cached` under quadraticflag takes OTF with the JAX package's warning.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.models.mlp import PerElementMLP
from fitsnap_tpu_torch.solvers import network as tnet
from tests.test_torch_nn import (as_jax, as_torch, rel, seeded_params,
                                 ta_nn_settings, write_ta)
from tests.test_torch_nn_cached import init_patch
from tests.test_torch_nn_fit import fit_settings, run

TOL = 1e-12
FIT_TOL = 1e-10
CROSS_TOL = 1e-9
FORMS = {"linear": {}, "quadratic": {"quadraticflag": 1}}
WARNING = ("WARNING: dgrad_mode=cached is not available for this descriptor "
           "config (chem/quadratic/non-SNAP); falling back to otf")


def otf_settings(data, form):
    s = fit_settings(data)
    s["BISPECTRUM"].update(FORMS[form])
    s["PYTORCH"].update(dgrad_mode="otf", num_epochs=2)
    return s


def run_both(root, s, seed=53):
    """A fit of `s` through both packages from the same initial weights."""
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, seed)
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    assert out["port"].solver.otf and out["jax"].solver.otf
    assert not out["port"].solver.cached and not out["jax"].solver.cached
    out.update(root=root, settings=s)
    return out


@pytest.fixture(scope="module", params=list(FORMS))
def fits(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"otf_{request.param}")
    write_ta(root / "JSON", 41)
    out = run_both(root, otf_settings(root / "JSON", request.param))
    out["form"] = request.param
    return out


# ---------------------------------------------------------------------------
# checks shared with tests/test_torch_nn_otf_chem.py
# ---------------------------------------------------------------------------


def check_buckets(port, jsol):
    """The OTF buckets of both packages after a fit (the network index is
    zeroed unless multi_element_option is 2, in both)."""
    keys = set(jnet.NetworkSolver._BATCH_KEYS_OTF) - {"kshape"}
    assert set(tnet._BATCH_KEYS_OTF) == keys
    assert len(port.buckets) == len(jsol.buckets) >= 1
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert {k for k, v in pb.items() if torch.is_tensor(v)} == keys
        assert pb["shape"] == jb["shape"] == (
            jb["real"].shape[1], jb["kshape"].shape[-1])
        assert pb["groups"] == jb["groups"] and pb["files"] == jb["files"]
        np.testing.assert_array_equal(pb["test"], jb["test"])
        np.testing.assert_array_equal(pb["nat_host"], jb["nat"])
        for key in ("pos_hi", "pos_lo", "svec_hi", "svec_lo", "types",
                    "elem", "real", "nat"):
            np.testing.assert_array_equal(pb[key].numpy(),
                                          np.asarray(jb[key]), err_msg=key)
        for key in ("e_target", "f_target", "ew", "fw"):
            assert rel(pb[key], np.asarray(jb[key])) <= TOL, key
    assert rel(port.mean, np.asarray(jsol.mean)) <= TOL
    assert rel(port.std, np.asarray(jsol.std)) <= TOL


def batches(port, jsol, bi, idx, nelem=1, seed=0):
    """The same minibatch from both packages' OTF buckets, its atoms given
    seeded network indices ("elem") below `nelem`."""
    batch = port._gather(port.buckets[bi], idx)
    jb = {k: jnp.asarray(np.asarray(jsol.buckets[bi][k])[idx])
          for k in jnet.NetworkSolver._BATCH_KEYS_OTF}
    elem = np.random.default_rng(seed).integers(
        0, nelem, tuple(batch["elem"].shape))
    batch["elem"] = torch.tensor(elem, dtype=torch.int32)
    jb["elem"] = jnp.asarray(elem, jnp.int32)
    return batch, jb


def check_forward(port, jsol, seed):
    sizes = [int(port.mean.shape[0]), 8, 8, 1]
    params = seeded_params(sizes, 1, seed)
    for bi, jb in enumerate(jsol.buckets):
        idx = np.arange(len(jb["groups"]))[::-1].copy()
        batch, jbatch = batches(port, jsol, bi, idx)
        e, f = port._forward_batch_otf(PerElementMLP(as_torch(params)), batch)
        je, jf = jsol._forward_batch_otf(as_jax(params), jbatch)
        assert rel(e, np.asarray(je)) <= FIT_TOL
        assert rel(f, np.asarray(jf)) <= FIT_TOL


def check_loss_and_gradient(port, jsol, nelem, seed):
    """The loss and its gradient with respect to every MLP parameter; the
    port's through its step's autograd functions, the JAX one through
    autodiff in the positions."""
    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1], nelem, seed)
    for bi in range(len(jsol.buckets)):
        idx = np.arange(min(4, len(jsol.buckets[bi]["groups"])))
        batch, jbatch = batches(port, jsol, bi, idx, nelem, seed=bi)
        model = PerElementMLP(as_torch(params))
        loss = port._loss(model, batch, train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        jl, jg = jax.value_and_grad(jsol._loss)(as_jax(params), jbatch)
        assert rel(loss, float(jl)) <= FIT_TOL
        for g, r in zip(grads, jax.tree.leaves(jg)):
            assert rel(g, np.asarray(r)) <= FIT_TOL


def check_fit(fits):
    port, ref = fits["port"].solver, fits["jax"].solver
    hist, jhist = np.array(port.history), np.array(ref.history)
    assert hist.shape == jhist.shape == (2, 3)
    assert np.isfinite(hist).all()
    assert rel(hist, jhist) <= FIT_TOL
    for pb, jb in zip(port.buckets, ref.buckets):
        for x, y in zip(port.evaluate_bucket(pb), ref.evaluate_bucket(jb)):
            assert rel(x, y) <= FIT_TOL
    errs, jerrs = port.errors, ref.errors
    assert errs.index == list(jerrs.index)
    assert rel(errs.values, jerrs.to_numpy(float)) <= FIT_TOL


def check_other_mode(fits, mode, tmp_path):
    """The port in `mode` on the same configs with the OTF fit's model and
    standardization: the same energies and forces, config by config."""
    otf = fits["port"].solver
    s = dict(fits["settings"])
    s["PYTORCH"] = dict(s["PYTORCH"], dgrad_mode=mode, num_epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        other = run("port", s, tmp_path / mode).solver
    assert other.cached == (mode == "cached") and not other.otf
    other.model, other.mean, other.std = otf.model, otf.mean, otf.std

    def by_file(solver):
        out = {}
        for ds in solver.buckets:
            e, f = solver.evaluate_bucket(ds)
            for i, fn in enumerate(ds["files"]):
                out[fn] = (e[i], f[i, :int(ds["nat_host"][i])])
        return out

    a, b = by_file(otf), by_file(other)
    assert sorted(a) == sorted(b)
    for fn in a:
        assert rel(a[fn][0], b[fn][0]) <= CROSS_TOL
        assert rel(a[fn][1], b[fn][1]) <= CROSS_TOL


def prepare_both(s, root):
    """Both packages' prepare_dataset on the settings `s` in `root`."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        port = FitSnap(s, arglist=["--overwrite"], device="cpu")
        port.scrape_configs()
        port.process_configs()
        jfs = JaxFitSnap(s, arglist=["--overwrite"])
        jfs.scrape_configs()
        jfs.process_configs()
    finally:
        os.chdir(cwd)
    return port.solver, jfs.solver


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_otf_buckets_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    check_buckets(port, jsol)
    W = 14 + 105 * (fits["form"] == "quadratic")
    assert tuple(port.mean.shape) == (W,)


def test_forward_batch_otf_equals_jax(fits):
    check_forward(fits["port"].solver, fits["jax"].solver, 17)


@pytest.mark.parametrize("nelem", [1, 2])
def test_otf_loss_and_gradient_equal_jax(fits, nelem):
    check_loss_and_gradient(fits["port"].solver, fits["jax"].solver, nelem,
                            19)


def test_otf_fit_equals_jax(fits):
    """Loss curves, predictions and the error table of the two-epoch fits;
    the train loss of each package follows the other's."""
    check_fit(fits)


def test_otf_forces_equal_cached_or_precompute(fits, tmp_path):
    """Linear SNAP against the cached mode, quadraticflag against the
    precompute mode (K1-K3, K6q and K12 on host lists)."""
    mode = "cached" if fits["form"] == "linear" else "precompute"
    check_other_mode(fits, mode, tmp_path)


@pytest.mark.parametrize("form,neigh,g,mode", [
    ("linear", 0, None, "precompute"), ("linear", 0, 0, "otf"),
    ("quadratic", None, 0, "otf")])
def test_dgrad_auto_resolves_as_jax(tmp_path, capsys, monkeypatch, form,
                                    neigh, g, mode):
    """`auto` with the cached mode's cache over NEIGH_LIMIT and dB/dD over
    G_LIMIT (0 bytes; None keeps the default) in both packages: the same
    mode, said so, and in OTF the same buckets (twojmax 2, four cells)."""
    for name, limit, env in ((("NEIGH_LIMIT", neigh,
                               "FITSNAP_TPU_NN_NEIGH_LIMIT"),
                              ("G_LIMIT", g, "FITSNAP_TPU_NN_G_LIMIT"))):
        if limit is not None:
            monkeypatch.setattr(tnet, name, limit)
            monkeypatch.setenv(env, str(limit))
    write_ta(tmp_path / "JSON", 43)
    s = ta_nn_settings(tmp_path / "JSON")
    s["GROUPS"]["Super"] = "0.0 0.0 1.0 1.0 1e-4"     # the 2-atom cells
    s["BISPECTRUM"].update(FORMS[form], twojmax=2)
    s["PYTORCH"].update(dgrad_mode="auto", layer_sizes="num_desc 4 1")
    port, jsol = prepare_both(s, tmp_path)
    assert f"dgrad_mode=auto -> {mode}" in capsys.readouterr().out
    assert (port.otf, port.cached) == (jsol.otf, jsol.cached) \
        == (mode == "otf", False)
    if mode == "otf":
        check_buckets(port, jsol)


def test_cached_under_quadraticflag_takes_otf(tmp_path, capsys):
    """`cached` where its kit does not apply: both packages warn, with the
    same words, and prepare the same OTF buckets (twojmax 2)."""
    write_ta(tmp_path / "JSON", 47)
    s = ta_nn_settings(tmp_path / "JSON")
    s["GROUPS"]["Super"] = "0.0 0.0 1.0 1.0 1e-4"
    s["BISPECTRUM"].update(quadraticflag=1, twojmax=2)
    s["PYTORCH"].update(dgrad_mode="cached", layer_sizes="num_desc 4 1")
    port, jsol = prepare_both(s, tmp_path)
    assert capsys.readouterr().out.count(WARNING) == 2
    assert port.otf and jsol.otf and not port.cached
    check_buckets(port, jsol)
