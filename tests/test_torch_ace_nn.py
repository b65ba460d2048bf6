"""Nonlinear ACE (the NN solver on LAMMPSPACE descriptors, the reference's
Ta_PACE_PyTorch_NN) in fitsnap_tpu_torch against fitsnap_tpu (CPU,
float64), in the precompute and OTF modes.

The small Ta set of tests/test_torch_nn.py goes through both packages'
FitSnap with `synthetic.ace_nn_settings` cut to a small plan (ranks 1 2 3,
lmax 1 2 2, nmax 2 1 1, nmaxbase 2, as tests/test_pas.py's nonlinear ACE
case), layers `num_desc 8 8 1`, two epochs, from the same initial weights.
Precompute keeps B and dB/dD of every config (K13, K14) and takes the
forces through K12; OTF keeps the positions and forms each minibatch's
lists (K8, K8r), B and dB/dD (K13, K14) every step.  Checks, with their
tolerances (relative to the largest magnitude):

- the buckets: precompute's B, G, targets and standardization within
  1e-12; OTF's as tests/test_torch_nn_otf.py's `check_buckets`;
- the minibatch forward, and the loss with its gradient with respect to
  every MLP parameter (one and two network elements), 1e-10;
- two-epoch fits: the loss curves, `evaluate_bucket` and the error table,
  1e-10;
- the OTF forces against the precompute mode's on the same model, 1e-9;
- central-difference forces of the trained model through the port's ACE
  pipeline (host lists, K13, K14, the MLP) against its K12 forces, the
  JAX package's 1e-5 bar;
- `dgrad_mode = auto` and `cached` resolve as in the JAX package (cached:
  its warning, then OTF);
- the ACE calculator has no SNAP pair-grid kit, and the outputs: the `.pt`
  at the label width, the metrics, no potential (as the JAX package).
"""

import os

import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu_torch.calculators.ace import ace_batch
from fitsnap_tpu_torch.models.mlp import PerElementMLP
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import (GROUPS, as_jax, as_torch, rel,
                                 seeded_params, write_ta)
from tests.test_torch_nn_cached import init_patch
from tests.test_torch_nn_fit import run
from tests.test_torch_nn_otf import (CROSS_TOL, WARNING, check_buckets,
                                     check_fit, check_forward,
                                     check_loss_and_gradient, prepare_both)

TOL = 1e-12
FIT_TOL = 1e-10
SMALL_ACE = {"ranks": "1 2 3", "lmax": "1 2 2", "nmax": "2 1 1",
             "nmaxbase": 2, "lmin": 0}


def ace_nn_small(data, dgrad_mode):
    s = synthetic.ace_nn_settings(data, groups=[], dgrad_mode=dgrad_mode)
    s["GROUPS"].update(GROUPS)
    s["ACE"].update(SMALL_ACE)
    s["PYTORCH"].update(layer_sizes="num_desc 8 8 1", num_epochs=2,
                        learning_rate=1e-3)
    s["EXTRAS"] = {"dump_peratom": 1, "dump_perconfig": 1}
    return s


@pytest.fixture(scope="module", params=["precompute", "otf"])
def fits(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"ace_nn_{request.param}")
    write_ta(root / "JSON", 41)
    s = ace_nn_small(root / "JSON", request.param)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    otf = request.param == "otf"
    for fs in out.values():
        assert fs.solver.otf == otf and not fs.solver.cached
    out.update(root=root, settings=s, mode=request.param)
    return out


def test_ace_nn_buckets_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    W = len(fits["port"].calculator.plan.labels)
    assert tuple(port.mean.shape) == (W,) and W > 5
    assert port._snap is None
    if fits["mode"] == "otf":
        check_buckets(port, jsol)
        assert port._kit is None and port._dense is not None
        return
    assert len(port.buckets) == len(jsol.buckets)
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert pb["shape"] == jb["shape"] and pb["files"] == jb["files"]
        for key in ("B", "G", "e_target", "f_target"):
            assert rel(pb[key], np.asarray(jb[key])) <= TOL, key
        np.testing.assert_array_equal(pb["jidx"].numpy(), jb["jidx"])
    assert rel(port.mean, np.asarray(jsol.mean)) <= TOL
    assert rel(port.std, np.asarray(jsol.std)) <= TOL


def precompute_batches(port, jsol, bi, idx, nelem=1, seed=0):
    batch = port._gather(port.buckets[bi], idx)
    jb = {k: np.asarray(v)[idx] for k, v in jsol.buckets[bi].items()
          if k in jnet.NetworkSolver._BATCH_KEYS}
    elem = np.random.default_rng(seed).integers(
        0, nelem, tuple(batch["types"].shape))
    batch["types"] = torch.tensor(elem, dtype=torch.int32)
    jb["types"] = elem.astype(np.int32)
    return batch, jb


def test_ace_nn_forward_equals_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    if fits["mode"] == "otf":
        check_forward(port, jsol, 17)
        return
    import jax.numpy as jnp

    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1], 1, 17)
    for bi, jb in enumerate(jsol.buckets):
        idx = np.arange(len(jb["groups"]))[::-1].copy()
        batch, jbatch = precompute_batches(port, jsol, bi, idx)
        e, f = port._forward_batch(PerElementMLP(as_torch(params)), batch)
        je, jf = jsol._forward_batch(
            as_jax(params), {k: jnp.asarray(v) for k, v in jbatch.items()})
        assert rel(e, np.asarray(je)) <= FIT_TOL
        assert rel(f, np.asarray(jf)) <= FIT_TOL


@pytest.mark.parametrize("nelem", [1, 2])
def test_ace_nn_loss_and_gradient_equal_jax(fits, nelem):
    port, jsol = fits["port"].solver, fits["jax"].solver
    if fits["mode"] == "otf":
        check_loss_and_gradient(port, jsol, nelem, 19)
        return
    import jax
    import jax.numpy as jnp

    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1], nelem, 19)
    for bi in range(len(jsol.buckets)):
        idx = np.arange(min(4, len(jsol.buckets[bi]["groups"])))
        batch, jbatch = precompute_batches(port, jsol, bi, idx, nelem, bi)
        model = PerElementMLP(as_torch(params))
        loss = port._loss(model, batch, train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        jl, jg = jax.value_and_grad(jsol._loss)(
            as_jax(params), {k: jnp.asarray(v) for k, v in jbatch.items()})
        assert rel(loss, float(jl)) <= FIT_TOL
        for g, r in zip(grads, jax.tree.leaves(jg)):
            assert rel(g, np.asarray(r)) <= FIT_TOL


def test_ace_nn_fit_equals_jax(fits):
    """Loss curves, predictions and the error table of the two-epoch
    fits."""
    check_fit(fits)


def test_ace_nn_otf_forces_equal_precompute(fits, tmp_path):
    """The fit's model and standardization in the other mode (OTF for the
    precompute fit, precompute for the OTF fit) on the same configs: the
    same energies and forces, config by config."""
    fit = fits["port"].solver
    other_mode = "precompute" if fits["mode"] == "otf" else "otf"
    s = dict(fits["settings"])
    s["PYTORCH"] = dict(s["PYTORCH"], dgrad_mode=other_mode, num_epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        other = run("port", s, tmp_path / other_mode).solver
    assert other.otf == (other_mode == "otf")
    other.model, other.mean, other.std = fit.model, fit.mean, fit.std

    def by_file(solver):
        out = {}
        for ds in solver.buckets:
            e, f = solver.evaluate_bucket(ds)
            for i, fn in enumerate(ds["files"]):
                out[fn] = (e[i], f[i, :int(ds["nat_host"][i])])
        return out

    a, b = by_file(fit), by_file(other)
    assert sorted(a) == sorted(b)
    for fn in a:
        assert rel(a[fn][0], b[fn][0]) <= CROSS_TOL
        assert rel(a[fn][1], b[fn][1]) <= CROSS_TOL


def model_eval(fs, pos, cell, types):
    """Energy and K12 forces of one config through the port's ACE pipeline:
    host neighbor lists, K13 and K14, the MLP."""
    sol, calc = fs.solver, fs.calculator
    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, calc.cutoff)
    rev = reverse_neighbors(jidx, mask, n)
    t = lambda x: torch.as_tensor(x)[None]   # noqa: E731
    types = t(np.asarray(types, np.int32))
    B, G, _ = ace_batch(calc.plan, t(disp), t(jidx), t(mask), types,
                        torch.tensor([n]))
    batch = {"B": B, "G": G, "types": torch.zeros_like(types),
             "real": torch.ones(1, n, dtype=bool), "nat": torch.tensor([n]),
             "jidx": t(jidx), "rev": t(rev)}
    e, f = sol._forward_batch(sol.model, batch)
    return float(e[0]) * n, f[0].numpy()


def test_ace_nn_fd_forces(fits):
    fs = fits["port"]
    data = [d for d in fs.data if d["NumAtoms"] == 16][0]
    pos = np.asarray(data["Positions"], float)
    cell = np.asarray(data["Lattice"], float)
    types = [fs.calculator.type_mapping[t] - 1 for t in data["AtomTypes"]]
    _, f0 = model_eval(fs, pos, cell, types)
    h = 1e-5
    errs = []
    for a in (0, 5):
        for c in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[a, c] += h
            pm[a, c] -= h
            ep, _ = model_eval(fs, pp, cell, types)
            em, _ = model_eval(fs, pm, cell, types)
            errs.append(abs(-(ep - em) / (2 * h) - f0[a, c]))
    assert np.abs(f0).max() > 1e-3
    assert max(errs) < 1e-5, errs


@pytest.mark.parametrize("mode,g_limit,want", [
    ("auto", None, "precompute"), ("auto", 0, "otf"), ("cached", None, "otf")])
def test_ace_nn_modes_resolve_as_jax(tmp_path, capsys, monkeypatch, mode,
                                     g_limit, want):
    """`auto` takes precompute while dB/dD fits G_LIMIT, else OTF (the
    ACE calculator has no cached kit); `cached` warns and takes OTF; the
    same in both packages, with the same words."""
    if g_limit is not None:
        monkeypatch.setattr(tnet, "G_LIMIT", g_limit)
        monkeypatch.setenv("FITSNAP_TPU_NN_G_LIMIT", str(g_limit))
    write_ta(tmp_path / "JSON", 43)
    s = ace_nn_small(tmp_path / "JSON", mode)
    port, jsol = prepare_both(s, tmp_path)
    out = capsys.readouterr().out
    if mode == "auto":
        assert f"dgrad_mode=auto -> {want}" in out
    else:
        assert out.count(WARNING) == 2
    assert port.otf == jsol.otf == (want == "otf")
    assert not (port.cached or jsol.cached)
    if want == "otf":
        check_buckets(port, jsol)


def test_ace_calculator_has_no_snap_kit(fits):
    calc = fits["port"].calculator
    assert calc.nn_analytic() is None
    with pytest.raises(NotImplementedError, match="SNAP"):
        calc.nn_kit()
    packed, buckets = calc.host_preprocess(fits["port"].data[:3])
    _, args = next(iter(calc.batches(packed, buckets)))
    B, G, re, rf = calc.nn_prep(*args[:6])
    assert G.shape[:3] == B.shape and B.shape[2] == len(calc.plan.labels)
    desc = calc.nn_desc(args[0], args[1], args[2], args[4], args[5])
    assert torch.equal(desc, B)
    assert re.shape == args[5].shape and rf.shape == args[0].shape[:2] + (3,)


def test_ace_nn_outputs(fits):
    """Both packages write the `.pt`, the metrics and no potential file;
    the port's module reads the label-width descriptors."""
    root = fits["root"]
    for name in ("port", "jax"):
        files = set(os.listdir(root / name))
        assert {"Ta_ace_nn.pt", "Ta_ace_nn_metrics.md",
                "loss_vs_epochs.dat"} <= files, files
        assert not any(f.endswith((".acecoeff", ".yace")) for f in files)
    module = torch.load(root / "port" / "Ta_ace_nn.pt", weights_only=False)
    pb = fits["port"].solver.buckets[-1]
    nat = int(pb["nat_host"][0])
    W = int(fits["port"].solver.mean.shape[0])
    desc = np.random.default_rng(3).normal(size=(nat, W))
    beta, energy = np.zeros_like(desc), np.zeros(nat)
    module(np.zeros(nat, np.int32), desc, beta, energy)
    assert np.isfinite(energy).all() and np.abs(beta).max() > 0
