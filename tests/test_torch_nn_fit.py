"""A whole NN fit (precompute mode) through fitsnap_tpu_torch.FitSnap
against fitsnap_tpu.FitSnap (CPU, float64).

The Ta set of `tests/test_torch_nn.py` (7 configs in three shape buckets,
twojmax 4, an MLP of widths 8 8 1, batch size 4, a test fraction in one
group) goes through both facades: scrape -> process_configs -> perform_fit
-> write_output, three epochs at learning rate 1e-3, with per-config and
per-atom dumps and a saved state.  Both packages start from the same
parameters: each package's `init_mlp` is replaced by one that returns the
same seeded numpy weights (output layer zero), so the `e_mean` bias shift
runs on both sides.  Checks:

- the per-epoch train and validation losses within 1e-10 relative;
- `evaluate_bucket`'s energies and forces, and the NN error table (Group,
  Testing x ncount/mae/rmse of E and F), within 1e-10;
- the written files: `.mliap.descriptor` and `.mod` equal the JAX writer's
  apart from the package name, with one run hash; the loss curve, the
  per-config / per-atom dumps and the saved state's numbers within 1e-10;
  both `.pt` modules give the same per-atom energies and betas;
- a warm start from one pickle: the JAX package resumes from the port's
  saved state and the port from the JAX package's, two epochs each, and
  their loss curves agree within 1e-10; a state of other layer shapes is
  refused;
- finite-difference forces of the trained port model (central
  differences, h = 1e-5, neighbor lists and descriptors recomputed at each
  displaced position) against its K12 forces, mean error < 1e-5 and max
  < 1e-4, as `tests/test_nn.py`;
- multi_element_option 2 (a network per element) on InP-shaped cells
  with chemflag: two epochs' losses and predictions within 1e-10;
- `dgrad_mode = auto` resolves to precompute where the cached mode's kit
  does not apply (quadraticflag) and says so;
- `python -m fitsnap_tpu_torch nn.in --overwrite --device cpu` writes the
  `.pt`, `.mliap.descriptor`, `.mod` and metrics files.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.calculators.snap import pair_masks
from fitsnap_tpu_torch.convert import mlp_params_from_numpy
from fitsnap_tpu_torch.ops.neighbors import host_neighbors, reverse_neighbors
from fitsnap_tpu_torch.ops.snap import descriptors_with_jacobian
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import rel, seeded_params, ta_nn_settings, write_ta

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-10


def fit_settings(data):
    s = ta_nn_settings(data)
    s["PYTORCH"].update(num_epochs=3, learning_rate=1e-3,
                        save_state_output="state.pkl")
    s["EXTRAS"] = {"dump_peratom": 1, "dump_perconfig": 1}
    return s


def run(name, s, root):
    """One fit through the package `name` ("port" or "jax") in `root`."""
    root.mkdir()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        fs = (FitSnap(s, arglist=["--overwrite"], device="cpu")
              if name == "port" else JaxFitSnap(s, arglist=["--overwrite"]))
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
        fs.config.hash = "0" * 32
        fs.write_output()
    finally:
        os.chdir(cwd)
    return fs


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("nn_fit")
    write_ta(root / "JSON", 41)
    s = fit_settings(root / "JSON")
    sizes = [14, 8, 8, 1]
    init = seeded_params(sizes, 1, 53, last_zero=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnet, "init_mlp", lambda *a, **k: [
            (jnp.asarray(w), jnp.asarray(b)) for w, b in init])
        mp.setattr(tnet, "init_mlp",
                   lambda *a, **k: mlp_params_from_numpy(init))
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    out.update(root=root, settings=s)
    return out


def test_loss_trajectory_equals_jax(fits):
    port = np.array(fits["port"].solver.history)
    ref = np.array(fits["jax"].solver.history)
    assert port.shape == ref.shape == (3, 3)
    assert (port[:, 0] == ref[:, 0]).all()
    assert np.isfinite(port).all()
    assert (np.abs(port[:, 1:] - ref[:, 1:]) / np.abs(ref[:, 1:])).max() <= TOL
    assert port[-1, 1] < port[0, 1]


def test_evaluate_bucket_equals_jax(fits):
    port, jax_ = fits["port"].solver, fits["jax"].solver
    assert len(port.buckets) == len(jax_.buckets)
    for pb, jb in zip(port.buckets, jax_.buckets):
        e, f = port.evaluate_bucket(pb)
        je, jf = jax_.evaluate_bucket(jb)
        assert rel(e, je) <= TOL
        assert rel(f, jf) <= TOL


def test_error_table_equals_jax(fits):
    port, ref = fits["port"].solver.errors, fits["jax"].solver.errors
    assert port.index_names == tuple(ref.index.names)
    assert port.columns == tuple(ref.columns)
    assert port.index == list(ref.index)
    want = ref.to_numpy(float)
    assert (port.values[:, [0, 3]] == want[:, [0, 3]]).all()
    assert rel(port.values, want) <= TOL
    text = (fits["root"] / "port" / "Ta_nn_metrics.md").read_text()
    assert text.startswith("| Group | Testing | ncount_E | mae_E |")


@pytest.mark.parametrize("suffix", [".mliap.descriptor", ".mod"])
def test_written_lammps_files_equal_jax(fits, suffix):
    port = (fits["root"] / "port" / ("Ta_nn_pot" + suffix)).read_text()
    ref = (fits["root"] / "jax" / ("Ta_nn_pot" + suffix)).read_text()
    assert port.replace("fitsnap_tpu_torch", "fitsnap_tpu") == ref


@pytest.mark.parametrize("name", ["loss_vs_epochs.dat", "perconfig.dat",
                                  "peratom.dat"])
def test_written_numbers_equal_jax(fits, name):
    def table(path):
        """(the words, the numbers) of a whitespace table."""
        words, nums = [], []
        for tok in path.read_text().split():
            try:
                nums.append(float(tok))
            except ValueError:
                words.append(tok)
        return words, np.array(nums)

    pw, port = table(fits["root"] / "port" / name)
    jw, ref = table(fits["root"] / "jax" / name)
    assert pw == jw
    assert port.size > 0
    assert rel(port, ref) <= TOL


def test_saved_state_equals_jax(fits):
    def load(name):
        with open(fits["root"] / name / "state.pkl", "rb") as f:
            return pickle.load(f)

    port, ref = load("port"), load("jax")
    assert sorted(port["meta"]) == sorted(ref["meta"])
    for (w, b), (jw, jb) in zip(port["params"], ref["params"]):
        assert rel(w, jw) <= TOL and rel(b, jb) <= TOL
    for k in ("mean", "std"):
        assert rel(port["meta"][k], ref["meta"][k]) <= 1e-12
    leaves, jleaves = port["meta"]["opt_state"], ref["meta"]["opt_state"]
    assert [np.shape(x) for x in leaves] == [np.shape(x) for x in jleaves]
    assert int(leaves[0]) == int(jleaves[0])
    for x, y in zip(leaves[1:], jleaves[1:]):
        assert rel(x, y) <= TOL


def test_exported_modules_agree(fits):
    port = torch.load(fits["root"] / "port" / "Ta_nn.pt", weights_only=False)
    ref = torch.load(fits["root"] / "jax" / "Ta_nn.pt", weights_only=False)
    pb = fits["port"].solver.buckets[-1]
    nat = int(pb["nat_host"][0])
    desc = pb["B"][0, :nat].numpy().copy()
    elems = np.zeros(nat, np.int32)
    out = {}
    for name, model in (("port", port), ("jax", ref)):
        beta, energy = np.zeros_like(desc), np.zeros(nat)
        model(elems, desc, beta, energy)
        out[name] = (beta, energy)
    assert rel(out["port"][1], out["jax"][1]) <= TOL
    assert rel(out["port"][0], out["jax"][0]) <= TOL
    e, _ = fits["port"].solver.evaluate_bucket(pb)
    assert abs(out["port"][1].sum() / nat - e[0]) <= 1e-12 * abs(e[0])


def test_warm_start_from_one_pickle(fits, tmp_path):
    """The JAX package resumes from the port's state and the port from the
    JAX package's: both pickles hold (nearly) the same state, so the two
    resumed curves agree."""
    curves = {}
    for name, other in (("port", "jax"), ("jax", "port")):
        s = fit_settings(fits["settings"]["PATH"]["dataPath"])
        s["PYTORCH"].update(num_epochs=2, save_state_output="None",
                            save_state_input=str(fits["root"] / other
                                                 / "state.pkl"))
        fs = run(name, s, tmp_path / name)
        curves[name] = np.array(fs.solver.history)[:, 1:]
    assert rel(curves["port"], curves["jax"]) <= TOL

    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"params": [(np.zeros((1, 2, 2)), np.zeros((1, 2)))],
                     "meta": {}}, f)
    s = fit_settings(fits["settings"]["PATH"]["dataPath"])
    s["PYTORCH"].update(num_epochs=1, save_state_input=str(bad))
    with pytest.raises(ValueError, match="layer shapes"):
        run("port", s, tmp_path / "bad")


def test_multi_element_fit_equals_jax(tmp_path, monkeypatch):
    """multi_element_option 2 (a subnetwork per element) on five InP-shaped
    cells (chemflag, twojmax 2): the loss curves and predictions of two
    epochs within 1e-10."""
    rng = np.random.default_rng(59)
    counts = {"Volume_ZB": 2, "Strain_ZB": 3}
    for group, confs in synthetic.inp_configs(7, counts).items():
        (tmp_path / "JSON" / group).mkdir(parents=True)
        for i, (pos, cell, names) in enumerate(confs):
            n = len(pos)
            pos = pos + rng.normal(0.0, 0.08, pos.shape)
            (tmp_path / "JSON" / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(pos, cell, energy=-3.4 * n,
                                      forces=rng.normal(0, 0.3, (n, 3)),
                                      types=names))
    s = synthetic.inp_settings(tmp_path / "JSON", groups=list(counts))
    s["BISPECTRUM"]["twojmax"] = "2 2"
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = {"layer_sizes": "num_desc 6 1", "batch_size": 2,
                    "num_epochs": 2, "learning_rate": 1e-3,
                    "multi_element_option": 2, "manual_seed_flag": 1,
                    "energy_weight": 1e-2, "force_weight": 1.0,
                    "dgrad_mode": "precompute"}
    def init(sizes, nelem, *_, **__):
        return seeded_params(sizes, nelem, 61, last_zero=True)

    monkeypatch.setattr(jnet, "init_mlp", lambda *a, **k: [
        (jnp.asarray(w), jnp.asarray(b)) for w, b in init(*a)])
    monkeypatch.setattr(tnet, "init_mlp",
                        lambda *a, **k: mlp_params_from_numpy(init(*a)))
    port, ref = (run(name, s, tmp_path / name) for name in ("port", "jax"))
    assert port.solver.model.params[0][0].shape[:1] == (2,)
    assert rel(np.array(port.solver.history),
               np.array(ref.solver.history)) <= TOL
    for pb, jb in zip(port.solver.buckets, ref.solver.buckets):
        for x, y in zip(port.solver.evaluate_bucket(pb),
                        ref.solver.evaluate_bucket(jb)):
            assert rel(x, y) <= TOL


def model_eval(solver, calc, pos, cell, types):
    """Energy and K12 forces of one config through the port's pipeline:
    host neighbor lists, descriptors and their jacobian, the MLP."""
    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, calc.cutoff)
    rev = reverse_neighbors(jidx, mask, n)
    t = lambda x: torch.as_tensor(x)[None]   # noqa: E731
    types = t(np.asarray(types, np.int32))
    disp, jidx, mask = t(disp), t(jidx), t(mask)
    jelem, smask = pair_masks(calc.params, disp, jidx, mask, types)
    K = mask.shape[2]
    B, G = descriptors_with_jacobian(disp[0], jelem[0], smask[0], types[0],
                                     calc.params)
    batch = {"B": B[None], "G": G.reshape(1, n, -1, K, 3),
             "types": torch.zeros_like(types), "real": torch.ones(1, n, dtype=bool),
             "nat": torch.tensor([n]), "jidx": jidx, "rev": t(rev)}
    e, f = solver._forward_batch(solver.model, batch)
    return float(e[0]) * n, f[0].numpy()


def test_fd_forces(fits):
    fs = fits["port"]
    data = [d for d in fs.data if d["NumAtoms"] == 16][0]
    pos = np.asarray(data["Positions"], float)
    cell = np.asarray(data["Lattice"], float)
    types = [fs.calculator.type_mapping[t] - 1 for t in data["AtomTypes"]]
    _, f0 = model_eval(fs.solver, fs.calculator, pos, cell, types)
    h = 1e-5
    errs = []
    for a in (0, 3, 11):
        for c in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[a, c] += h
            pm[a, c] -= h
            ep, _ = model_eval(fs.solver, fs.calculator, pp, cell, types)
            em, _ = model_eval(fs.solver, fs.calculator, pm, cell, types)
            errs.append(abs(-(ep - em) / (2 * h) - f0[a, c]))
    errs = np.array(errs)
    assert np.abs(f0).max() > 1e-3
    assert errs.mean() < 1e-5 and errs.max() < 1e-4, errs


def test_dgrad_auto_resolves_to_precompute(fits, capsys):
    """`auto` resolves to precompute where the cached mode's kit does not
    apply (here quadraticflag; `tests/test_torch_nn_cached.py` holds every
    resolution to the JAX package's) and says so; the buckets are the
    precompute fit's."""
    fs = fits["port"]
    s = dict(fits["settings"])
    s["BISPECTRUM"] = dict(s["BISPECTRUM"], quadraticflag=1)
    s["PYTORCH"] = dict(s["PYTORCH"], dgrad_mode="auto")
    quad = FitSnap(s, arglist=["--overwrite"], device="cpu")
    assert quad.calculator.nn_analytic() is None
    quad.solver.prepare_dataset(quad.calculator, fs.data)
    assert "dgrad_mode=auto -> precompute" in capsys.readouterr().out
    assert not quad.solver.cached
    assert len(quad.solver.buckets) == len(fs.solver.buckets)


def test_cli_nn_fit_on_cpu(fits, tmp_path):
    s = fits["settings"]
    synthetic.write_ini(tmp_path / "nn.in", dict(s, EXTRAS={}))
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "nn.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for name in ("Ta_nn.pt", "Ta_nn_pot.mliap.descriptor", "Ta_nn_pot.mod",
                 "Ta_nn_metrics.md", "loss_vs_epochs.dat", "state.pkl"):
        assert (tmp_path / name).stat().st_size > 0, name
