"""The custom pairwise NN (calculator LAMMPSCUSTOM, a [CUSTOM] section)
through fitsnap_tpu_torch.FitSnap against fitsnap_tpu.FitSnap (CPU,
float64).

The Ta set of `tests/test_torch_nn.py` (7 bcc configs of 2 and 16 atoms in
two groups, one with a test fraction) with `synthetic.custom_settings` (31
pair descriptors at cutoff 5.0), a network of widths 31 8 8 1, batch size
4, three epochs at learning rate 1e-3, `dgrad_mode = otf` (which the
pairwise mode ignores, as the JAX package does) and a saved state, goes
through both facades: scrape -> process_configs -> perform_fit ->
write_output.  Both packages start from the same parameters: each
package's `init_mlp` is replaced by one that returns the same seeded numpy
weights (output layer zero), so the pairs-per-atom `e_mean` bias shift
runs on both sides.  Checks:

- the JAX `_forward_pairwise` energies and forces on every bucket against
  the port's on the same parameters, 1e-12;
- the per-epoch losses within 1e-10, `evaluate_bucket` and the error
  table within 1e-10, the written metrics;
- the port's `.pt` (`PairNNWrapper`) against the JAX `export_pairnn` on
  the same parameters (per-atom energies and dE/drij, 1e-12), and against
  the port's own forward (energy 1e-7 relative, dE/drij 1e-7: the
  standardization is folded into layer 1, as the JAX package's test
  holds it);
- a warm start of the port from the JAX package's saved state, against
  the JAX package resuming from it, two epochs, 1e-10;
- multi_element_option 2 (a network per element, subnet by atom i's
  element) on five In/P cells: the losses and predictions within 1e-10;
- under the default SNAP output style both packages raise the same
  KeyError after writing the `.pt` (the ML-IAP writer reads a BISPECTRUM
  section the pairwise model lacks);
- `python -m fitsnap_tpu_torch custom.in --overwrite --device cpu`
  writes the metrics, loss curve and `.pt`; the default device raises
  without a card.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.io.export_torch import export_pairnn as jax_export_pairnn
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.convert import mlp_params_from_numpy
from fitsnap_tpu_torch.models.mlp import PerElementMLP, params_to_numpy
from fitsnap_tpu_torch.ops.neighbors import host_neighbors
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import GROUPS, rel, seeded_params, write_ta

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-10


def fit_settings(data):
    s = synthetic.custom_settings(data, groups=[])
    s["GROUPS"].update(GROUPS)
    s["PYTORCH"].update(layer_sizes="num_desc 8 8 1", num_epochs=3,
                        learning_rate=1e-3, dgrad_mode="otf",
                        save_state_output="state.pkl")
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
        fs.write_output()
    finally:
        os.chdir(cwd)
    return fs


def same_init(mp, seed):
    def init(sizes, nelem, *_, **__):
        return seeded_params(sizes, nelem, seed, last_zero=True)

    mp.setattr(jnet, "init_mlp", lambda *a, **k: [
        (jnp.asarray(w), jnp.asarray(b)) for w, b in init(*a)])
    mp.setattr(tnet, "init_mlp",
               lambda *a, **k: mlp_params_from_numpy(init(*a)))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("custom_fit")
    write_ta(root / "JSON", 41)
    s = fit_settings(root / "JSON")
    with pytest.MonkeyPatch.context() as mp:
        same_init(mp, 53)
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    out.update(root=root, settings=s)
    return out


def jax_batch(bucket):
    keys = ("disp", "mask", "types", "real", "nat", "jidx")
    return {k: jnp.asarray(np.asarray(bucket[k])) for k in keys}


def test_forward_pairwise_equals_jax(fits):
    """Energies and forces of every config under the JAX package's trained
    parameters, through both packages' `_forward_pairwise`."""
    port, jax_ = fits["port"].solver, fits["jax"].solver
    params = [(np.array(w), np.array(b)) for w, b in jax_.params]
    model = PerElementMLP(mlp_params_from_numpy(params))
    assert len(port.buckets) == len(jax_.buckets) == 2
    for pb, jb in zip(port.buckets, jax_.buckets):
        n = len(pb["groups"])
        e, f = port._forward_pairwise(model, port._gather(pb, np.arange(n)))
        je, jf = jax_._forward_pairwise(jax_.params, jax_batch(jb))
        assert rel(e, je) <= 1e-12
        assert rel(f, jf) <= 1e-12
        assert np.abs(np.asarray(jf)).max() > 1e-3


def test_loss_trajectory_equals_jax(fits):
    port = np.array(fits["port"].solver.history)
    ref = np.array(fits["jax"].solver.history)
    assert port.shape == ref.shape == (3, 3)
    assert np.isfinite(port).all()
    assert rel(port, ref) <= TOL
    assert port[-1, 1] < port[0, 1]


def test_evaluate_and_error_table_equal_jax(fits):
    port, jax_ = fits["port"].solver, fits["jax"].solver
    for pb, jb in zip(port.buckets, jax_.buckets):
        for x, y in zip(port.evaluate_bucket(pb), jax_.evaluate_bucket(jb)):
            assert rel(x, y) <= TOL
    errs, ref = port.errors, jax_.errors
    assert errs.index == list(ref.index)
    assert rel(errs.values, ref.to_numpy(float)) <= TOL
    for name in ("Ta_custom_metrics.md", "loss_vs_epochs.dat", "state.pkl",
                 "Ta_custom.pt"):
        assert (fits["root"] / "port" / name).stat().st_size > 0


def one_config(fs):
    d = [x for x in fs.data if x["NumAtoms"] == 16][0]
    n = d["NumAtoms"]
    types = np.array([fs.calculator.type_mapping[t] - 1
                      for t in d["AtomTypes"]], np.int32)
    disp, jidx, mask, _ = host_neighbors(
        np.asarray(d["Positions"], float), np.asarray(d["Lattice"], float),
        n, fs.calculator.cutoff)
    return n, types, disp, jidx, mask


def call_pt(module, n, types, disp, jidx, mask):
    ii, _ = np.nonzero(mask)
    rij = np.ascontiguousarray(disp[mask], np.float64)
    beta, energy = np.zeros_like(rij), np.zeros(n)
    module.forward(types, None, beta, energy, rij, ii.astype(np.int64),
                   jidx[mask].astype(np.int64), ii.astype(np.int64),
                   jidx[mask].astype(np.int64))
    return energy, beta


def test_exported_pt_equals_jax_export(fits, tmp_path):
    """The port's `.pt` against the JAX `export_pairnn` of the port's
    trained parameters and standardization, and against the port's own
    forward on one 16-atom config."""
    port = fits["port"]
    sol = port.solver
    pt = torch.load(fits["root"] / "port" / "Ta_custom.pt",
                    weights_only=False)
    sec = sol._custom
    ref = jax_export_pairnn(
        str(tmp_path / "jax.pt"), params_to_numpy(sol.model.params),
        sol.mean.numpy(), sol.std.numpy(), sec.cutoff, sec.num_radial,
        sec.num_3body, 1)
    n, types, disp, jidx, mask = one_config(port)
    e, beta = call_pt(pt, n, types, disp, jidx, mask)
    je, jbeta = call_pt(ref, n, types, disp, jidx, mask)
    assert rel(e, je) <= 1e-12 and rel(beta, jbeta) <= 1e-12
    assert pt.n_descriptors == 31

    t = lambda x: torch.as_tensor(x)[None]   # noqa: E731
    batch = {"disp": t(disp), "mask": t(mask), "jidx": t(jidx),
             "types": torch.zeros(1, n, dtype=torch.int32),
             "nat": torch.tensor([n]), "rev": t(np.full((n, 1), -1, np.int32))}
    e_model, _ = sol._forward_pairwise(sol.model, batch)
    assert abs(e.sum() - float(e_model[0]) * n) \
        <= 1e-7 * max(1.0, abs(e.sum()))
    d = t(disp).requires_grad_(True)
    desc, fc = tnet.pair_desc(d, batch["mask"], sec.cutoff, sec.num_radial,
                              sec.num_3body)
    x = ((desc - sol.mean) / sol.std).reshape(-1, 31)
    etot = (sol.model(x, torch.zeros(x.shape[0], dtype=torch.int32))
            .reshape(fc.shape) * fc).sum()
    g, = torch.autograd.grad(etot, d)
    assert np.abs(beta - g[0].numpy()[mask]).max() < 1e-7


def test_warm_start_from_jax_state(fits, tmp_path):
    """The port and the JAX package resume from the JAX package's saved
    state (parameters, standardization, Adam moments): two epochs each,
    the curves within 1e-10."""
    curves = {}
    for name in ("port", "jax"):
        s = fit_settings(fits["settings"]["PATH"]["dataPath"])
        s["PYTORCH"].update(num_epochs=2, save_state_output="None",
                            save_state_input=str(fits["root"] / "jax"
                                                 / "state.pkl"))
        fs = run(name, s, tmp_path / name)
        curves[name] = np.array(fs.solver.history)[:, 1:]
    assert rel(curves["port"], curves["jax"]) <= TOL


def test_multi_element_fit_equals_jax(tmp_path, monkeypatch):
    """multi_element_option 2 on five In/P cells of 8 atoms: two epochs'
    losses and predictions within 1e-10."""
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
    s = synthetic.custom_settings(tmp_path / "JSON", groups=list(counts),
                                  multi_element=True)
    s["PYTORCH"].update(layer_sizes="num_desc 6 1", batch_size=2,
                        num_epochs=2, learning_rate=1e-3)
    same_init(monkeypatch, 61)
    port, ref = (run(name, s, tmp_path / name) for name in ("port", "jax"))
    assert port.solver.model.params[0][0].shape[:1] == (2,)
    assert rel(np.array(port.solver.history),
               np.array(ref.solver.history)) <= TOL
    for pb, jb in zip(port.solver.buckets, ref.solver.buckets):
        assert set(pb["types"].unique().tolist()) == {0, 1}
        for x, y in zip(port.solver.evaluate_bucket(pb),
                        ref.solver.evaluate_bucket(jb)):
            assert rel(x, y) <= TOL


def test_snap_output_style_raises_as_jax(fits, tmp_path):
    """Under output_style SNAP (the default) the ML-IAP writer reads the
    BISPECTRUM section, which a pairwise input lacks: both packages raise
    KeyError there, after the solver wrote the `.pt`."""
    s = fit_settings(fits["settings"]["PATH"]["dataPath"])
    del s["OUTFILE"]["output_style"]
    s["PYTORCH"].update(num_epochs=1, save_state_output="None")
    for name in ("port", "jax"):
        with pytest.raises(KeyError, match="BISPECTRUM"):
            run(name, s, tmp_path / name)
        assert (tmp_path / name / "Ta_custom.pt").exists()


def test_cli_on_cpu_and_default_device(fits, tmp_path, monkeypatch):
    s = fit_settings(fits["settings"]["PATH"]["dataPath"])
    s["PYTORCH"].update(num_epochs=1, save_state_output="None")
    synthetic.write_ini(tmp_path / "custom.in", s)
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "custom.in",
         "--overwrite", "--device", "cpu"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for name in ("Ta_custom.pt", "Ta_custom_metrics.md",
                 "loss_vs_epochs.dat"):
        assert (tmp_path / name).stat().st_size > 0
    assert "| *ALL |" in (tmp_path / "Ta_custom_metrics.md").read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FitSnap(str(tmp_path / "custom.in"), arglist=["--overwrite"])
