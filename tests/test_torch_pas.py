"""Per-atom-scalar (PAS) NN fitting in fitsnap_tpu_torch against fitsnap_tpu
(CPU, float64).

PAS (the reference's FitTorchPAS) fits one scalar per atom, the configs'
`Chis`, from the per-atom descriptors B alone: no energy contraction, no
forces, no reference potential.  Five descriptor forms go through both
packages' FitSnap (scrape -> process_configs -> perform_fit ->
write_output) from the same initial weights (`init_patch`), three epochs,
on eight in-test configs each with the seeded `Chis` of
`synthetic.with_chis` (the JAX package's PAS test's target):

- linear SNAP on Ta-shaped cells (four 2-atom, four 16-atom) at twojmax 4;
- the same with quadraticflag;
- chemflag on InP-shaped 8-atom cells at twojmax 4 (`inp_settings`:
  bnormflag, two elements), wselfallflag 0, one shared network
  (multi_element_option 1);
- the same with wselfallflag 1, quadraticflag and a network per element
  (multi_element_option 2);
- ACE with the small plan of tests/test_pas.py (ranks 1-3).

Checks, with their tolerances (relative to the largest magnitude):

- the buckets (B, targets, masks, weights) and the standardization, 1e-12;
- `_forward_pas` on a minibatch with seeded weights, 1e-12;
- the loss and its gradient with respect to every MLP parameter, 1e-10;
- the three-epoch loss curves, 1e-10; `evaluate_bucket`'s predictions,
  1e-10;
- the error table against the JAX package's DataFrame, number for number,
  1e-12 of the largest target; the written files' names;
- the `.pt` module's per-atom outputs on one config against the trained
  model (the JAX package's export tolerance, 1e-7);
- `per_atom_scalar` with energy 1 raises in both packages' Config;
- `python -m fitsnap_tpu_torch pas.in --device cpu` (chemflag) writes the
  `.pt`, metrics and loss files, and its loss curve is the library fit's
  (to the file's eight digits).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
import jax
import jax.numpy as jnp
from fitsnap_tpu.config import Config as JaxConfig
from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.models.mlp import PerElementMLP
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import as_jax, as_torch, rel, seeded_params
from tests.test_torch_nn_cached import init_patch
from tests.test_torch_nn_fit import ROOT, run

TOL = 1e-12
FIT_TOL = 1e-10
PT_TOL = 1e-7
SMALL_ACE = {"ranks": "1 2 3", "lmax": "1 2 2", "nmax": "2 1 1",
             "nmaxbase": 2, "lmin": 0, "bzeroflag": 1}
# form: (data set, descriptor flags, multi_element_option)
FORMS = {"linear": ("ta", {}, 1),
         "quadratic": ("ta", {"quadraticflag": 1}, 1),
         "chem": ("inp", {"wselfallflag": 0}, 1),
         "chem_quad": ("inp", {"wselfallflag": 1, "quadraticflag": 1}, 2),
         "ace": ("ace", SMALL_ACE, 1)}
GROUPS = {"Small": "0.75 0.25 2.0 1.0 1e-4", "Super": "1.0 0.0 0.5 1.0 1e-4"}


def ta_cells(seed):
    """Four 2-atom and four 16-atom jittered bcc cells."""
    rng = np.random.default_rng(seed)
    out = {}
    for group, reps in (("Small", (1, 1, 1)), ("Super", (2, 2, 2))):
        out[group] = []
        for _ in range(4):
            pos, cell = synthetic.supercell(
                synthetic.BCC, rng.uniform(3.15, 3.45), reps)
            out[group].append((pos + rng.normal(0.0, 0.1, pos.shape), cell))
    return out


def inp_cells(seed):
    """Eight jittered 8-atom zincblende In/P cells; the "Super" group's
    with one or two antisites, so the mix of elements varies."""
    rng = np.random.default_rng(seed)
    out = {}
    for group in ("Small", "Super"):
        out[group] = []
        for i in range(4):
            pos, cell = synthetic.supercell(
                synthetic.ZINCBLENDE, synthetic.INP_A * rng.uniform(0.95, 1.05),
                (1, 1, 1))
            names = np.array(["In"] * 4 + ["P"] * 4)
            if group == "Super":
                flip = rng.choice(8, 1 + i % 2, replace=False)
                names[flip] = np.where(names[flip] == "In", "P", "In")
            out[group].append((pos + rng.normal(0.0, 0.1, pos.shape), cell,
                               names.tolist()))
    return out


def pas_form_settings(data, form):
    kind, flags, meo = FORMS[form]
    base = {"ta": synthetic.ta_settings, "inp": synthetic.inp_settings,
            "ace": synthetic.ace_settings}[kind]
    s = synthetic.pas_settings(data, base, groups=[])
    s["GROUPS"].update(GROUPS)
    sec = "ACE" if kind == "ace" else "BISPECTRUM"
    s[sec].update(flags)
    if kind != "ace":
        s[sec]["twojmax"] = "4 4" if kind == "inp" else 4
    s["PYTORCH"].update(layer_sizes="num_desc 8 8 1", num_epochs=3,
                        learning_rate=1e-3, multi_element_option=meo,
                        save_state_output="state.pkl")
    return s


@pytest.fixture(scope="module", params=list(FORMS))
def fits(request, tmp_path_factory):
    form = request.param
    root = tmp_path_factory.mktemp(f"pas_{form}")
    cells = inp_cells(67) if FORMS[form][0] == "inp" else ta_cells(61)
    synthetic.write_dataset(root / "JSON", synthetic.with_chis(cells, 7))
    s = pas_form_settings(root / "JSON", form)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    assert out["port"].solver.pas and out["jax"].solver.pas
    out.update(root=root, form=form,
               nelem=2 if FORMS[form][2] == 2 else 1)
    return out


def jax_batch(jsol, bi, idx):
    return {k: jnp.asarray(np.asarray(jsol.buckets[bi][k])[idx])
            for k in jnet.NetworkSolver._BATCH_KEYS_PAS}


def test_pas_buckets_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    keys = set(jnet.NetworkSolver._BATCH_KEYS_PAS)
    assert set(tnet._BATCH_KEYS_PAS) == keys
    assert len(port.buckets) == len(jsol.buckets) >= 1
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert {k for k, v in pb.items() if torch.is_tensor(v)} == keys
        assert pb["shape"] == jb["shape"]
        assert pb["groups"] == jb["groups"] and pb["files"] == jb["files"]
        np.testing.assert_array_equal(pb["test"], jb["test"])
        np.testing.assert_array_equal(pb["nat_host"], jb["nat_host"])
        for key in ("types", "real", "nat"):
            np.testing.assert_array_equal(pb[key].numpy(),
                                          np.asarray(jb[key]), err_msg=key)
        for key in ("B", "pas_target", "ew"):
            assert rel(pb[key], np.asarray(jb[key])) <= TOL, key
    assert rel(port.mean, np.asarray(jsol.mean)) <= TOL
    assert rel(port.std, np.asarray(jsol.std)) <= TOL


def test_forward_pas_equals_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1],
                           fits["nelem"], 17)
    for bi, pb in enumerate(port.buckets):
        idx = np.arange(len(pb["groups"]))[::-1].copy()
        out = port._forward_pas(PerElementMLP(as_torch(params)),
                                port._gather(pb, idx))
        ref = jsol._forward_pas(as_jax(params), jax_batch(jsol, bi, idx))
        assert rel(out, np.asarray(ref)) <= TOL


def test_pas_loss_and_gradient_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1],
                           fits["nelem"], 19)
    for bi, pb in enumerate(port.buckets):
        idx = np.arange(min(4, len(pb["groups"])))
        model = PerElementMLP(as_torch(params))
        loss = port._loss(model, port._gather(pb, idx), train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        jl, jg = jax.value_and_grad(jsol._loss)(as_jax(params),
                                                jax_batch(jsol, bi, idx))
        assert rel(loss, float(jl)) <= FIT_TOL
        for g, r in zip(grads, jax.tree.leaves(jg)):
            assert rel(g, np.asarray(r)) <= FIT_TOL


def test_pas_loss_curves_equal_jax(fits):
    port = np.array(fits["port"].solver.history)
    ref = np.array(fits["jax"].solver.history)
    assert port.shape == ref.shape == (3, 3)
    assert (port[:, 0] == ref[:, 0]).all()
    assert np.isfinite(port).all()
    assert rel(port[:, 1:], ref[:, 1:]) <= FIT_TOL
    assert port[-1, 1] < port[0, 1]


def test_pas_evaluate_bucket_equals_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    for pb, jb in zip(port.buckets, jsol.buckets):
        pred, f = port.evaluate_bucket(pb)
        ref, jf = jsol.evaluate_bucket(jb)
        assert f is None and jf is None
        assert pred.shape == tuple(pb["pas_target"].shape)
        assert rel(pred, ref) <= FIT_TOL


def test_pas_error_table_equals_jax(fits):
    port, ref = fits["port"].solver.errors, fits["jax"].solver.errors
    assert port.index_names == tuple(ref.index.names) == ("Group", "Testing")
    assert port.columns == tuple(ref.columns) == ("ncount", "mae", "rmse")
    assert port.index == list(ref.index)
    assert ("*ALL", "Testing") in port.index
    want = ref.to_numpy(float)
    assert (port.values[:, 0] == want[:, 0]).all()
    top = max(float(b["pas_target"].abs().max())
              for b in fits["port"].solver.buckets)
    assert np.abs(port.values - want).max() <= TOL * top


def test_pas_written_files(fits):
    """Both packages write the same files (the `.pt`, the metrics, the loss
    curve, the saved state; SNAP also the ML-IAP descriptor and `.mod`);
    PAS makes no per-config or per-atom dumps."""
    names = {d: sorted(p.name for p in (fits["root"] / d).iterdir())
             for d in ("port", "jax")}
    assert names["port"] == names["jax"]
    prefix = {"ace": "Ta_ace_pas", "chem": "InP_pas",
              "chem_quad": "InP_pas"}.get(fits["form"], "Ta_pas")
    assert {f"{prefix}.pt", f"{prefix}_metrics.md", "loss_vs_epochs.dat",
            "state.pkl"} <= set(names["port"])
    text = (fits["root"] / "port" / f"{prefix}_metrics.md").read_text()
    assert text.startswith("| Group | Testing | ncount | mae | rmse |")


def test_pas_exported_module_equals_model(fits):
    sol = fits["port"].solver
    prefix = {"ace": "Ta_ace_pas", "chem": "InP_pas",
              "chem_quad": "InP_pas"}.get(fits["form"], "Ta_pas")
    module = torch.load(fits["root"] / "port" / f"{prefix}.pt",
                        weights_only=False)
    pb = sol.buckets[-1]
    nat = int(pb["nat_host"][0])
    desc = pb["B"][0, :nat].numpy().copy()
    elems = pb["types"][0, :nat].numpy().astype(np.int32)
    beta, scal = np.zeros_like(desc), np.zeros(nat)
    module(elems, desc, beta, scal)
    pred, _ = sol.evaluate_bucket(pb)
    assert rel(scal, pred[0, :nat]) <= PT_TOL


def test_pas_with_energy_raises(tmp_path):
    s = synthetic.pas_settings(tmp_path)
    s["CALCULATOR"]["energy"] = 1
    for config in (Config, JaxConfig):
        with pytest.raises(ValueError, match="per_atom_scalar"):
            config(s, arglist=["--overwrite"])


def test_cli_pas_fit_on_cpu(tmp_path):
    """The chemflag form through the CLI and through the library, each
    from its own seed-13 initial weights: the same files and the same loss
    curve."""
    synthetic.write_dataset(tmp_path / "JSON",
                            synthetic.with_chis(inp_cells(67), 7))
    s = pas_form_settings(tmp_path / "JSON", "chem")
    synthetic.write_ini(tmp_path / "pas.in", s)
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "pas.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for name in ("InP_pas.pt", "InP_pas_metrics.md", "loss_vs_epochs.dat",
                 "InP_pas_pot.mliap.descriptor", "InP_pas_pot.mod"):
        assert (tmp_path / name).stat().st_size > 0, name
    lib = run("port", s, tmp_path / "lib")
    curve = np.loadtxt(tmp_path / "loss_vs_epochs.dat")
    assert curve.shape == (3, 3)
    assert rel(curve, np.array(lib.solver.history)) <= 1e-8
