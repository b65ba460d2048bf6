"""The NN solver's plan variables in fitsnap_tpu_torch against fitsnap_tpu
(CPU, float64; one case at float32).

The JAX package reads seven environment variables that change which
configs share a bucket and a minibatch and which mode `auto` takes; the
port reads each at the same place, with the same default and parse:

- FITSNAP_TPU_PROGRAM_COST (`plan_pos_buckets`' merge budget, 6.0),
- FITSNAP_TPU_NN_MAX_PROGRAMS (its cap on the cached and OTF buckets, 10),
- FITSNAP_TPU_NN_PROGRAMS (`coalesce_shape_buckets`' cap on the
  precompute, pairwise and PAS buckets, 4),
- FITSNAP_TPU_NN_NEIGH_LIMIT and FITSNAP_TPU_NN_G_LIMIT (`auto`'s limits
  on the cached mode's cache and on dB/dD, 4 GiB and 2 GiB),
- FITSNAP_TPU_NN_ATOMS_PER_BATCH (the minibatch grown to that many atom
  slots, then held to 390,000 pair slots; 0: off),
- FITSNAP_TPU_NN_PAIRS (the cached mode's pair slots a step, 390,000).

Each case sets one variable with `monkeypatch.setenv` to a value that
changes the plan of the small Ta set of `tests/test_torch_nn.py` (whose
seven configs share one bucket at the defaults) and runs both packages
from the same initial weights: the buckets' shapes and configs, the
minibatch shapes every step sees (recorded in `_loss`), and the resolved
mode equal; for FITSNAP_TPU_NN_ATOMS_PER_BATCH and FITSNAP_TPU_NN_PAIRS
the three-epoch fit's loss curve and trained parameters within 1e-10.
FITSNAP_TPU_NN_ATOMS_PER_BATCH runs in the cached, OTF and precompute
modes (each takes its pair slots from another bucket key in the JAX
package: `jidx`, `kshape`, `jidx`); the precompute case at batch_size 1,
since its host shapes keep at most four configs a bucket.  FITSNAP_TPU_NN_MAX_PROGRAMS runs at FITSNAP_TPU_PROGRAM_COST 0:
at the default budget the set merges into one bucket whatever the cap.
One more case sets FITSNAP_TPU_NN_NEIGH_LIMIT between the cached cache's
size at float32 and at float64: `auto` takes the cached mode at float32
(the JAX package's float32 run: `jax.default_backend` patched to "tpu")
and precompute at float64, in both packages.
"""

import os

import jax
import numpy as np
import pytest

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.parallel.fit import plan_pos_buckets
from fitsnap_tpu_torch.solvers import network as tnet
from tests.test_torch_nn import rel, write_ta
from tests.test_torch_nn_cached import init_patch
from tests.test_torch_nn_fit import fit_settings

TOL = 1e-10

# (variable, value, dgrad_mode, epochs, other settings and variables);
# each value changes the default plan of the Ta set
CASES = [
    pytest.param("PROGRAM_COST", "0", "cached", 1, {}, id="PROGRAM_COST"),
    pytest.param("NN_MAX_PROGRAMS", "1", "cached", 1, {"PROGRAM_COST": "0"},
                 id="NN_MAX_PROGRAMS"),
    pytest.param("NN_PROGRAMS", "1", "precompute", 1, {}, id="NN_PROGRAMS"),
    pytest.param("NN_NEIGH_LIMIT", "1", "auto", 1, {}, id="NN_NEIGH_LIMIT"),
    pytest.param("NN_G_LIMIT", "1", "auto", 1, {"quadraticflag": 1},
                 id="NN_G_LIMIT"),
    pytest.param("NN_ATOMS_PER_BATCH", "112", "cached", 3, {},
                 id="NN_ATOMS_PER_BATCH"),
    pytest.param("NN_ATOMS_PER_BATCH", "112", "otf", 3, {},
                 id="NN_ATOMS_PER_BATCH-otf"),
    pytest.param("NN_ATOMS_PER_BATCH", "112", "precompute", 3,
                 {"batch_size": 1}, id="NN_ATOMS_PER_BATCH-precompute"),
    pytest.param("NN_PAIRS", "1024", "cached", 3, {}, id="NN_PAIRS"),
]
# settings a case may change; the rest of `other` are variables
SETTINGS = {"quadraticflag": "BISPECTRUM", "batch_size": "PYTORCH"}
# how each value changes the plan of the Ta set, whose seven configs (four
# of 2 atoms, three of 16; six train, one validates) share one bucket of 16
# atoms at the defaults, in minibatches of at most `batch_size` (4); the
# precompute mode keeps the two host shapes apart, and `auto` takes the
# cached mode (linear) and precompute (quadraticflag)
EXPECT = {
    "PROGRAM_COST": lambda sol, shapes, bs: len(sol.buckets) > 1,
    "NN_MAX_PROGRAMS": lambda sol, shapes, bs: len(sol.buckets) == 1,
    "NN_PROGRAMS": lambda sol, shapes, bs: len(sol.buckets) == 1,
    "NN_NEIGH_LIMIT": lambda sol, shapes, bs: mode_of(sol) == "precompute",
    "NN_G_LIMIT": lambda sol, shapes, bs: mode_of(sol) == "otf",
    "NN_ATOMS_PER_BATCH":
        lambda sol, shapes, bs: max(n for n, _ in shapes) > bs,
    "NN_PAIRS": lambda sol, shapes, bs: {n for n, _ in shapes} <= {1, 2},
}


def record_shapes(mp, cls, shapes):
    """Record the (configs, atoms) shape of every minibatch `cls._loss`
    sees (the JAX package's at trace time, one a bucket and phase)."""
    loss = cls._loss

    def spy(self, params, batch, *a, **k):
        shapes.add(tuple(np.shape(batch["real"])))
        return loss(self, params, batch, *a, **k)

    mp.setattr(cls, "_loss", spy)


def run_both(root, s, fit=True):
    """Both packages' FitSnap on `s` in `root`, from the same initial
    weights, through the fit (or `process_configs` alone); returns
    ({package: FitSnap}, {package: minibatch shapes})."""
    out, shapes = {}, {}
    for name, cls, make in (
            ("port", tnet.NetworkSolver,
             lambda: FitSnap(s, arglist=["--overwrite"], device="cpu")),
            ("jax", jnet.NetworkSolver,
             lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
        (root / name).mkdir()
        cwd = os.getcwd()
        os.chdir(root / name)
        shapes[name] = set()
        try:
            with pytest.MonkeyPatch.context() as mp:
                init_patch(mp, 53)
                record_shapes(mp, cls, shapes[name])
                fs = make()
                fs.scrape_configs()
                fs.process_configs()
                if fit:
                    fs.perform_fit()
        finally:
            os.chdir(cwd)
        out[name] = fs
    return out, shapes


def mode_of(sol):
    return "cached" if sol.cached else "otf" if sol.otf else "precompute"


@pytest.mark.parametrize("var, value, mode, epochs, other", CASES)
def test_plan_variable_read_as_jax(tmp_path, monkeypatch, var, value, mode,
                                   epochs, other):
    write_ta(tmp_path / "JSON", 41)
    s = fit_settings(tmp_path / "JSON")
    s["PYTORCH"].update(dgrad_mode=mode, num_epochs=epochs,
                        save_state_output="None")
    for name, v in [(var, value)] + list(other.items()):
        if name in SETTINGS:
            s[SETTINGS[name]][name] = v
        else:
            monkeypatch.setenv("FITSNAP_TPU_" + name, v)
    fits, shapes = run_both(tmp_path, s)
    port, jsol = fits["port"].solver, fits["jax"].solver
    assert mode_of(port) == mode_of(jsol)
    assert [b["shape"] for b in port.buckets] == [b["shape"]
                                                  for b in jsol.buckets]
    assert [b["files"] for b in port.buckets] == [b["files"]
                                                  for b in jsol.buckets]
    assert shapes["port"] == shapes["jax"] and shapes["port"]
    assert EXPECT[var](port, shapes["port"], s["PYTORCH"]["batch_size"])
    if epochs > 1:
        assert rel(np.array(port.history), np.array(jsol.history)) <= TOL
        for x, y in zip(port.model.parameters(),
                        jax.tree.leaves(jsol.params)):
            assert rel(x, np.asarray(y)) <= TOL


def test_neigh_limit_between_float32_and_float64_caches(tmp_path,
                                                         monkeypatch):
    """The cached mode's cache of the Ta set at float32 (3 x 4 + 5 bytes a
    pair slot) fits a FITSNAP_TPU_NN_NEIGH_LIMIT that the float64 one (3 x
    8 + 5) passes: `auto` takes the cached mode at float32 and precompute
    at float64, in both packages."""
    write_ta(tmp_path / "JSON", 41)
    s = fit_settings(tmp_path / "JSON")
    s["PYTORCH"]["dgrad_mode"] = "auto"
    probe = FitSnap(s, arglist=["--overwrite"], device="cpu")
    packed = [probe.calculator._pack(d) for d in probe.scrape_configs()]
    groups = plan_pos_buckets(packed, probe.calculator.cutoff)

    def cache(itemsz):
        return sum(len(g["configs"]) * g["a_pad"]
                   * (min(g["k_pad"], g["a_pad"] * len(g["s_table"]))
                      * (3 * itemsz + 5) + 2600) for g in groups)

    assert cache(4) < cache(8)
    monkeypatch.setenv("FITSNAP_TPU_NN_NEIGH_LIMIT",
                       str((cache(4) + cache(8)) // 2))
    modes = {}
    for dtype in ("float32", "float64"):
        for name in ("port", "jax"):
            root = tmp_path / f"{name}_{dtype}"
            root.mkdir()
            monkeypatch.chdir(root)
            with pytest.MonkeyPatch.context() as mp:
                if name == "jax":
                    if dtype == "float32":
                        mp.setattr(jax, "default_backend", lambda: "tpu")
                    fs = JaxFitSnap(s, arglist=["--overwrite"])
                else:
                    fs = FitSnap(s, arglist=["--overwrite", "--dtype", dtype],
                                 device="cpu")
                fs.scrape_configs()
                fs.process_configs()
            modes[name, dtype] = mode_of(fs.solver)
    assert modes == {("port", "float32"): "cached",
                     ("jax", "float32"): "cached",
                     ("port", "float64"): "precompute",
                     ("jax", "float64"): "precompute"}
