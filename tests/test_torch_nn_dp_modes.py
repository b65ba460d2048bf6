"""Data-parallel NN training of fitsnap_tpu_torch in the OTF mode, the
custom pairwise NN, per-atom-scalar fitting (PAS) and nonlinear ACE over a
torch.distributed group, against fitsnap_tpu's `--devices 2` and against
the port's own single process (CPU, float64).

The JAX side runs in this process on the 8-device virtual mesh of
`tests/conftest.py`; the port's ranks are processes started with `spawn`
that join a gloo group (`tests/torch_dist_worker.py`, one world of 2 for
the module) and import no JAX.  Each mode trains 3 epochs on a small
seeded Ta set (three 2-atom and three 16-atom bcc cells, a test fraction
in one group):

- at batch size 3 over 2 devices in both packages, from JAX's initial
  parameters carried across (the JAX `init_mlp` draws seeded numpy weights
  and records them): the plan rounds the minibatch down to 2, and the one
  validation config of a bucket wraps (np.resize) to a minibatch of two.
  The per-epoch train and validation losses within 1e-10 relative, and
  the best parameters within 1e-10 relative to their largest magnitude;
- at batch size 2, once in this process without a group and once over the
  2 ranks, from the port's own seeded parameters (the plans are the same:
  a minibatch of 2 configs, 1 a rank): the same limits; every rank ends
  with the same curve and parameters, bit for bit, and only rank 0 writes
  files.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import seeded_params
from tests.torch_dist_worker import World, nn_fit

TOL = 1e-10
GROUPS = {"Small": "0.75 0.25 1.0 1.0 1e-4", "Super": "1.0 0.0 1.0 1.0 1e-4"}
MODES = ["otf", "custom", "pas", "ace"]


def write_set(root):
    """The Ta cells with seeded energies and forces as JSON, and again
    with per-atom `Chis` for PAS."""
    rng = np.random.default_rng(43)
    for group, reps in (("Small", (1, 1, 1)), ("Super", (2, 2, 2))):
        for folder in ("JSON", "PAS"):
            (root / folder / group).mkdir(parents=True)
        for i in range(3):
            pos, cell = synthetic.supercell(synthetic.BCC,
                                            rng.uniform(3.15, 3.45), reps)
            pos = pos + rng.normal(0.0, 0.1, pos.shape)
            n = len(pos)
            truths = dict(energy=rng.normal(-10.0 * n, 1.0),
                          forces=rng.normal(0.0, 0.5, (n, 3)))
            chis = 2.0 + 0.3 * np.sin(pos.sum(1)) + rng.normal(0, 0.05, n)
            name = f"{group}/{group}_{i}.json"
            (root / "JSON" / name).write_text(synthetic.config_json(
                pos, cell, **truths))
            (root / "PAS" / name).write_text(synthetic.config_json(
                pos, cell, **truths, extra={"Chis": chis.tolist()}))


def settings(root, mode, batch_size=2):
    if mode == "otf":
        s = synthetic.nn_settings(root / "JSON", groups=[], dgrad_mode="otf")
        s["BISPECTRUM"]["twojmax"] = 4
    elif mode == "custom":
        s = synthetic.custom_settings(root / "JSON", groups=[])
    elif mode == "pas":
        s = synthetic.pas_settings(root / "PAS", groups=[])
        s["BISPECTRUM"]["twojmax"] = 4
    else:
        s = synthetic.ace_nn_settings(root / "JSON", groups=[])
    s["GROUPS"].update(GROUPS)
    s["PYTORCH"].update(layer_sizes="num_desc 8 8 1", num_epochs=3,
                        learning_rate=1e-3, batch_size=batch_size)
    return s


def jax_fit(s, devices, root):
    """The JAX package's fit of `s` on `devices` devices in `root`, from
    seeded initial parameters; returns its solver and those parameters."""
    drawn = []

    def init(sizes, nelem, *_, **__):
        drawn.append(seeded_params(sizes, nelem, 53, last_zero=True))
        return [(jnp.asarray(w), jnp.asarray(b)) for w, b in drawn[-1]]

    root.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnet, "init_mlp", init)
            fs = JaxFitSnap(s, arglist=["--overwrite", "--devices",
                                        str(devices)])
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
    finally:
        os.chdir(cwd)
    assert len(drawn) == 1
    return fs.solver, drawn[0]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("nn_dp_modes")
    write_set(root)
    world = World(2, root / "world")
    yield {"root": root, "world": world}
    world.close()


@pytest.fixture(scope="module", params=MODES)
def fits(request, env):
    s = settings(env["root"], request.param)
    run = env["root"] / request.param
    one = nn_fit(s, str(run / "one"))
    ranks = env["world"].run("nn_fit", settings=s, root=str(run / "two"),
                             devices=2)
    return one, ranks


@pytest.fixture(scope="module", params=MODES)
def against_jax(request, env):
    s = settings(env["root"], request.param, batch_size=3)
    run = env["root"] / f"{request.param}_jax"
    ref, init = jax_fit(s, 2, run / "jax")
    ranks = env["world"].run("nn_fit", settings=s, init=init,
                             root=str(run / "port"), devices=2)
    return ref, ranks


def rel_max(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def test_loss_curve_equals_jax(against_jax):
    ref, ranks = against_jax
    want = np.array(ref.history)
    got = ranks[0]["history"]
    assert got.shape == want.shape == (3, 3)
    assert (got[:, 0] == want[:, 0]).all()
    assert (np.abs(got[:, 1:] - want[:, 1:]) / np.abs(want[:, 1:])).max() \
        <= TOL
    assert np.array_equal(ranks[1]["history"], got)


def test_parameters_equal_jax(against_jax):
    ref, ranks = against_jax
    for (w, b), (jw, jb) in zip(ranks[0]["params"], ref.params):
        assert rel_max(w, np.asarray(jw)) <= TOL
        assert rel_max(b, np.asarray(jb)) <= TOL


def test_loss_curve_equals_one_process(fits):
    one, ranks = fits
    want, got = one["history"], ranks[0]["history"]
    assert got.shape == want.shape == (3, 3)
    assert np.isfinite(got).all()
    assert (np.abs(got[:, 1:] - want[:, 1:]) / np.abs(want[:, 1:])).max() \
        <= TOL


def test_parameters_equal_one_process(fits):
    one, ranks = fits
    for (w, b), (w1, b1) in zip(ranks[0]["params"], one["params"]):
        assert np.abs(w - w1).max() <= TOL * np.abs(w1).max()
        assert np.abs(b - b1).max() <= TOL * np.abs(b1).max()


def test_ranks_agree_and_rank_0_writes(fits):
    one, ranks = fits
    assert ranks[1]["files"] == []
    assert ranks[0]["files"] == one["files"] and "loss_vs_epochs.dat" in \
        one["files"]
    assert np.array_equal(ranks[1]["history"], ranks[0]["history"])
    for (w, b), (w0, b0) in zip(ranks[1]["params"], ranks[0]["params"]):
        assert np.array_equal(w, w0) and np.array_equal(b, b0)
