"""Data-parallel NN training of fitsnap_tpu_torch over a torch.distributed
group against fitsnap_tpu's `--devices` (CPU, float64).

The JAX side runs in this process on the 8-device virtual mesh of
`tests/conftest.py`; the port's ranks are processes started with `spawn`
that join a gloo group (`tests/torch_dist_worker.py`, one world of 2 and
one of 3 processes for the whole module) and import no JAX.  The Ta set of
`tests/test_torch_nn.py` (7 configs in three shape buckets, twojmax 4, an
MLP of widths 8 8 1, batch size 4, a test fraction in one group) trains 3
epochs in the precompute and the cached mode from the same parameters in
both packages (each `init_mlp` returns the same seeded numpy weights).  At
2 and 3 devices the plans wrap: buckets with fewer training or validation
configs than the minibatch repeat them (np.resize), as in the JAX package.
Checks:

- the per-epoch train and validation losses within 1e-10 relative, and
  the best parameters within 1e-10 relative to their largest magnitude,
  against `--devices 2` and `--devices 3` of the JAX package;
- every rank ends with the same loss curve and parameters, bit for bit,
  and only rank 0 writes files;
- batch_size below the device count raises in both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import GROUPS, rel, seeded_params, write_ta
from tests.torch_dist_worker import World

TOL = 1e-10
SIZES = [14, 8, 8, 1]


def settings(data, mode):
    s = synthetic.nn_settings(str(data), groups=[], dgrad_mode=mode)
    s["GROUPS"].update(GROUPS)
    s["BISPECTRUM"]["twojmax"] = 4
    s["PYTORCH"].update(layer_sizes="num_desc 8 8 1", num_epochs=3,
                        learning_rate=1e-3)
    return s


def jax_fit(s, init, devices, root):
    root.mkdir(parents=True)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnet, "init_mlp", lambda *a, **k: [
                (jnp.asarray(w), jnp.asarray(b)) for w, b in init])
            fs = JaxFitSnap(s, arglist=["--overwrite", "--devices",
                                        str(devices)])
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
    finally:
        os.chdir(cwd)
    return fs.solver


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("nn_dp")
    write_ta(root / "JSON", 41)
    worlds = {n: World(n, root / f"world{n}") for n in (2, 3)}
    yield {"root": root, "worlds": worlds,
           "init": seeded_params(SIZES, 1, 53, last_zero=True)}
    for w in worlds.values():
        w.close()


@pytest.fixture(scope="module", params=[("precompute", 2), ("cached", 2),
                                        ("precompute", 3), ("cached", 3)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def fits(request, env):
    mode, n = request.param
    s = settings(env["root"] / "JSON", mode)
    run = env["root"] / f"{mode}{n}"
    ref = jax_fit(s, env["init"], n, run / "jax")
    port = env["worlds"][n].run("nn_fit", settings=s, init=env["init"],
                                root=str(run / "port"), devices=n)
    return ref, port


def test_loss_curve_equals_jax(fits):
    ref, port = fits
    want = np.array(ref.history)
    got = port[0]["history"]
    assert got.shape == want.shape == (3, 3)
    assert (got[:, 0] == want[:, 0]).all()
    assert (np.abs(got[:, 1:] - want[:, 1:]) / np.abs(want[:, 1:])).max() \
        <= TOL


def test_parameters_equal_jax(fits):
    ref, port = fits
    for (w, b), (jw, jb) in zip(port[0]["params"], ref.params):
        assert rel(w, np.asarray(jw)) <= TOL
        assert rel(b, np.asarray(jb)) <= TOL


def test_ranks_agree_and_rank_0_writes(fits):
    _, port = fits
    for other in port[1:]:
        assert np.array_equal(other["history"], port[0]["history"])
        for (w, b), (w0, b0) in zip(other["params"], port[0]["params"]):
            assert np.array_equal(w, w0) and np.array_equal(b, b0)
        assert other["files"] == []
    assert "loss_vs_epochs.dat" in port[0]["files"]
    assert "Ta_nn_metrics.md" in port[0]["files"]


def test_batch_size_below_devices_refused(env, tmp_path):
    s = settings(env["root"] / "JSON", "precompute")
    msg, = set(env["worlds"][3].run("nn_refused", settings=s, batch_size=2))
    assert msg is not None and "batch_size=2 < devices=3" in msg
    s["PYTORCH"]["batch_size"] = 2
    with pytest.raises(ValueError, match="batch_size=2 < devices=3"):
        jax_fit(s, env["init"], 3, tmp_path / "jax")
