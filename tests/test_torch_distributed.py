"""fitsnap_tpu_torch over a torch.distributed group against fitsnap_tpu's
sharded functions (CPU, float64).

The JAX side runs in this process on the 8-device virtual mesh of
`tests/conftest.py`; the port's ranks are processes started with `spawn`
that join a gloo group (`tests/torch_dist_worker.py`, one world of 2 and
one of 3 processes for the whole module) and import no JAX.  Checks, with
their tolerances (relative to the largest magnitude):

- the streamed fit of `tests/test_torch_parallel_fit.py`'s six Ta cells
  (at twojmax 4 here), packed into 2 chunks of 4 configs, the per_chunk axis split
  over 2 ranks as JAX's `P(None, "dp")` over `make_mesh(2)`:
  `build_step_fn` with positions (direct, and accumulating two batches
  into one accumulator, held to twice JAX's step) and with host lists, `build_residual_fn` and
  `build_eval_fn`, 1e-12, nrows exact; `fit_refined` 1e-10; the same
  against the port without a group, 1e-12 and 1e-10;
- `build_spatial_rows_fn`, one 16-atom bcc config padded to 24 atom slots
  (padded atoms in the last blocks, the last block of 3 and of 4 all
  padding) split over 2 and over 3 ranks, SNAP (twojmax 4) and
  Ta_PACE-shaped ACE with its constant column: AtA and Atb against JAX's
  at 2 and 4 devices and against the port without a group, 1e-12, nrows
  exact;
- `TpuSVD` at 2 and 3 ranks (193 training rows of 242: padded at 2 and
  3) against JAX's over its 8 devices and against the port without a
  group, 1e-10;
- `torchrun --nproc_per_node 2 -m fitsnap_tpu_torch in.in --device cpu`
  (TPUSVD on the six cells) writes the potential, the stage timings appear
  once on the screen, and the `.snapcoeff` equals the one-process fit's
  (`FitSnap` in this process) within 1e-10;
- a first scrape under 2 ranks in one directory: the VASP scraper's vJSON
  cache and the XYZ scraper's frame-offset file (`save_group_scrape`,
  with unseeded `random_sampling`) are written by rank 0 alone, whole,
  before rank 1 reads them; both ranks get the same dicts (strings and
  ints equal, float arrays `np.array_equal`), and for VASP the same as
  one process's first scrape, with the same cache files;
- `--devices 2` without a group raises with the torchrun command line, and
  `make_group` without a group is (0, 1, device) and initializes nothing.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.parallel import fit as jfit
from fitsnap_tpu.solvers.tpu_svd import TpuSVD as JaxTpuSVD
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.ops.neighbors import host_neighbors
from fitsnap_tpu_torch.tools import synthetic
from fitsnap_tpu_torch.utils.torchsetup import make_group
from tests.test_torch_nn_fit import ROOT
from tests.test_torch_parallel_fit import (rel, stream_settings,
                                           write_stream_configs)
from tests.test_torch_scrapers import (XYZ_GROUPS, assert_same_dicts,
                                       write_vasp, write_xyz)
from tests.test_torch_scrapers import settings as scrape_settings
from tests.torch_dist_worker import (World, scrape, spatial_rows,
                                     stream_batches, stream_results, tpu_svd)

RTOL = 1e-12
FLAGS = {"energy": True, "force": True, "stress": True}
N_PAD, CHUNKS = 8, 2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("distributed")
    (root / "JSON").mkdir()
    write_stream_configs(root / "JSON")
    worlds = {n: World(n, root / f"world{n}") for n in (2, 3)}
    yield {"root": root, "worlds": worlds,
           "stream": small(stream_settings(root / "JSON"))}
    for w in worlds.values():
        w.close()


def small(s):
    """Settings at twojmax 4 (15 columns): JAX compiles them quickly."""
    s["BISPECTRUM"]["twojmax"] = 4
    return s


def inside(path, fn):
    path.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# the streamed fit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stream(env):
    s = env["stream"]
    jfs = inside(env["root"] / "jax", lambda: JaxFitSnap(
        s, arglist=["--overwrite"]))
    jfs.scrape_configs()
    jcalc = jfs.calculator
    _, pos, lists, nb = stream_batches(s, N_PAD, CHUNKS)
    jargs = (jcalc.params, 1, FLAGS, jfit.make_mesh(2))
    kw = dict(refspec=jcalc.refspec)
    jstep = jfit.build_step_fn(*jargs, neighbors=nb, **kw)
    jres = jfit.build_residual_fn(*jargs, neighbors=nb, **kw)
    jfit_x, _, jn = jfit.fit_refined(jstep, jres, pos)
    x = np.asarray(jfit_x)
    AtA, Atb, nrows = jstep(pos)
    # the batch added twice into one accumulator: twice the step, exactly
    ref = {"step": (AtA, Atb, nrows), "acc": (2 * AtA, 2 * Atb, 2 * nrows),
           "lists": jfit.build_step_fn(*jargs, **kw)(lists),
           "res": np.asarray(jres(jnp.asarray(x), pos)),
           "eval": [float(v) for v in jfit.build_eval_fn(
               *jargs, neighbors=nb, **kw)(jnp.asarray(x), pos)],
           "fit": (x, jn)}
    port = env["worlds"][2].run("stream_results", settings=s, n_pad=N_PAD,
                                chunks=CHUNKS, x=x, flags=FLAGS)
    return {"jax": ref, "ranks": port,
            "one": stream_results(s, N_PAD, CHUNKS, x, FLAGS)}


@pytest.mark.parametrize("which", ["step", "acc", "lists"])
@pytest.mark.parametrize("against", ["jax", "one"])
def test_step_fn_over_two_ranks(stream, which, against):
    want = stream[against][which]
    for AtA, Atb, nrows in (r[which] for r in stream["ranks"]):
        assert rel(AtA, np.asarray(want[0])) <= RTOL
        assert rel(Atb, np.asarray(want[1])) <= RTOL
        assert nrows == float(np.asarray(want[2]))
    reps = 2 if which == "acc" else 1
    assert nrows == reps * (3 * (1 + 6 + 6) + 3 * (1 + 48 + 6))


@pytest.mark.parametrize("against", ["jax", "one"])
def test_residual_and_eval_over_two_ranks(stream, against):
    want = stream[against]
    scale = np.abs(np.asarray(stream["jax"]["step"][1])).max()
    for r in stream["ranks"]:
        assert np.abs(r["res"] - want["res"]).max() / scale <= RTOL
        se, ne, sf, nf = r["eval"]
        jse, jne, jsf, jnf = want["eval"]
        assert (ne, nf) == (jne, jnf) == (6.0, 3 * (3 * 2 + 3 * 16))
        assert abs(se - jse) <= RTOL * jse and abs(sf - jsf) <= RTOL * jsf


@pytest.mark.parametrize("against", ["jax", "one"])
def test_fit_refined_over_two_ranks(stream, against):
    x, n = stream[against]["fit"]
    for r in stream["ranks"]:
        assert rel(r["fit"][0], x) <= 1e-10
        assert r["fit"][1] == float(n)


# ---------------------------------------------------------------------------
# the spatial rows
# ---------------------------------------------------------------------------


def spatial_config(cutoff, seed, a_pad=24):
    """A jittered 16-atom bcc cell padded to `a_pad` atom slots, with
    seeded truths and weights, as the JAX test's arguments."""
    rng = np.random.default_rng(seed)
    pos, cell = synthetic.supercell(synthetic.BCC, 3.3, (2, 2, 2))
    pos = pos + rng.normal(0.0, 0.1, pos.shape)
    n = len(pos)
    disp, jidx, mask, _ = host_neighbors(pos, cell, n, cutoff, a_pad=a_pad)
    forces = np.concatenate([rng.normal(size=(n, 3)),
                             np.zeros((a_pad - n, 3))])
    return (disp, jidx, mask, np.zeros(a_pad, np.int32), n, cell,
            np.float64(rng.normal()), forces, rng.normal(size=6), 2.5, 1.3,
            0.7)


@pytest.fixture(scope="module", params=["snap", "ace"])
def spatial(request, env):
    kind = request.param
    s = (small(synthetic.ta_settings(str(env["root"] / "JSON")))
         if kind == "snap" else synthetic.ace_settings(str(env["root"]
                                                           / "JSON")))
    jcalc = inside(env["root"] / "jax", lambda: JaxFitSnap(
        s, arglist=["--overwrite"])).calculator
    arrays = spatial_config(jcalc.cutoff, 3)
    if kind == "snap":
        args, kw = (jcalc.params, 1, FLAGS), {}
    else:
        args = (None, jcalc.numtypes, FLAGS)
        kw = dict(kernel=jfit.ace_kernel(jcalc.plan),
                  const_mode=("ace", jcalc.numtypes))
    jax_rows = {n: jfit.build_spatial_rows_fn(
        *args[:3], jfit.make_mesh(n), **kw)(*map(jnp.asarray, arrays))
        for n in (2, 4)}
    ranks = {n: env["worlds"][n].run("spatial_rows", settings=s, kind=kind,
                                     arrays=arrays, flags=FLAGS)
             for n in (2, 3)}
    return {"jax": jax_rows, "one": spatial_rows(s, kind, arrays, FLAGS),
            "ranks": ranks, "natoms": arrays[4]}


def check_spatial(spatial, n, against):
    want = (spatial["one"] if against == "one"
            else spatial["jax"][int(against[-1])])
    for AtA, Atb, nrows in spatial["ranks"][n]:
        assert rel(AtA, np.asarray(want[0])) <= RTOL
        assert rel(Atb, np.asarray(want[1])) <= RTOL
        assert nrows == float(np.asarray(want[2])) \
            == 1 + 3 * spatial["natoms"] + 6


@pytest.mark.parametrize("against", ["jax2", "jax4", "one"])
def test_spatial_rows_over_two_ranks(spatial, against):
    check_spatial(spatial, 2, against)


@pytest.mark.parametrize("against", ["jax2", "jax4", "one"])
def test_spatial_rows_over_three_ranks(spatial, against):
    check_spatial(spatial, 3, against)


# ---------------------------------------------------------------------------
# TpuSVD
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(12)
    a = rng.normal(size=(242, 31)) * rng.uniform(0.1, 10.0, 31)
    b = a @ rng.normal(size=31) + rng.normal(0.0, 0.1, 242)
    w = rng.uniform(0.5, 2.0, 242)
    fs_dict = {"Testing": list(rng.uniform(size=242) < 0.2)}
    return a, b, w, fs_dict


@pytest.mark.parametrize("n", [2, 3])
def test_tpu_svd_over_ranks(env, system, n):
    ref = JaxTpuSVD("TPUSVD", None).perform_fit(*system)
    one = tpu_svd(*system)
    a, b, w, fs_dict = system
    assert (len(a) - sum(fs_dict["Testing"])) % n != 0   # rows are padded
    for x in env["worlds"][n].run("tpu_svd", a=a, b=b, w=w,
                                  fs_dict=fs_dict):
        assert rel(x, ref) <= 1e-10
        assert rel(x, one) <= 1e-10


# ---------------------------------------------------------------------------
# scraping
# ---------------------------------------------------------------------------


def test_first_vasp_scrape_under_two_ranks(env):
    root = env["root"] / "scrape_vasp"
    write_vasp(root / "VASP", 5)
    s = scrape_settings(root / "VASP", "VASP", ["Bulk", "Strained"],
                        extra={"GROUPS": {"vasp_ignore_incomplete": 1}})
    ranks = env["worlds"][2].run("scrape", settings=s, root=str(root / "two"))
    one = scrape(s, str(root / "one"))
    assert len(one["files"]) == 5 + 4 + 3
    for r in ranks:
        assert r["files"] == one["files"]
        assert_same_dicts(r["data"], one["data"])


def test_xyz_offsets_and_sampling_under_two_ranks(env):
    root = env["root"] / "scrape_xyz"
    write_xyz(root / "XYZ", 4)
    s = scrape_settings(root / "XYZ", "XYZ", XYZ_GROUPS, random_sampling=1,
                        extra={"SCRAPER": {"save_group_scrape": "offs.txt"}})
    s["GROUPS"]["random_seed"] = 0          # unseeded: rank 0's draw
    ranks = env["worlds"][2].run("scrape", settings=s, root=str(root / "two"))
    one = scrape(s, str(root / "one"))
    assert_same_dicts(ranks[1]["data"], ranks[0]["data"])
    assert sorted(d["File"] for d in ranks[0]["data"]) \
        == sorted(d["File"] for d in one["data"])
    offsets = (root / "two" / "offs.txt").read_text()
    assert offsets == (root / "one" / "offs.txt").read_text()
    assert len(offsets.splitlines()) == len(XYZ_GROUPS)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def coefficients(path):
    return np.array([float(line.split()[0])
                     for line in path.read_text().splitlines()
                     if "#" in line and not line.startswith("#")])


def test_cli_under_two_ranks(env):
    s = dict(env["stream"], SOLVER={"solver": "TPUSVD"})
    one = env["root"] / "cli_one"
    fs = inside(one, lambda: FitSnap(s, arglist=["--overwrite"],
                                     device="cpu"))
    inside(one, lambda: (fs.scrape_configs(), fs.process_configs(),
                         fs.perform_fit(), fs.write_output()))
    two = env["root"] / "cli_two"
    two.mkdir()
    synthetic.write_ini(two / "in.in", s)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "fitsnap_tpu_torch", "in.in",
         "--overwrite", "--device", "cpu"], cwd=two,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(re.findall(r"^\s+fit: ", proc.stdout, re.M)) == 1, \
        proc.stdout
    assert (two / "Ta_metrics.md").exists()
    want = coefficients(one / "Ta_pot.snapcoeff")
    assert want.size == 15
    assert rel(coefficients(two / "Ta_pot.snapcoeff"), want) <= 1e-10


def test_devices_without_group_raise(env):
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2 "
                                         r"-m fitsnap_tpu_torch"):
        FitSnap(env["stream"], arglist=["--devices", "2"], device="cpu")
    fs = FitSnap(env["stream"], arglist=["--devices", "1"], device="cpu")
    assert fs.group == (0, 1, fs.device)


def test_make_group_initializes_nothing():
    assert make_group("cpu", init=True) == (0, 1, make_group("cpu").device)
    assert not dist.is_initialized()
