"""The NN solver's float32 cached and OTF modes of linear SNAP networks in
fitsnap_tpu_torch (`--dtype float32`) against fitsnap_tpu at float32
(CPU).

The JAX package trains every network at float32 on its accelerator
(`jax.default_backend() == "tpu"`); its float32 run here comes from
patching `jax.default_backend` to return "tpu" inside the test, nothing of
the JAX package edited, with the seeded initial parameters following
`init_mlp`'s `dtype` (both packages round the same float64 draws once).
The small Ta set of `tests/test_torch_nn.py` (twojmax 4, layers `num_desc 8
8 1`, three epochs).  Checks, each relative to the largest magnitude:

- the plain twins of K9, K10, K10T, K11, K11T and the force gather at
  float32 (the plan's float32 copy, `SnapParams.cast`) against the JAX kit
  at float32 (`nn_ut_b`; `nn_vg` after `nn_dEdu`; `jax.vjp` of those;
  `nn_pair_force` on `nn_grid_pair`; `jax.vjp` of it with the one-hot force
  scatter; the one-hot scatter) and against the port's float64 twins, on
  the seeded blocks of `tests/test_torch_snap.py`'s CASES and at twojmax 8
  (`tests/test_torch_nn_cached.py`'s block): 1e-4;
- the cached and OTF buckets (disp, ut, B; positions and image shifts; the
  targets and weights), the standardization, the forward pass and `_loss`
  with its gradient at the same float32 parameters: 1e-5 of JAX's float32
  values (disp compared slot by slot after ordering each atom's slots by
  neighbor and displacement: the two packages round the squared distances
  of a perfect cell's equidistant images apart, and so list them in
  another order);
- three-epoch loss curves within 1e-5 of JAX's float32 curve and of the
  port's float64 curve;
- every float the fits keep or write is float32, as JAX's (buckets,
  standardization, model, Adam moments, the saved state, `evaluate_bucket`),
  apart from the `.pt`, which widens to float64 as JAX's does;
- a warm start from a float64 saved state at float32 casts parameters,
  moments and standardization to float32, as the JAX package does: loss
  curves within 1e-5 of JAX's;
- every float32 request off the slice raises before any work, naming its
  ROADMAP.md queue title: the precompute, pairwise and PAS modes, ACE,
  chemflag and quadraticflag, twojmax 13, `auto` resolved to precompute,
  and the linear solvers.

Largest differences measured (this file, CPU): kit 9.7e-6 against JAX at
float32 (K11 on `noswitch`), 1.7e-5 against the port's float64 (K10T);
buckets 6.3e-7 (f_target); forward and loss 2.1e-7; loss curves 2.0e-7
against JAX, 3.7e-7 against float64; warm start 1.1e-7.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.ops import snap as jsnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.convert import mlp_params_from_numpy
from fitsnap_tpu_torch.kernels import launch as kl
from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.models.mlp import PerElementMLP
from fitsnap_tpu_torch.ops import snap as tsnap
from fitsnap_tpu_torch.ops.neighbors import reverse_neighbors
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import rel, seeded_params, write_ta
from tests.test_torch_nn_cached import twojmax8_block
from tests.test_torch_nn_fit import fit_settings, run
from tests.test_torch_snap import CASES, jax_params, make_block, port_params

F32 = torch.float32
KIT_TOL = 1e-4
TOL = 1e-5
KERNELS = ("nn_ut_b", "nn_dedu_vg", "nn_dedu_vg_t", "nn_pair_force",
           "nn_pair_force_t", "nn_pair_gather")


# ---------------------------------------------------------------------------
# the plain twins at float32
# ---------------------------------------------------------------------------


def kit_outputs(p, block, jidx, rev, inputs):
    """{kernel: outputs} of the six plain twins on `block` (the plan and the
    block at one type) with the seeded `inputs` at that type."""
    dt = block[0].dtype
    t = {k: torch.as_tensor(v, dtype=dt) for k, v in inputs.items()}
    ut = nk.nn_ut_b_plain(*block, p)
    z = sk.zlist_plain(ut[0], p)
    return {
        "nn_ut_b": ut,
        "nn_dedu_vg": (nk.nn_dedu_vg_plain(t["dEdB"], *z, p),),
        "nn_dedu_vg_t": (nk.nn_dedu_vg_t_plain(t["vgc"], *z, p),),
        "nn_pair_force": (nk.nn_pair_force_plain(t["vg"], *block, p),),
        "nn_pair_force_t": (nk.nn_pair_force_t_plain(
            t["gF"][None], jidx[None], *block, p),),
        "nn_pair_gather": (nk.nn_pair_gather_plain(t["g"][None], rev)[0],),
    }


def jax_kit(jp, block, jidx, inputs):
    """The JAX kit's counterparts at float32 on the same block (one jitted
    program: eager, each operation would compile on its own)."""
    f = {k: jnp.asarray(v, jnp.float32) for k, v in inputs.items()}
    return jax.jit(lambda tj, f: _jax_kit(jp, tj, jidx, f))(
        [jnp.asarray(x) for x in block], f)


def _jax_kit(jp, tj, jidx, f):
    A = tj[2].shape[0]
    block = tj
    ut_j, B_j = jsnap.nn_ut_b(*tj, jp)
    _, vjp = jax.vjp(lambda d: jsnap.nn_vg(jsnap.nn_dEdu(d, ut_j, jp), jp),
                     f["dEdB"])
    grid = jsnap.nn_grid_pair(*tj, jp)

    def forces(vg):
        g = jsnap.nn_pair_force(vg, grid)
        oj = jax.nn.one_hot(jnp.asarray(jidx), A, dtype=g.dtype)
        return -(jnp.einsum("akm,akc->mc", oj, g) - g.sum(1))

    _, fvjp = jax.vjp(forces, f["vg"])
    oj = jax.nn.one_hot(jnp.asarray(jidx), A, dtype=jnp.float32)
    gm = f["g"] * block[2][..., None]
    return {
        "nn_ut_b": (ut_j, B_j),
        "nn_dedu_vg": (jsnap.nn_vg(jsnap.nn_dEdu(f["dEdB"], ut_j, jp), jp),),
        "nn_dedu_vg_t": (vjp(f["vgc"])[0],),
        "nn_pair_force": (jsnap.nn_pair_force(f["vg"], grid),),
        "nn_pair_force_t": (fvjp(f["gF"])[0],),
        "nn_pair_gather": (-(jnp.einsum("akm,akc->mc", oj, gm)
                             - gm.sum(1)),),
    }


@pytest.fixture(scope="module", params=sorted(CASES) + ["tj8"])
def kit32(request):
    """Every twin of both packages on one seeded block: the port at float32
    and float64, JAX at float32."""
    if request.param == "tj8":
        jp, p, block, rng = twojmax8_block()
    else:
        case = CASES[request.param]
        jp = jax_params(case)
        p = port_params(jp)
        block = make_block(3, case["nelem"])
        rng = np.random.default_rng(5)
    A, K = block[2].shape
    n_t = tsnap.nn_tables(p).n_t
    jidx = rng.integers(0, A, (A, K)).astype(np.int32)
    revs = reverse_neighbors(jidx, block[2], A)
    rev = torch.as_tensor(np.asarray(revs, np.int32))[None]
    inputs = {"dEdB": rng.normal(size=(A, p.ntriples)),
              "vgc": rng.normal(size=(A, n_t, n_t)),
              "vg": rng.normal(size=(A, n_t, n_t)),
              "gF": rng.normal(size=(A, 3)),
              "g": rng.normal(size=(A, K, 3)) * block[2][..., None]}
    b64 = tuple(torch.as_tensor(x) for x in block)
    b32 = (b64[0].to(F32),) + b64[1:]
    jidx_t = torch.as_tensor(jidx)
    return {"f32": kit_outputs(p.cast(F32), b32, jidx_t, rev, inputs),
            "f64": kit_outputs(p, b64, jidx_t, rev, inputs),
            "jax": jax_kit(jp, (np.asarray(block[0], np.float32),)
                           + tuple(block[1:]), jidx, inputs)}


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_twins_at_float32_match_jax_and_float64(kit32, kernel):
    """Each twin at float32 returns float32, within 1e-4 of JAX's float32
    kit and of the port's float64 twin."""
    out = kit32["f32"][kernel]
    for ref in (kit32["jax"][kernel], kit32["f64"][kernel]):
        assert len(out) == len(ref)
        for x, y in zip(out, ref):
            assert x.dtype == F32
            assert rel(x, np.asarray(y)) <= KIT_TOL
    for y in kit32["jax"][kernel]:
        assert np.asarray(y).dtype == np.float32


# ---------------------------------------------------------------------------
# float32 fits
# ---------------------------------------------------------------------------


def init_patch32(mp, seed):
    """Both packages' `init_mlp` return the same seeded float64 draws,
    rounded once to the type each is asked for (`init_mlp`'s `dtype`)."""
    def draws(sizes, nelem):
        return seeded_params(sizes, nelem, seed, last_zero=True)

    mp.setattr(jnet, "init_mlp", lambda sizes, nelem, key, dtype=jnp.float32:
               [(jnp.asarray(w, dtype), jnp.asarray(b, dtype))
                for w, b in draws(sizes, nelem)])
    mp.setattr(tnet, "init_mlp", lambda sizes, nelem, gen, dev,
               dtype=torch.float64: mlp_params_from_numpy(
                   draws(sizes, nelem), dev, dtype))


def run32(name, s, root, dtype):
    """A fit through the port at `dtype` ("float32" or "float64") or
    through the JAX package at float32 (its accelerator type)."""
    if name == "jax":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "tpu")
            return run("jax", s, root)
    root.mkdir()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        fs = FitSnap(s, arglist=["--overwrite", "--dtype", dtype],
                     device="cpu")
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
        fs.config.hash = "0" * 32
        fs.write_output()
    finally:
        os.chdir(cwd)
    return fs


@pytest.fixture(scope="module", params=["cached", "otf"])
def fits(request, tmp_path_factory):
    """The port at float32 and float64 and JAX at float32, from the same
    initial weights, in one mode."""
    mode = request.param
    root = tmp_path_factory.mktemp(f"nn_f32_{mode}")
    write_ta(root / "JSON", 41)
    s = fit_settings(root / "JSON")
    s["PYTORCH"]["dgrad_mode"] = mode
    with pytest.MonkeyPatch.context() as mp:
        init_patch32(mp, 53)
        out = {name: run32(name.split("_")[0], s, root / name,
                           name.split("_")[-1])
               for name in ("port_float32", "port_float64", "jax")}
    for fs in out.values():
        assert getattr(fs.solver, mode) and fs.solver.buckets
    out.update(root=root, settings=s, mode=mode)
    return out


def canonical_slots(disp, jidx, mask):
    """disp (n, A, K, 3) with each atom's masked slots ordered by neighbor,
    then displacement (the masked-out slots after them)."""
    d, j, m = (np.asarray(x) for x in (disp, jidx, mask))
    out = np.array(d, np.float64)
    for c in range(d.shape[0]):
        for a in range(d.shape[1]):
            key = np.round(d[c, a], 3)
            order = np.lexsort((key[:, 2], key[:, 1], key[:, 0], j[c, a],
                                ~m[c, a]))
            out[c, a] = d[c, a][order]
    return out


def test_buckets_match_jax_float32(fits):
    port, jsol = fits["port_float32"].solver, fits["jax"].solver
    assert len(port.buckets) == len(jsol.buckets) >= 1
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert pb["shape"] == jb["shape"]
        assert pb["groups"] == jb["groups"]
        exact = ("jidx", "mask", "types") if fits["mode"] == "cached" else (
            "pos_hi", "pos_lo", "svec_hi", "svec_lo", "types")
        close = ("ut", "B", "e_target", "f_target", "ew", "fw") \
            if fits["mode"] == "cached" else ("e_target", "f_target", "ew",
                                               "fw")
        for key in exact:
            np.testing.assert_array_equal(pb[key].numpy(),
                                          np.asarray(jb[key]), err_msg=key)
        for key in close:
            assert np.asarray(jb[key]).dtype == np.float32, key
            assert rel(pb[key], np.asarray(jb[key])) <= TOL, key
        if fits["mode"] == "cached":
            assert rel(canonical_slots(pb["disp"], pb["jidx"], pb["mask"]),
                       canonical_slots(jb["disp"], jb["jidx"], jb["mask"])) \
                <= TOL
    for key in ("mean", "std"):
        assert np.asarray(getattr(jsol, key)).dtype == np.float32
        assert rel(getattr(port, key), np.asarray(getattr(jsol, key))) <= TOL


def test_forward_and_loss_match_jax_float32(fits):
    """`_forward_batch_cached` / `_forward_batch_otf` and `_loss` with its
    gradient at the same float32 parameters on each bucket's first four
    configs."""
    port, jsol = fits["port_float32"].solver, fits["jax"].solver
    keys = (jnet.NetworkSolver._BATCH_KEYS_CACHED if fits["mode"] == "cached"
            else jnet.NetworkSolver._BATCH_KEYS_OTF)
    params = seeded_params([int(port.mean.shape[0]), 8, 8, 1], 1, 19)
    p32 = [(torch.tensor(w, dtype=F32), torch.tensor(b, dtype=F32))
           for w, b in params]
    j32 = [(jnp.asarray(w, jnp.float32), jnp.asarray(b, jnp.float32))
           for w, b in params]
    fwd = "_forward_batch_" + fits["mode"]
    # jitted, as the JAX package runs them (eager, each operation would
    # compile on its own)
    jfwd = jax.jit(getattr(jsol, fwd))
    jloss = jax.jit(jax.value_and_grad(jsol._loss))
    for bi, jb in enumerate(jsol.buckets):
        idx = np.arange(min(4, len(jb["groups"])))
        batch = port._gather(port.buckets[bi], idx)
        jbatch = {k: jnp.asarray(np.asarray(jb[k])[idx]) for k in keys}
        model = PerElementMLP(p32)
        e, f = getattr(port, fwd)(model, batch)
        je, jf = jfwd(j32, jbatch)
        assert e.dtype == f.dtype == F32
        assert rel(e, np.asarray(je)) <= TOL and rel(f, np.asarray(jf)) <= TOL
        loss = port._loss(model, batch, train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        jl, jg = jloss(j32, jbatch)
        assert loss.dtype == F32 and rel(loss, float(jl)) <= TOL
        for g, r in zip(grads, jax.tree.leaves(jg)):
            assert g.dtype == F32 and rel(g, np.asarray(r)) <= TOL


def test_loss_curves_match_jax_and_float64(fits):
    hist = np.array(fits["port_float32"].solver.history)
    assert hist.shape == (3, 3) and np.isfinite(hist).all()
    for ref in ("jax", "port_float64"):
        assert rel(hist, np.array(fits[ref].solver.history)) <= TOL, ref


def test_float32_throughout(fits):
    """Every float the fit keeps or writes is float32, as the JAX package's
    (its saved state's arrays of the same types), apart from the `.pt`,
    which widens to float64."""
    sol, jsol = fits["port_float32"].solver, fits["jax"].solver
    kept = [v for b in sol.buckets for v in b.values()
            if torch.is_tensor(v) and v.is_floating_point()]
    kept += [sol.mean, sol.std] + list(sol.model.parameters())
    assert kept and all(t.dtype == F32 for t in kept)
    for pb in sol.buckets:
        assert all(x.dtype == np.float32 for x in sol.evaluate_bucket(pb))
    states = {}
    for name in ("port_float32", "jax"):
        with open(fits["root"] / name / "state.pkl", "rb") as f:
            states[name] = pickle.load(f)
    port, ref = states["port_float32"], states["jax"]
    for (w, b), (jw, jb) in zip(port["params"], ref["params"]):
        assert w.dtype == b.dtype == jw.dtype == jb.dtype == np.float32
    for key in ("mean", "std"):
        assert port["meta"][key].dtype == np.asarray(
            ref["meta"][key]).dtype == np.float32
    assert [np.asarray(x).dtype for x in port["meta"]["opt_state"]] == [
        np.asarray(x).dtype for x in ref["meta"]["opt_state"]]
    pt = torch.load(fits["root"] / "port_float32" / "Ta_nn.pt",
                    weights_only=False)
    jpt = torch.load(fits["root"] / "jax" / "Ta_nn.pt", weights_only=False)
    floats = [t for t in pt.state_dict().values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float64 for t in floats)
    assert all(t.dtype == torch.float64 for t in jpt.state_dict().values()
               if t.is_floating_point())


def test_warm_start_from_float64_state_matches_jax(fits, tmp_path):
    """A float32 fit warm-started from the float64 fit's saved state casts
    the parameters, the Adam moments and the standardization to float32
    in both packages; one epoch's loss curves agree."""
    s = dict(fits["settings"])
    s["PYTORCH"] = dict(s["PYTORCH"], num_epochs=1, save_state_output="None",
                        save_state_input=str(fits["root"] / "port_float64"
                                             / "state.pkl"))
    out = {name: run32(name.split("_")[0], s, tmp_path / name, "float32")
           for name in ("port_float32", "jax")}
    sol = out["port_float32"].solver
    assert all(t.dtype == F32 for t in list(sol.model.parameters())
               + [sol.mean, sol.std])
    assert rel(np.array(sol.history),
               np.array(out["jax"].solver.history)) <= TOL


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def refused_settings(root, case):
    """Settings of a float32 request off the slice, and its queue title."""
    s = synthetic.nn_settings(root)
    if case == "precompute":
        s["PYTORCH"]["dgrad_mode"] = "precompute"
        return s, kl.QUEUE_NN
    if case == "pairwise":
        return synthetic.custom_settings(root), kl.QUEUE_NN
    if case == "pas":
        return synthetic.pas_settings(root), kl.QUEUE_NN
    if case == "ace":
        return synthetic.ace_nn_settings(root, dgrad_mode="otf"), \
            kl.QUEUE_ACE
    if case in ("chemflag", "quadraticflag"):
        s["BISPECTRUM"][case] = 1
        s["PYTORCH"]["dgrad_mode"] = "otf"
        return s, kl.QUEUE_CHEM
    if case == "twojmax13":
        s["BISPECTRUM"]["twojmax"] = 13
        return s, kl.QUEUE_LARGE
    s = synthetic.ta_settings(root)
    s["SOLVER"]["solver"] = case.upper()
    return s, "streamed fit"


@pytest.mark.parametrize("case", ["precompute", "pairwise", "pas", "ace",
                                  "chemflag", "quadraticflag", "twojmax13",
                                  "svd", "tpusvd"])
def test_off_slice_float32_is_refused_at_construction(tmp_path, case,
                                                       monkeypatch):
    """Each raises TypeError naming its queue title (the linear solvers:
    the two paths that take float32) as FitSnap is built, before its
    calculator (no SNAP or ACE plan is made)."""
    s, title = refused_settings(tmp_path, case)
    monkeypatch.setattr("fitsnap_tpu_torch.fitsnap._calculator_factory",
                        None)
    with pytest.raises(TypeError, match=title):
        FitSnap(s, arglist=["--overwrite", "--dtype", "float32"],
                device="cpu")


def test_auto_resolving_to_precompute_is_refused(tmp_path, monkeypatch):
    """`auto` that resolves to precompute at float32 (the cached mode's
    cache over FITSNAP_TPU_NN_NEIGH_LIMIT) raises with the NN queue title
    before any bucket is built; an unknown `--dtype` raises too."""
    write_ta(tmp_path / "JSON", 41)
    s = fit_settings(tmp_path / "JSON")
    s["PYTORCH"]["dgrad_mode"] = "auto"
    monkeypatch.setenv("FITSNAP_TPU_NN_NEIGH_LIMIT", "1")
    monkeypatch.chdir(tmp_path)
    fs = FitSnap(s, arglist=["--overwrite", "--dtype", "float32"],
                 device="cpu")
    fs.scrape_configs()
    with pytest.raises(TypeError, match=kl.QUEUE_NN):
        fs.process_configs()
    assert fs.solver.buckets is None
    with pytest.raises(ValueError, match="float32 or float64"):
        FitSnap(s, arglist=["--overwrite", "--dtype", "float16"],
                device="cpu")
