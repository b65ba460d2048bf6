"""The NN solver's cached analytic-force mode in fitsnap_tpu_torch against
fitsnap_tpu (CPU, float64).

The JAX package trains SNAP networks in this mode by default: per-atom ut
and B are cached once (K9), and every step takes dE/dB back to the pairs
analytically (K10, K11 and the force gather; their transposes K10T, K11T
in the loss gradient).  Inputs are made from seeds with numpy.  Checks,
with their tolerances (relative to the largest magnitude):

- the plain monomial kit of `ops/snap.py` against the JAX functions on the
  neighbor blocks of `tests/test_torch_snap.py` (twojmax 6, one element;
  two elements with the inner switching function), 1e-12: `nn_ut_b`,
  `compute_utot_mono` (also against the recursion `compute_utot`),
  `nn_dEdu`, `nn_vg`, `nn_grid_pair`, `nn_pair_force`, `nn_pair_grad`,
  `atom_descriptors_fast`;
- K10T's and K11T's plain versions against `jax.vjp` of the JAX
  functions (K11T through the force scatter), 1e-12; K9's, K10's, K10T's,
  K11's and K11T's also at twojmax 8 on 4 x 12 slots with a padded atom
  and a masked hole, and the force gather's against the JAX one-hot scatter on an atom
  no one neighbors, R > K and one-atom configs, 1e-12;
- the cached buckets of both packages' `prepare_dataset` (the small Ta
  set of `tests/test_torch_nn.py`): shapes and configs exactly, disp, ut,
  B, targets and standardization 1e-12; `_forward_batch_cached` and
  `_loss` with its parameter gradient (one and two network elements)
  against the JAX ones, 1e-12; the gradient through `NnCachedForce`
  against plain autograd, 1e-10; `nn_desc` against `nn_desc_fn`, 1e-12,
  also under chemflag (InP-shaped cells, two elements, wselfallflag 0 and
  1, with and without quadraticflag);
- whole cached fits, one element (the Ta set) and two (InP-shaped cells
  without chemflag, multi_element_option 1: the network index is zeroed,
  the atom types are not): loss curves 1e-10, `evaluate_bucket`, the
  error table and the written files 1e-10;
- cached against precompute forces in the port, same parameters and
  configs, 1e-9;
- `dgrad_mode = auto` resolves as in the JAX package: cached for linear
  SNAP, precompute for chemflag and quadraticflag;
- `python -m fitsnap_tpu_torch` trains in the cached mode on the CPU.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops.cg import build_snap_plan
from fitsnap_tpu.ops import snap as jsnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.convert import mlp_params_from_numpy
from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.models.mlp import PerElementMLP
from fitsnap_tpu_torch.ops.neighbors import reverse_neighbors
from fitsnap_tpu_torch.ops import snap as tsnap
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_nn import (as_jax, as_torch, rel, seeded_params,
                                 ta_nn_settings, write_ta)
from tests.test_torch_nn_fit import ROOT, fit_settings, run
from tests.test_torch_snap import CASES, jax_params, make_block, port_params

TOL = 1e-12
FIT_TOL = 1e-10


# ---------------------------------------------------------------------------
# the plain kit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["bzero0", "inner2el"])
def kit(request):
    """Every kit function of both packages on one seeded neighbor block."""
    case = CASES[request.param]
    jp = jax_params(case)
    p = port_params(jp)
    block = make_block(3, case["nelem"])
    tj = [jnp.asarray(x) for x in block]
    tt = [torch.as_tensor(x) for x in block]
    rng = np.random.default_rng(5)
    ut_j, B_j = jsnap.nn_ut_b(*tj, jp)
    ut_t, B_t = tsnap.nn_ut_b(*tt, p)
    dEdB = rng.normal(size=B_j.shape)
    du_j = jsnap.nn_dEdu(jnp.asarray(dEdB), ut_j, jp)
    du_t = tsnap.nn_dEdu(torch.as_tensor(dEdB), ut_t, p)
    vg_j, vg_t = jsnap.nn_vg(du_j, jp), tsnap.nn_vg(du_t, p)
    grid_j = jsnap.nn_grid_pair(*tj, jp)
    grid_t = tsnap.nn_grid_pair(*tt, p)
    parts_j = jsnap.snap_nn_parts(*tj, jp)
    parts_t = tsnap.snap_nn_parts(*tt, p)
    ur, ui = tsnap.compute_utot(*tt, p)
    pairs = {
        "nn_ut_b": ((ut_t, B_t), (ut_j, B_j)),
        "compute_utot_mono": (tsnap.compute_utot_mono(*tt, p),
                              jsnap.compute_utot_mono(*tj, jp)),
        "recursion": ((ut_t,), (torch.cat([ur, ui], -1).numpy(),)),
        "atom_descriptors_fast": (
            (tsnap.atom_descriptors_fast(*tt, p),),
            (jsnap.atom_descriptors_fast(*tj, jp),)),
        "nn_dEdu": ((du_t,), (du_j,)),
        "nn_vg": ((vg_t,), (vg_j,)),
        "nn_grid_pair": (grid_t, grid_j),
        "nn_pair_force": ((tsnap.nn_pair_force(vg_t, grid_t),),
                          (jsnap.nn_pair_force(vg_j, grid_j),)),
        "nn_pair_grad": (
            (tsnap.nn_pair_grad(torch.as_tensor(dEdB), parts_t, p),),
            (jsnap.nn_pair_grad(jnp.asarray(dEdB), parts_j, jp),)),
    }
    return SimpleNamespace(pairs=pairs, jp=jp, p=p, tj=tj, tt=tt, rng=rng,
                           ut_j=ut_j, ut_t=ut_t, grid_j=grid_j)


@pytest.mark.parametrize("name", ["nn_ut_b", "compute_utot_mono",
                                  "recursion", "atom_descriptors_fast",
                                  "nn_dEdu", "nn_vg", "nn_grid_pair",
                                  "nn_pair_force", "nn_pair_grad"])
def test_kit_equals_jax(kit, name):
    port, ref = kit.pairs[name]
    assert len(port) == len(ref)
    for x, y in zip(port, ref):
        assert rel(x, np.asarray(y)) <= TOL


def test_k10t_k11t_plain_equal_jax_vjp(kit):
    """The transposes against `jax.vjp`: K10T of dE/dB -> vg, K11T of vg
    -> forces (the pair force, then the scatter over a seeded jidx of the
    block as one config)."""
    jp, p, rng = kit.jp, kit.p, kit.rng
    A, K = kit.tt[2].shape
    n_t = tsnap.nn_tables(p).n_t
    dEdB = jnp.asarray(rng.normal(size=(A, p.ntriples)))
    vgc = rng.normal(size=(A, n_t, n_t))
    _, vjp = jax.vjp(lambda d: jsnap.nn_vg(jsnap.nn_dEdu(d, kit.ut_j, jp),
                                           jp), dEdB)
    z = sk.zlist_plain(kit.ut_t, p)
    out = nk.nn_dedu_vg_t_plain(torch.as_tensor(vgc), *z, p)
    assert rel(out, np.asarray(vjp(jnp.asarray(vgc))[0])) <= TOL

    jidx = rng.integers(0, A, (A, K)).astype(np.int32)
    gF = rng.normal(size=(A, 3))

    def forces(vg):
        g = jsnap.nn_pair_force(vg, kit.grid_j)
        oj = jax.nn.one_hot(jnp.asarray(jidx), A, dtype=g.dtype)
        return -(jnp.einsum("akm,akc->mc", oj, g) - g.sum(1))

    _, vjp = jax.vjp(forces, jnp.asarray(rng.normal(size=(A, n_t, n_t))))
    out = nk.nn_pair_force_t_plain(torch.as_tensor(gF)[None],
                                   torch.as_tensor(jidx)[None], *kit.tt, p)
    assert rel(out, np.asarray(vjp(jnp.asarray(gF))[0])) <= TOL


def twojmax8_block():
    """(JAX params, the port's, one config of 4 atoms x 12 slots at
    twojmax 8 (n_t 45): masked tails, a masked hole between live slots, a
    padded atom; the generator after drawing it)."""
    jp = jsnap.SnapParams(
        plan=build_snap_plan(twojmax=8, nelements=1, bzeroflag=False),
        rcutfac=4.67637, rfac0=0.99363, rmin0=0.0, switchflag=True,
        switchinnerflag=False, wj=np.array([1.0]), radelem=np.array([0.5]),
        sinner=None, dinner=None)
    p = port_params(jp)
    A, K = 4, 12
    rng = np.random.default_rng(31)
    disp = rng.normal(size=(A, K, 3))
    disp *= rng.uniform(1.0, 4.9, (A, K, 1)) / np.linalg.norm(
        disp, axis=-1, keepdims=True)
    mask = np.arange(K)[None, :] < rng.integers(6, K + 1, (A, 1))
    mask[0, 2] = False
    mask[-1] = False
    block = (disp, np.zeros((A, K), np.int32), mask, np.zeros(A, np.int32))
    return jp, p, block, rng


def test_k11t_plain_equals_jax_vjp_twojmax8():
    """K11T's plain version against `jax.vjp` of the JAX pair force and the
    one-hot force scatter at twojmax 8 (`twojmax8_block`)."""
    jp, p, block, rng = twojmax8_block()
    A, K = block[2].shape
    jidx = rng.integers(0, A, (A, K)).astype(np.int32)
    gF = rng.normal(size=(A, 3))
    grid_j = jsnap.nn_grid_pair(*(jnp.asarray(x) for x in block), jp)

    def forces(vg):
        g = jsnap.nn_pair_force(vg, grid_j)
        oj = jax.nn.one_hot(jnp.asarray(jidx), A, dtype=g.dtype)
        return -(jnp.einsum("akm,akc->mc", oj, g) - g.sum(1))

    n_t = tsnap.nn_tables(p).n_t
    _, vjp = jax.vjp(forces, jnp.asarray(rng.normal(size=(A, n_t, n_t))))
    out = nk.nn_pair_force_t_plain(
        torch.as_tensor(gF)[None], torch.as_tensor(jidx)[None],
        *(torch.as_tensor(x) for x in block), p)
    assert rel(out, np.asarray(vjp(jnp.asarray(gF))[0])) <= TOL
    assert not out[-1].any()


def test_k11_plain_equals_jax_twojmax8():
    """K11's plain version against the JAX `nn_pair_force` on
    `nn_grid_pair` at twojmax 8 (`twojmax8_block`), a seeded vg: the
    padded atom's and the masked slots' gradients 0."""
    jp, p, block, rng = twojmax8_block()
    A = block[2].shape[0]
    n_t = tsnap.nn_tables(p).n_t
    vg = rng.normal(size=(A, n_t, n_t))
    ref = jsnap.nn_pair_force(jnp.asarray(vg), jsnap.nn_grid_pair(
        *(jnp.asarray(x) for x in block), jp))
    out = nk.nn_pair_force_plain(torch.as_tensor(vg),
                                 *(torch.as_tensor(x) for x in block), p)
    assert rel(out, np.asarray(ref)) <= TOL
    assert not out[torch.as_tensor(~block[2])].any()


@pytest.mark.parametrize("kernel", ["nn_ut_b", "nn_dedu_vg"])
def test_k9_k10_plain_equal_jax_twojmax8(kernel):
    """K9's plain version against the JAX `nn_ut_b` (ut and B; the padded
    atom's ut the self term) and K10's, on K2's plain z-lists of the JAX
    ut, against `nn_vg` after `nn_dEdu`, at twojmax 8 on `twojmax8_block`'s
    atoms and a seeded dE/dB."""
    jp, p, block, rng = twojmax8_block()
    A = block[2].shape[0]
    ut_j, B_j = jsnap.nn_ut_b(*(jnp.asarray(x) for x in block), jp)
    if kernel == "nn_ut_b":
        ut, B = nk.nn_ut_b_plain(*(torch.as_tensor(x) for x in block), p)
        assert rel(ut, np.asarray(ut_j)) <= TOL
        assert rel(B, np.asarray(B_j)) <= TOL
        assert torch.equal(ut[-1], p.selfvec)
        return
    dEdB = rng.normal(size=(A, p.ntriples))
    ref = jsnap.nn_vg(jsnap.nn_dEdu(jnp.asarray(dEdB), ut_j, jp), jp)
    z = sk.zlist_plain(torch.as_tensor(np.asarray(ut_j)), p)
    out = nk.nn_dedu_vg_plain(torch.as_tensor(dEdB), *z, p)
    assert rel(out, np.asarray(ref)) <= TOL


def test_k10t_plain_equals_jax_vjp_twojmax8():
    """K10T's plain version on K2's plain z-lists against `jax.vjp` of
    `nn_vg` after `nn_dEdu` at twojmax 8, on the JAX ut of
    `twojmax8_block`'s atoms."""
    jp, p, block, rng = twojmax8_block()
    A = block[2].shape[0]
    n_t = tsnap.nn_tables(p).n_t
    ut_j, _ = jsnap.nn_ut_b(*(jnp.asarray(x) for x in block), jp)
    dEdB = jnp.asarray(rng.normal(size=(A, p.ntriples)))
    vgc = rng.normal(size=(A, n_t, n_t))
    _, vjp = jax.vjp(lambda d: jsnap.nn_vg(jsnap.nn_dEdu(d, ut_j, jp), jp),
                     dEdB)
    z = sk.zlist_plain(torch.as_tensor(np.asarray(ut_j)), p)
    out = nk.nn_dedu_vg_t_plain(torch.as_tensor(vgc), *z, p)
    assert rel(out, np.asarray(vjp(jnp.asarray(vgc))[0])) <= TOL


# (configs, atoms, slots): lonely, an atom that no one neighbors; r_gt_k,
# every slot's neighbor is atom 0 (R = 12 > K = 3); one_atom, configs of one
# atom, each its own neighbor through periodic images
GATHER_EDGES = {"lonely": (2, 5, 6), "r_gt_k": (1, 4, 3),
                "one_atom": (3, 1, 5)}


@pytest.mark.parametrize("name", list(GATHER_EDGES))
def test_gather_plain_equals_jax_scatter(name):
    """The force gather's plain version (through the reverse table) against
    the JAX package's one-hot scatter -(einsum(one_hot(jidx), g) -
    g.sum(2)), g zero on masked slots as the callers give it; 1e-12 of the
    larger of |F| and |g|."""
    N, A, K = GATHER_EDGES[name]
    rng = np.random.default_rng(32)
    jidx = rng.integers(0, A, (N, A, K))
    mask = rng.uniform(size=(N, A, K)) < 0.75
    if name == "lonely":
        jidx[jidx == A - 1] = 0
    elif name == "r_gt_k":
        jidx[:] = 0
        mask[:] = True
    g = rng.normal(size=(N, A, K, 3)) * mask[..., None]
    revs = [reverse_neighbors(jidx[c], mask[c], A) for c in range(N)]
    R = max(r.shape[1] for r in revs)
    rev = np.full((N, A, R), -1, np.int32)
    for c, r in enumerate(revs):
        rev[c, :, :r.shape[1]] = r
    if name == "lonely":
        assert (rev[:, -1] < 0).all()
    elif name == "r_gt_k":
        assert R == A * K > K
    oj = jax.nn.one_hot(jnp.asarray(jidx), A, dtype=jnp.float64)
    ref = -(jnp.einsum("nakm,nakc->nmc", oj, jnp.asarray(g))
            - jnp.asarray(g).sum(2))
    out = nk.nn_pair_gather_plain(torch.as_tensor(g), torch.as_tensor(rev))
    # a one-atom config's force is 0 (its pairs cancel), so the scale is
    # the larger of the forces' and the pair gradients'
    scale = max(np.abs(np.asarray(ref)).max(), np.abs(g).max())
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= TOL * scale


# ---------------------------------------------------------------------------
# prepared buckets, forward pass and loss
# ---------------------------------------------------------------------------


def cached_settings(root):
    s = ta_nn_settings(root)
    s["PYTORCH"]["dgrad_mode"] = "cached"
    return s


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' prepare_dataset in the cached mode on the Ta set."""
    root = tmp_path_factory.mktemp("nn_cached")
    write_ta(root / "JSON", 41)
    s = cached_settings(root / "JSON")
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
    assert port.solver.cached and jfs.solver.cached
    return port.solver, jfs.solver, port, jfs


def test_cached_buckets_equal_jax(prepared):
    port, jsol, _, _ = prepared
    assert len(port.buckets) == len(jsol.buckets) >= 1
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert "G" not in pb and "pos_hi" not in pb
        assert pb["shape"] == jb["shape"]
        assert pb["groups"] == jb["groups"] and pb["files"] == jb["files"]
        np.testing.assert_array_equal(pb["test"], jb["test"])
        np.testing.assert_array_equal(pb["nat_host"], jb["nat"])
        for key in ("jidx", "mask", "types", "elem", "real"):
            np.testing.assert_array_equal(pb[key].numpy(),
                                          np.asarray(jb[key]))
        for key in ("disp", "ut", "B", "e_target", "f_target", "ew", "fw"):
            assert rel(pb[key], np.asarray(jb[key])) <= TOL, key
    assert rel(port.mean, np.asarray(jsol.mean)) <= TOL
    assert rel(port.std, np.asarray(jsol.std)) <= TOL


def batches(port, jsol, bi, idx, nelem=1, seed=0):
    """The same minibatch from both packages' buckets; with two network
    elements the atoms get seeded network indices ("elem")."""
    batch = port._gather(port.buckets[bi], idx)
    jb = {k: jnp.asarray(np.asarray(v)[idx])
          for k, v in jsol.buckets[bi].items()
          if k in jnet.NetworkSolver._BATCH_KEYS_CACHED}
    if nelem > 1:
        elem = np.random.default_rng(seed).integers(
            0, nelem, tuple(batch["elem"].shape))
        batch["elem"] = torch.tensor(elem, dtype=torch.int32)
        jb["elem"] = jnp.asarray(elem, jnp.int32)
    return batch, jb


def test_forward_batch_cached_equals_jax(prepared):
    port, jsol, _, _ = prepared
    params = seeded_params([14, 8, 8, 1], 1, 17)
    for bi, jb in enumerate(jsol.buckets):
        idx = np.arange(len(jb["groups"]))[::-1].copy()
        batch, jbatch = batches(port, jsol, bi, idx)
        e, f = port._forward_batch_cached(PerElementMLP(as_torch(params)),
                                          batch)
        je, jf = jsol._forward_batch_cached(as_jax(params), jbatch)
        assert rel(e, np.asarray(je)) <= TOL
        assert rel(f, np.asarray(jf)) <= TOL


@pytest.mark.parametrize("nelem", [1, 2])
def test_cached_loss_and_gradient_equal_jax(prepared, nelem):
    """The loss and its gradient with respect to every MLP parameter; the
    port's runs through NnCachedForce (K11T's and K10T's plain versions in
    the backward), the JAX one through autodiff."""
    port, jsol, _, _ = prepared
    params = seeded_params([14, 8, 8, 1], nelem, 19)
    for bi in range(len(jsol.buckets)):
        idx = np.arange(min(4, len(jsol.buckets[bi]["groups"])))
        batch, jbatch = batches(port, jsol, bi, idx, nelem, seed=bi)
        model = PerElementMLP(as_torch(params))
        loss = port._loss(model, batch, train=True)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        jl, jg = jax.value_and_grad(jsol._loss)(as_jax(params), jbatch)
        assert rel(loss, float(jl)) <= TOL
        for g, r in zip(grads, jax.tree.leaves(jg)):
            assert rel(g, np.asarray(r)) <= TOL


def plain_cached_force(dEdB, ut, disp, jidx, jelem, mask, ielem, rev, p):
    """NnCachedForce by autograd through the plain kit."""
    N, A, K = jidx.shape
    grid = tsnap.nn_grid_pair(disp, jelem, mask, ielem, p)
    g = tsnap.nn_pair_force(tsnap.nn_vg(tsnap.nn_dEdu(dEdB, ut, p), p), grid)
    return nk.nn_pair_gather_plain(g.reshape(N, A, K, 3), rev)


def test_loss_gradient_through_nn_cached_force_equals_plain_autograd(
        prepared, monkeypatch):
    port, _, _, _ = prepared
    model = PerElementMLP(as_torch(seeded_params([14, 8, 8, 1], 1, 23)))
    leaves = list(model.parameters())
    bi = int(np.argmax([len(b["groups"]) for b in port.buckets]))
    batch = port._gather(port.buckets[bi], np.array([1, 0, 2]))
    out = torch.autograd.grad(port._loss(model, batch, train=True), leaves)
    monkeypatch.setattr(tnet, "NnCachedForce",
                        SimpleNamespace(apply=plain_cached_force))
    ref = torch.autograd.grad(port._loss(model, batch, train=True), leaves)
    for x, y in zip(out, ref):
        assert rel(x, y.numpy()) <= FIT_TOL


def test_nn_desc_equals_jax(prepared):
    port, _, fs, jfs = prepared
    pb = port.buckets[-1]
    n = min(3, len(pb["groups"]))
    args = [pb[k][:n] for k in ("disp", "jidx", "mask", "types", "nat")]
    out = fs.calculator.nn_desc(*args)
    ref = jax.vmap(jfs.calculator.nn_desc_fn())(
        *[jnp.asarray(a.numpy()) for a in args])
    assert rel(out, np.asarray(ref)) <= TOL
    assert rel(out, pb["B"][:n].numpy()) <= TOL


@pytest.mark.parametrize("wself,quad", [(0, 0), (1, 1)])
def test_nn_desc_chemflag_equals_jax(wself, quad):
    """`nn_desc` under chemflag (K9 over the element channels, the
    quadratic columns under quadraticflag) against the JAX package's
    `nn_desc_fn` (`atom_descriptors_fast` over the channels) on three
    jittered 8-atom InP-shaped cells at twojmax 4, the last with an
    antisite and one atom fewer (a padded atom slot, its B zero)."""
    from fitsnap_tpu.calculators import snap as jcalcs
    from fitsnap_tpu.config import Config as JaxConfig
    from fitsnap_tpu_torch.calculators import snap as tcalcs
    from fitsnap_tpu_torch.config import Config

    rng = np.random.default_rng(71)
    dicts = []
    for i, (pos, cell, names) in enumerate(
            synthetic.inp_configs(5, {"Volume_ZB": 3})["Volume_ZB"]):
        names = list(names)
        if i == 2:
            # an antisite, and a config of 7 atoms: one padded atom slot
            names[0] = "P"
            pos, names = pos[:7], names[:7]
        n = len(pos)
        dicts.append({"Positions": pos + rng.normal(0.0, 0.1, (n, 3)),
                      "Lattice": cell, "AtomTypes": names, "NumAtoms": n,
                      "Energy": 0.0, "Forces": np.zeros((n, 3)),
                      "Group": "g", "File": f"{i}", "test_bool": 0})
    s = synthetic.inp_settings("unused", groups=[])
    s["BISPECTRUM"].update(twojmax="4 4", wselfallflag=wself,
                           quadraticflag=quad)
    tcalc = tcalcs.SnapCalculator("LAMMPSSNAP", Config(s, ["--overwrite"]),
                                  "cpu")
    jcalc = jcalcs.SnapCalculator("LAMMPSSNAP",
                                  JaxConfig(s, ["--overwrite"]))
    assert tcalc.params.nchem == 2
    packed, buckets = tcalc.host_preprocess(dicts)
    buckets = jcalcs.coalesce_shape_buckets(buckets, 1)
    ((a_pad, k_pad), idxs), = buckets.items()
    disp, jidx, mask, _, types, nat, _ = tcalcs.pack_bucket(
        packed, idxs, a_pad, k_pad)
    out = tcalc.nn_desc(*[torch.from_numpy(x)
                          for x in (disp, jidx, mask, types, nat)])
    ref = jax.vmap(jcalc.nn_desc_fn())(
        jnp.asarray(disp), jnp.asarray(jidx), jnp.asarray(mask),
        jnp.asarray(types), jnp.asarray(nat, jnp.int32))
    assert out.shape == (3, a_pad, tcalc.desc_width())
    assert tcalc.desc_width() == 112 + quad * 112 * 113 // 2
    assert rel(out, np.asarray(ref)) <= TOL
    assert not out[nat < a_pad][:, -1].any() and out.abs().max() > 0


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------


def init_patch(mp, seed):
    def init(sizes, nelem, *_, **__):
        return seeded_params(sizes, nelem, seed, last_zero=True)

    mp.setattr(jnet, "init_mlp", lambda *a, **k: [
        (jnp.asarray(w), jnp.asarray(b)) for w, b in init(*a)])
    mp.setattr(tnet, "init_mlp",
               lambda *a, **k: mlp_params_from_numpy(init(*a)))


def inp_linear_settings(root):
    """Five InP-shaped cells (two elements) with the InP model's
    BISPECTRUM at twojmax 4 without chemflag, bnormflag or wselfallflag;
    one shared network (multi_element_option 1), cached mode."""
    rng = np.random.default_rng(59)
    counts = {"Volume_ZB": 2, "Strain_ZB": 3}
    for group, confs in synthetic.inp_configs(7, counts).items():
        (root / "JSON" / group).mkdir(parents=True)
        for i, (pos, cell, names) in enumerate(confs):
            n = len(pos)
            pos = pos + rng.normal(0.0, 0.08, pos.shape)
            (root / "JSON" / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(pos, cell, energy=-3.4 * n,
                                      forces=rng.normal(0, 0.3, (n, 3)),
                                      types=names))
    s = synthetic.inp_settings(root / "JSON", groups=list(counts))
    s["BISPECTRUM"].update(twojmax="4 4", chemflag=0, bnormflag=0,
                           wselfallflag=0)
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = {"layer_sizes": "num_desc 6 1", "batch_size": 2,
                    "num_epochs": 2, "learning_rate": 1e-3,
                    "multi_element_option": 1, "manual_seed_flag": 1,
                    "energy_weight": 1e-2, "force_weight": 1.0,
                    "dgrad_mode": "cached"}
    s["EXTRAS"] = {"dump_peratom": 1, "dump_perconfig": 1}
    return s


@pytest.fixture(scope="module", params=["Ta", "InP"])
def fits(request, tmp_path_factory):
    """A cached fit through both packages from the same initial weights."""
    root = tmp_path_factory.mktemp(f"cached_fit_{request.param}")
    if request.param == "Ta":
        write_ta(root / "JSON", 41)
        s = fit_settings(root / "JSON")
        s["PYTORCH"]["dgrad_mode"] = "cached"
    else:
        s = inp_linear_settings(root)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        out = {name: run(name, s, root / name) for name in ("port", "jax")}
    assert out["port"].solver.cached and out["jax"].solver.cached
    out.update(root=root, settings=s, name=request.param)
    return out


def test_cached_fit_loss_curve_equals_jax(fits):
    port = np.array(fits["port"].solver.history)
    ref = np.array(fits["jax"].solver.history)
    assert port.shape == ref.shape
    assert np.isfinite(port).all()
    assert rel(port, ref) <= FIT_TOL


def test_cached_fit_predictions_and_errors_equal_jax(fits):
    port, jsol = fits["port"].solver, fits["jax"].solver
    assert len(port.buckets) == len(jsol.buckets)
    for pb, jb in zip(port.buckets, jsol.buckets):
        for x, y in zip(port.evaluate_bucket(pb), jsol.evaluate_bucket(jb)):
            assert rel(x, y) <= FIT_TOL
        if fits["name"] == "InP":
            # the network index is zeroed, the atom types are not
            assert not pb["elem"].any() and pb["types"].any()
    errs, ref = port.errors, jsol.errors
    assert errs.index == list(ref.index)
    assert rel(errs.values, ref.to_numpy(float)) <= FIT_TOL


@pytest.mark.parametrize("name", ["loss_vs_epochs.dat", "perconfig.dat",
                                  "peratom.dat", "pot.mliap.descriptor"])
def test_cached_fit_files_equal_jax(fits, name):
    def table(path):
        words, nums = [], []
        for tok in path.read_text().split():
            try:
                nums.append(float(tok))
            except ValueError:
                words.append(tok.replace("fitsnap_tpu_torch", "fitsnap_tpu"))
        return words, np.array(nums)

    if name.startswith("pot."):
        name = fits["settings"]["OUTFILE"]["potential"] + name[3:]
    pw, port = table(fits["root"] / "port" / name)
    jw, ref = table(fits["root"] / "jax" / name)
    assert pw == jw
    assert port.size > 0
    assert rel(port, ref) <= FIT_TOL


def test_cached_forces_equal_precompute(fits, tmp_path):
    """The port's precompute mode on the same configs with the cached fit's
    model and standardization: the same energies and forces."""
    cached = fits["port"].solver
    s = dict(fits["settings"])
    s["PYTORCH"] = dict(s["PYTORCH"], dgrad_mode="precompute", num_epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        init_patch(mp, 53)
        pre = run("port", s, tmp_path / "pre").solver
    assert not pre.cached and "G" in pre.buckets[0]
    pre.model, pre.mean, pre.std = cached.model, cached.mean, cached.std

    def by_file(solver):
        out = {}
        for ds in solver.buckets:
            e, f = solver.evaluate_bucket(ds)
            for i, fn in enumerate(ds["files"]):
                na = int(ds["nat_host"][i])
                out[fn] = (e[i], f[i, :na])
        return out

    a, b = by_file(cached), by_file(pre)
    assert sorted(a) == sorted(b)
    for fn in a:
        assert rel(a[fn][0], b[fn][0]) <= 1e-9
        assert rel(a[fn][1], b[fn][1]) <= 1e-9


@pytest.mark.parametrize("kind,mode", [("linear", "cached"),
                                       ("quadratic", "precompute"),
                                       ("chem", "precompute")])
def test_dgrad_auto_resolves_as_jax(tmp_path, capsys, kind, mode):
    """`auto` picks the mode the JAX package picks (and says so): cached
    where the analytic kit exists, precompute for quadraticflag and
    chemflag (twojmax 2, four cells)."""
    write_ta(tmp_path / "JSON", 43)
    s = ta_nn_settings(tmp_path / "JSON")
    s["GROUPS"]["Super"] = "0.0 0.0 1.0 1.0 1e-4"     # the 2-atom cells
    s["BISPECTRUM"]["twojmax"] = 2
    s["PYTORCH"].update(dgrad_mode="auto", layer_sizes="num_desc 4 1")
    if kind == "quadratic":
        s["BISPECTRUM"]["quadraticflag"] = 1
    if kind == "chem":
        s["BISPECTRUM"].update(chemflag=1, numTypes=1)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        port = FitSnap(s, arglist=["--overwrite"], device="cpu")
        port.scrape_configs()
        port.process_configs()
        jfs = JaxFitSnap(s, arglist=["--overwrite"])
        jfs.scrape_configs()
        jfs.process_configs()
    finally:
        os.chdir(cwd)
    assert f"dgrad_mode=auto -> {mode}" in capsys.readouterr().out
    assert port.solver.cached == jfs.solver.cached == (mode == "cached")
    assert not jfs.solver.otf


def test_cli_cached_fit_on_cpu(tmp_path):
    write_ta(tmp_path / "JSON", 47)
    s = cached_settings(tmp_path / "JSON")
    s["PYTORCH"]["num_epochs"] = 2
    synthetic.write_ini(tmp_path / "nn.in", s)
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "nn.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for name in ("Ta_nn.pt", "Ta_nn_pot.mliap.descriptor", "Ta_nn_pot.mod",
                 "Ta_nn_metrics.md", "loss_vs_epochs.dat"):
        assert (tmp_path / name).stat().st_size > 0, name
