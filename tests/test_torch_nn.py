"""The NN solver's modules in fitsnap_tpu_torch against fitsnap_tpu (CPU,
float64), in the precompute mode.

A small Ta set (four 2-atom and three 16-atom jittered bcc cells, twojmax
4, 14 descriptors) goes through both packages' `prepare_dataset`; the
inputs of every other check are made from a seed with numpy and handed to
both.  Checks, with their tolerances:

- the shape buckets: `coalesce_shape_buckets` on seeded shape maps, and
  the configs of every prepared bucket, exactly;
- nn-prep: B, G = dB/dD, the energy and force targets and the descriptor
  standardization within 1e-12 (relative to the largest magnitude), also
  with chemflag (two elements) and quadraticflag at twojmax 2;
- the MLP: per-atom energies and dE/dx against `atom_energies` and
  `jax.grad`, one element and two (per-element routing), 1e-12, with the
  weights carried across by `convert.mlp_params_from_numpy` (and back by
  `mlp_params_to_numpy`, exactly);
- the exported ML-IAP module's energies and betas against the JAX MLP
  with pre-activations above softplus's threshold of 20, 1e-12;
- K12's and K12T's plain versions against `_forward_batch`'s forces and
  `jax.vjp` of its force lines, 1e-12;
- `_loss` and its parameter gradient (through `NnForce`) against
  `jax.value_and_grad` of the JAX `_loss`, 1e-12;
- one Adam step against optax's `scale_by_adam` with the learning rate
  applied outside it, 1e-14; the plateau scheduler against the JAX one,
  exactly;
- nonlinear ACE builds (PAS, which raised here before, is held to the JAX
  package by tests/test_torch_pas.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fitsnap_tpu.calculators.snap as jsnap
import fitsnap_tpu.solvers.network as jnet
from fitsnap_tpu.config import Config as JaxConfig
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.models.mlp import atom_energies as jax_atom_energies
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.calculators import snap as tsnap
from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.convert import (mlp_params_from_numpy,
                                       mlp_params_to_numpy)
from fitsnap_tpu_torch.io.export_torch import (Elementwise, MliapWrapper,
                                               build_torch_model)
from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.models.mlp import PerElementMLP, atom_energies
from fitsnap_tpu_torch.solvers import network as tnet
from fitsnap_tpu_torch.tools import synthetic

GROUPS = {"Small": "0.75 0.25 1.0 1.0 1e-4", "Super": "1.0 0.0 1.0 1.0 1e-4"}


def rel(port, ref):
    port = np.asarray(port.detach() if torch.is_tensor(port) else port,
                      np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def write_ta(root, seed):
    rng = np.random.default_rng(seed)
    for group, reps, n in (("Small", (1, 1, 1), 4), ("Super", (2, 2, 2), 3)):
        (root / group).mkdir(parents=True)
        for i in range(n):
            pos, cell = synthetic.supercell(
                synthetic.BCC, rng.uniform(3.15, 3.45), reps)
            pos = pos + rng.normal(0.0, 0.1, pos.shape)
            na = len(pos)
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=rng.normal(-10.0 * na, 1.0),
                    forces=rng.normal(0.0, 0.5, (na, 3))))


def ta_nn_settings(root):
    s = synthetic.nn_settings(root, groups=[])
    s["GROUPS"].update(GROUPS)
    s["BISPECTRUM"]["twojmax"] = 4
    s["PYTORCH"]["layer_sizes"] = "num_desc 8 8 1"
    return s


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both packages' prepare_dataset on the Ta set."""
    root = tmp_path_factory.mktemp("nn_prep")
    write_ta(root / "JSON", 41)
    s = ta_nn_settings(root / "JSON")
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
    return port.solver, jfs.solver


def test_coalesce_shape_buckets_equal_jax():
    rng = np.random.default_rng(3)
    for trial in range(20):
        shapes = {(int(a), int(k)): sorted(rng.choice(50, rng.integers(1, 6),
                                                      replace=False).tolist())
                  for a, k in zip(rng.choice(jsnap._A_BUCKETS, 7),
                                  rng.choice(jsnap._K_BUCKETS, 7))}
        assert tsnap.coalesce_shape_buckets(shapes) \
            == jsnap.coalesce_shape_buckets(shapes, 4)
    assert tsnap.NN_PROGRAMS == 4


def test_prepared_buckets_equal_jax(prepared):
    port, jsol = prepared
    assert len(port.buckets) == len(jsol.buckets) >= 2
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert pb["shape"] == jb["shape"]
        assert pb["groups"] == jb["groups"] and pb["files"] == jb["files"]
        np.testing.assert_array_equal(pb["test"], jb["test"])
        np.testing.assert_array_equal(pb["nat_host"], jb["nat"])


@pytest.mark.parametrize("key", ["B", "G", "e_target", "f_target", "jidx",
                                 "ew", "fw", "real"])
def test_nn_prep_equals_jax(prepared, key):
    port, jsol = prepared
    for pb, jb in zip(port.buckets, jsol.buckets):
        assert rel(pb[key], np.asarray(jb[key])) <= 1e-12, key


def test_standardization_equals_jax(prepared):
    port, jsol = prepared
    assert rel(port.mean, np.asarray(jsol.mean)) <= 1e-12
    assert rel(port.std, np.asarray(jsol.std)) <= 1e-12


def test_rev_lists_every_neighbor_slot(prepared):
    """Each listed pair slot a*K + k appears once, in the row of its
    neighbor atom jidx[a, k]; G is zero on every slot it does not list."""
    port, _ = prepared
    for pb in port.buckets:
        rev, jidx, G = pb["rev"].numpy(), pb["jidx"].numpy(), pb["G"].numpy()
        N, A, K = jidx.shape
        for n in range(N):
            listed = np.zeros(A * K, bool)
            for m in range(A):
                for slot in rev[n, m][rev[n, m] >= 0]:
                    assert jidx[n, slot // K, slot % K] == m
                    assert not listed[slot]
                    listed[slot] = True
            gz = np.abs(G[n]).sum((1, 3)).reshape(-1) > 0
            assert not (gz & ~listed).any()


@pytest.mark.parametrize("kind", ["chemflag", "quadraticflag"])
def test_nn_prep_flags_equal_jax(tmp_path, kind):
    """nn-prep with chemflag (two elements, InP-shaped cells) and
    quadraticflag (Ta cells), twojmax 2, against `nn_prep_fn`."""
    if kind == "chemflag":
        s = synthetic.inp_settings(tmp_path, groups=[])
        s["BISPECTRUM"]["twojmax"] = "2 2"
        confs = synthetic.inp_configs(5, {"Volume_ZB": 1, "Strain_ZB": 2})
        data = [(p, c, n) for cs in confs.values() for p, c, n in cs]
    else:
        s = synthetic.quadratic_settings(tmp_path, groups=[])
        s["BISPECTRUM"]["twojmax"] = 2
        confs = synthetic.ta_configs(5, {"Volume_BCC": 2, "Elastic_BCC": 1})
        data = [(p, c, ["Ta"] * len(p)) for cs in confs.values()
                for p, c in cs]
    s["CALCULATOR"]["nonlinear"] = 1
    s["SOLVER"] = {"solver": "PYTORCH"}
    s["PYTORCH"] = {"dgrad_mode": "precompute"}
    # jittered, so that the reference forces are not zero by symmetry
    rng = np.random.default_rng(6)
    dicts = [{"Positions": p + rng.normal(0.0, 0.05, p.shape),
              "Lattice": c, "AtomTypes": n,
              "NumAtoms": len(p), "Energy": 0.0, "Forces": np.zeros((len(p), 3)),
              "Group": "g", "File": f"{i}", "test_bool": 0}
             for i, (p, c, n) in enumerate(data)]
    tcalc = tsnap.SnapCalculator("LAMMPSSNAP",
                                 Config(s, ["--overwrite"]), "cpu")
    jcalc = jsnap.SnapCalculator("LAMMPSSNAP", JaxConfig(s, ["--overwrite"]))
    packed, buckets = tcalc.host_preprocess(dicts)
    # one covering shape: one JAX compile
    buckets = jsnap.coalesce_shape_buckets(buckets, 1)
    prep = jax.vmap(jcalc.nn_prep_fn())
    for (a_pad, k_pad), idxs in buckets.items():
        arrays = tsnap.pack_bucket(packed, idxs, a_pad, k_pad)
        disp, jidx, mask, rev, types, nat, _ = arrays
        out = tcalc.nn_prep(*[torch.from_numpy(x) for x in arrays[:6]])
        ref = prep(jnp.asarray(disp), jnp.asarray(jidx), jnp.asarray(mask),
                   jnp.asarray(types), jnp.asarray(nat, jnp.int32))
        assert out[0].shape[-1] == tcalc.desc_width() \
            == jcalc.get_width()
        for o, r in zip(out, ref):
            assert rel(o, np.asarray(r)) <= 1e-12


# ---------------------------------------------------------------------------
# the MLP, K12 / K12T, the loss
# ---------------------------------------------------------------------------


def seeded_params(sizes, nelem, seed, last_zero=False):
    rng = np.random.default_rng(seed)
    out = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = rng.normal(size=(nelem, a, b)) * np.sqrt(2.0 / a)
        if last_zero and i == len(sizes) - 2:
            w = np.zeros_like(w)
        out.append((w, rng.normal(0.0, 0.1, (nelem, b))))
    return out


def as_torch(params):
    return [(torch.tensor(w), torch.tensor(b)) for w, b in params]


def as_jax(params):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]


@pytest.mark.parametrize("nelem", [1, 2])
def test_mlp_energies_and_gradient_equal_jax(nelem):
    rng = np.random.default_rng(7 + nelem)
    params = seeded_params([6, 5, 4, 1], nelem, 11)
    x = rng.normal(size=(3, 9, 6)) * 3.0
    elem = rng.integers(0, nelem, (3, 9)).astype(np.int32)
    xt = torch.tensor(x, requires_grad=True)
    # the JAX package's parameters carried across as numpy arrays
    tp = mlp_params_from_numpy([(np.asarray(w), np.asarray(b))
                                for w, b in as_jax(params)])
    for (w, b), (w0, b0) in zip(mlp_params_to_numpy(tp), params):
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(b, b0)
    e = atom_energies(tp, xt, torch.from_numpy(elem))
    dedx, = torch.autograd.grad(e.sum(), xt)
    ref = jax_atom_energies(as_jax(params), jnp.asarray(x), jnp.asarray(elem))
    gref = jax.grad(lambda xx: jnp.sum(jax_atom_energies(
        as_jax(params), xx, jnp.asarray(elem))))(jnp.asarray(x))
    assert rel(e, np.asarray(ref)) <= 1e-12
    assert rel(dedx, np.asarray(gref)) <= 1e-12


@pytest.mark.parametrize("nelem", [1, 2])
def test_exported_module_equals_jax_mlp_above_softplus_threshold(nelem):
    """The exported ML-IAP module's energies and betas against the JAX
    `atom_energies` on standardized descriptors, with first-layer
    pre-activations between 20 and 30 (where `torch.nn.Softplus` would be
    the identity), 1e-12."""
    rng = np.random.default_rng(41 + nelem)
    params = seeded_params([6, 5, 4, 1], nelem, 43)
    params[0] = (params[0][0] * 0.1, params[0][1] + 25.0)
    nat = 9
    desc = rng.normal(size=(nat, 6))
    mean, std = rng.normal(size=6), rng.uniform(0.5, 2.0, 6)
    elem = rng.integers(0, nelem, nat).astype(np.int32)
    module = MliapWrapper(Elementwise(build_torch_model(params, mean, std)),
                          6, nelem)
    beta, energy = np.zeros_like(desc), np.zeros(nat)
    module(elem, desc.copy(), beta, energy)

    def e_jax(d):
        return jax_atom_energies(as_jax(params), (d - mean) / std,
                                 jnp.asarray(elem))
    w0, b0 = params[0]
    h = np.einsum("ai,aio->ao", (desc - mean) / std, w0[elem]) + b0[elem]
    assert 20.0 < h.min() and h.max() < 30.0
    ref = e_jax(jnp.asarray(desc))
    assert rel(torch.from_numpy(energy), np.asarray(ref)) <= 1e-12
    gref = jax.grad(lambda d: jnp.sum(e_jax(d)))(jnp.asarray(desc))
    assert rel(torch.from_numpy(beta), np.asarray(gref)) <= 1e-12


def jax_force_lines(dEdB, G, jidx):
    """The force lines of the JAX `_forward_batch` (network.py:737-741)."""
    fpair = jnp.einsum("naw,nawkc->nakc", dEdB, G)
    oj = jax.nn.one_hot(jidx, G.shape[1], dtype=G.dtype)
    scat = jnp.einsum("nakm,nakc->nmc", oj, fpair)
    return -(scat - fpair.sum(axis=2))


def bucket_batch(port, bi, idx):
    pb = port.buckets[bi]
    return port._gather(pb, idx)


def test_k12_plain_equals_forward_batch_forces(prepared):
    port, jsol = prepared
    rng = np.random.default_rng(13)
    for bi, jb in enumerate(jsol.buckets):
        idx = np.arange(len(jb["groups"]))
        batch = bucket_batch(port, bi, idx)
        N, A, W = batch["B"].shape
        dEdB = rng.normal(size=(N, A, W))
        out = nk.nn_force_plain(torch.from_numpy(dEdB), batch["G"],
                                batch["jidx"], batch["rev"])
        ref = jax_force_lines(jnp.asarray(dEdB), jnp.asarray(jb["G"]),
                              jnp.asarray(jb["jidx"]))
        assert rel(out, np.asarray(ref)) <= 1e-12
        gF = rng.normal(size=(N, A, 3))
        _, vjp = jax.vjp(lambda d: jax_force_lines(
            d, jnp.asarray(jb["G"]), jnp.asarray(jb["jidx"])),
            jnp.asarray(dEdB))
        t_out = nk.nn_force_t_plain(torch.from_numpy(gF), batch["G"],
                                    batch["jidx"])
        assert rel(t_out, np.asarray(vjp(jnp.asarray(gF))[0])) <= 1e-12


def test_forward_batch_equals_jax(prepared):
    """Energies and forces of `_forward_batch` on one minibatch."""
    port, jsol = prepared
    params = seeded_params([14, 8, 8, 1], 1, 17)
    port.mean = torch.tensor(np.asarray(jsol.mean))
    port.std = torch.tensor(np.asarray(jsol.std))
    bi = int(np.argmax([len(b["groups"]) for b in jsol.buckets]))
    idx = np.array([2, 0, 1])
    batch = bucket_batch(port, bi, idx)
    jb = {k: jnp.asarray(np.asarray(v)[idx])
          for k, v in jsol.buckets[bi].items()
          if k in jnet.NetworkSolver._BATCH_KEYS}
    e, f = port._forward_batch(PerElementMLP(as_torch(params)), batch)
    je, jf = jsol._forward_batch(as_jax(params), jb)
    assert rel(e, np.asarray(je)) <= 1e-12
    assert rel(f, np.asarray(jf)) <= 1e-12


@pytest.mark.parametrize("weights,nelem", [("global", 1), ("per_config", 1),
                                           ("global", 2)])
def test_loss_and_gradient_equal_jax(prepared, weights, nelem):
    """The loss and its gradient with respect to every MLP parameter: the
    port's runs through NnForce (K12T's plain version in the backward).
    With two elements the atoms get seeded element indices, so the double
    backward runs through the per-element routing."""
    port, jsol = prepared
    params = seeded_params([14, 8, 8, 1], nelem, 19)
    rng = np.random.default_rng(37)
    port.mean = torch.tensor(np.asarray(jsol.mean))
    port.std = torch.tensor(np.asarray(jsol.std))
    net = port.net
    old = (net.global_weight_bool, jsol.net.global_weight_bool)
    try:
        flag = weights == "global"
        net.global_weight_bool = jsol.net.global_weight_bool = flag
        for bi in range(len(jsol.buckets)):
            idx = np.arange(min(3, len(jsol.buckets[bi]["groups"])))
            batch = bucket_batch(port, bi, idx)
            elem = rng.integers(0, nelem, tuple(batch["types"].shape))
            batch["types"] = torch.tensor(elem, dtype=torch.int32)
            model = PerElementMLP(as_torch(params))
            loss = port._loss(model, batch, train=True)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            jb = {k: jnp.asarray(np.asarray(v)[idx])
                  for k, v in jsol.buckets[bi].items()
                  if k in jnet.NetworkSolver._BATCH_KEYS}
            jb["types"] = jnp.asarray(elem, jnp.int32)
            jl, jg = jax.value_and_grad(jsol._loss)(as_jax(params), jb)
            assert rel(loss, float(jl)) <= 1e-12
            for g, r in zip(grads, jax.tree.leaves(jg)):
                assert rel(g, np.asarray(r)) <= 1e-12
    finally:
        net.global_weight_bool, jsol.net.global_weight_bool = old


def test_adam_step_equals_optax():
    rng = np.random.default_rng(23)
    params = seeded_params([5, 4, 1], 2, 29)
    leaves = [torch.tensor(x) for wb in params for x in wb]
    opt = optax.scale_by_adam()
    jparams = as_jax(params)
    state = opt.init(jparams)
    adam = tnet.Adam(leaves)
    lr = 3e-3
    for step in range(3):
        grads = [rng.normal(size=x.shape) for x in leaves]
        adam.step(leaves, [torch.from_numpy(g) for g in grads], lr)
        jg = jax.tree.unflatten(jax.tree.structure(jparams),
                                [jnp.asarray(g) for g in grads])
        upd, state = opt.update(jg, state)
        upd = jax.tree.map(lambda u: -lr * u, upd)
        jparams = optax.apply_updates(jparams, upd)
        for t, r in zip(leaves, jax.tree.leaves(jparams)):
            assert rel(t, np.asarray(r)) <= 1e-14
    for t, r in zip(adam.leaves(), jax.tree.leaves(state)):
        assert np.shape(t) == np.shape(r)
        assert rel(t, np.asarray(r)) <= 1e-14


def test_plateau_step_equals_jax():
    rng = np.random.default_rng(31)
    metrics = np.concatenate([np.linspace(1.0, 0.9, 10),
                              np.full(30, 0.95)]) + rng.normal(0, 1e-5, 40)
    kw = dict(factor=0.5, patience=3, threshold=1e-4, lr_min=1e-5)
    port = jax_ = (1e-3, np.inf, 0)
    for m in metrics:
        port = tnet._plateau_step_host(port, float(m), **kw)
        jax_ = jnet._plateau_step_host(jax_, float(m), **kw)
        assert port == jax_
    assert port[0] < 1e-3


def test_modes_the_port_lacks_raise(tmp_path):
    """Nonlinear ACE builds its calculator and the NN solver (it and PAS,
    which raised here before, are held to the JAX package by
    tests/test_torch_ace_nn.py and tests/test_torch_pas.py)."""
    a = synthetic.ace_settings(tmp_path)
    a["CALCULATOR"]["nonlinear"] = 1
    a["SOLVER"] = {"solver": "PYTORCH"}
    a["PYTORCH"] = {}
    fs = FitSnap(a, arglist=["--overwrite"], device="cpu")
    assert type(fs.calculator).__name__ == "AceCalculator"
    assert type(fs.solver).__name__ == "NetworkSolver"
