"""fitsnap_tpu_torch ACE against fitsnap_tpu (CPU, float64).

Two plans: the one of `tests/test_ace.py` (one element, ranks 1-4, nmax
3 2 2 1, lmax 1 2 2 2, lmin 0 1 1 1, nmaxbase 3) and a two-element plan
(ranks 1-3, nmax 3 2 1, lmax 0 2 2, lmin 0 0 1, nmaxbase 4) with per-bond
cutoffs and an inner cutoff on the mixed bonds.

- `build_ace_plan`: labels, a_index and the term tables t_fact, t_coef,
  t_label, t_mu0 and mmat exactly equal to the JAX plan's, for the
  minsub, pa_tabulated and native bases;
- the device functions (`chebexpcos_basis` in every variant, `sph_harm`,
  `ace_pair_phi`, `ace_a_basis`, `ace_b_and_dbda`,
  `ace_descriptors_with_jacobian`, i.e. the plain versions of K13 and
  K14 and views of them) on identical seeded inputs of 8 atoms x 24
  neighbor slots, with masked pairs, an empty atom, pairs past the cutoff and inside the inner
  ramp, and an atom's own periodic image, the JAX plan carried across
  through `convert.ace_plan_from_numpy`: within 1e-12 relative to each
  array's largest magnitude (the packages sum in other orders);
- the tables that K14 reads (`kernel_tables`: terms, entries and their
  contributions per label, labels per element), with its per-term
  cofactors emulated in numpy, give the dense dB/dA, B and dB/dD of the
  plain version to 1e-12;
- K7's plain version in the ACE layout (nelem 2 leading constant columns)
  through `parallel.fit.config_normal_contrib(kernel=ace_kernel(plan),
  const_mode=("ace", 2))` against JAX's, direct and residual: AtA and Atb
  within 1e-12 relative, nrows exact;
- on CPU tensors the kernel wrappers run their plain versions and count
  no launch.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.ops import ace as jace
from fitsnap_tpu.ops import refpot as jrefpot
from fitsnap_tpu.parallel import fit as jfit
from fitsnap_tpu_torch.convert import ACE_PLAN_FIELDS, ace_plan_from_numpy
from fitsnap_tpu_torch.kernels import ace_kernels as ak
from fitsnap_tpu_torch.ops import ace, neighbors, refpot
from fitsnap_tpu_torch.parallel import fit
from fitsnap_tpu_torch.tools import synthetic

RTOL = 1e-12
PLANS = {
    "one": dict(numtypes=1, ranks=[1, 2, 3, 4], nmax=[3, 2, 2, 1],
                lmax=[1, 2, 2, 2], lmin=[0, 1, 1, 1], nmaxbase=3,
                rcutfac=[4.5], lmbda=[3.0], rcinner=[0.0],
                drcinner=[0.01]),
    "two": dict(numtypes=2, ranks=[1, 2, 3], nmax=[3, 2, 1],
                lmax=[0, 2, 2], lmin=[0, 0, 1], nmaxbase=4,
                rcutfac=[4.5, 4.2, 4.2, 4.0], lmbda=[3.0, 2.8, 2.8, 2.5],
                rcinner=[0.0, 1.2, 1.2, 0.0],
                drcinner=[0.01, 0.3, 0.3, 0.01]),
}
FLAGS = {"energy": True, "force": True, "stress": True}


def section(name, basis="minsub"):
    return SimpleNamespace(b_basis=basis, **PLANS[name])


def rel(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def cases():
    """{plan name: (JAX plan, port plan, numpy inputs)}."""
    out = {}
    for name in PLANS:
        jplan = jace.build_ace_plan(section(name))
        plan = ace_plan_from_numpy({k: getattr(jplan, k)
                                    for k in ACE_PLAN_FIELDS})
        nt = PLANS[name]["numtypes"]
        rng = np.random.default_rng(5)
        A, K = 8, 24
        d = rng.normal(size=(A, K, 3))
        d *= rng.uniform(0.8, 5.0, (A, K, 1)) / np.linalg.norm(
            d, axis=-1, keepdims=True)
        ielem = rng.integers(0, nt, A)
        jelem = rng.integers(0, nt, (A, K))
        d[0, 1] = [3.3, 0.0, 0.0]          # atom 0's own periodic image
        jelem[0, 1] = ielem[0]
        mask = rng.uniform(size=(A, K)) < 0.85
        mask[0, 1] = True
        mask[-1] = False                   # an atom with no neighbor
        out[name] = (jplan, plan, (d, jelem, mask, ielem))
    r = np.linalg.norm(out["two"][2][0], axis=-1)
    assert ((r > 0.9) & (r < 1.2)).any() and (r > 4.5).any()
    return out


def both(fn_port, fn_jax, inputs):
    """Outputs of the port on tensors and of JAX on arrays, as numpy."""
    d, jelem, mask, ielem = inputs
    port = fn_port(t(d), t(jelem, torch.int32), t(mask),
                   t(ielem, torch.int32))
    ref = fn_jax(jnp.asarray(d), jnp.asarray(jelem), jnp.asarray(mask),
                 jnp.asarray(ielem))
    return [x.numpy() for x in port], [np.asarray(x) for x in ref]


@pytest.mark.parametrize("basis", ["minsub", "pa_tabulated", "native"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_equals_jax(name, basis):
    plan = ace.build_ace_plan(section(name, basis))
    jplan = jace.build_ace_plan(section(name, basis))
    assert plan.labels == jplan.labels and len(plan.labels) > 10
    assert plan.a_index == jplan.a_index and plan.nA == jplan.nA
    for key in ("t_fact", "t_coef", "t_label", "t_mu0", "mmat", "rcut",
                "lmbda", "rcinner", "drcinner"):
        np.testing.assert_array_equal(getattr(plan, key),
                                      getattr(jplan, key), err_msg=key)
    assert plan.rank_max == jplan.rank_max
    assert plan.spline_delta is None
    assert ace.plan_terms(plan) == jace.plan_terms(jplan)


@pytest.mark.parametrize("variant", ["v0", "pace_x", "v0_t1", "pace_x_t1",
                                     "pace_px", "pace_mx"])
def test_chebexpcos_matches_jax(variant):
    rng = np.random.default_rng(1)
    r = rng.uniform(0.1, 5.5, 200)
    rc = rng.uniform(4.0, 5.0, 200)
    port = ace.chebexpcos_basis(t(r), t(rc), 3.06, 22, variant)
    ref = jace.chebexpcos_basis(jnp.asarray(r), jnp.asarray(rc), 3.06, 22,
                                variant)
    assert (r > rc).any() and np.abs(np.asarray(ref)).max() > 0.1
    assert rel(port, ref) <= RTOL


def test_sph_harm_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=1)[:, None]
    yr, yi = ace.sph_harm(t(v), 4)
    jr, ji = jace.sph_harm(jnp.asarray(v), 4)
    for a, b in zip(yr + yi, jr + ji):
        assert rel(a, b) <= RTOL


@pytest.mark.parametrize("name", sorted(PLANS))
def test_pair_phi_and_a_basis_match_jax(cases, name):
    jplan, plan, inputs = cases[name]
    for fn, jfn in ((ace.ace_pair_phi, jace.ace_pair_phi),
                    (ace.ace_a_basis, jace.ace_a_basis)):
        port, ref = both(lambda *a: fn(*a, plan), lambda *a: jfn(*a, jplan),
                         inputs)
        for a, b in zip(port, ref):
            assert rel(a, b) <= RTOL
    phr, phi = ace.ace_pair_phi(*(t(x) for x in inputs), plan)
    dead = ~t(inputs[2])
    assert (phr[dead] == 0).all() and (phi[dead] == 0).all()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_b_and_dbda_match_jax(cases, name):
    jplan, plan, inputs = cases[name]
    Ar, Ai = jace.ace_a_basis(*(jnp.asarray(x) for x in inputs), jplan)
    Ar, Ai = np.asarray(Ar), np.asarray(Ai)
    B, dBdA = ace.ace_b_and_dbda(t(Ar), t(Ai), plan)
    jB, jdBdA = jace.ace_b_and_dbda(jnp.asarray(Ar), jnp.asarray(Ai), jplan)
    assert rel(B, jB) <= RTOL and rel(dBdA, jdBdA) <= RTOL


@pytest.mark.parametrize("name", sorted(PLANS))
def test_descriptors_with_jacobian_match_jax(cases, name):
    """The wrapper path on CPU tensors (plain versions, no launch) and
    `plain=True` both equal the JAX function, whose J is `jax.jvp`."""
    jplan, plan, inputs = cases[name]
    ak.reset_launches()
    for plain in (False, True):
        port, ref = both(
            lambda *a: ace.ace_descriptors_with_jacobian(*a, plan,
                                                         plain=plain),
            lambda *a: jace.ace_descriptors_with_jacobian(*a, jplan),
            inputs)
        assert port[0].shape == (8, len(plan.labels))
        assert port[1].shape == (8, len(plan.labels), 24, 3)
        assert rel(port[0], ref[0]) <= RTOL
        assert rel(port[1], ref[1]) <= RTOL
    assert set(ak.launches().values()) == {0}
    mu0 = np.asarray(plan.t_mu0)
    dead = mu0[None, :] != inputs[3][:, None]
    assert dead.any() == (PLANS[name]["numtypes"] > 1)
    assert (port[0][dead] == 0).all() and (port[1][dead] == 0).all()


@pytest.mark.parametrize("radial,ylm", [("pace_mx", "std"),
                                        ("v0_t1", "racah"),
                                        ("pace_x", "4pi")])
def test_other_conventions_match_jax(cases, radial, ylm):
    """The plain versions keep the conventions the kernels refuse: the
    closed-form tangents equal `jax.jvp`'s for them too."""
    jplan, plan, inputs = cases["two"]
    plan = ace_plan_from_numpy(dict({k: getattr(plan, k)
                                     for k in ACE_PLAN_FIELDS},
                                    radial=radial, ylm=ylm))
    jplan = jace.AcePlan(**dict(jplan.__dict__, radial=radial, ylm=ylm))
    port, ref = both(
        lambda *a: ace.ace_descriptors_with_jacobian(*a, plan),
        lambda *a: jace.ace_descriptors_with_jacobian(*a, jplan), inputs)
    assert rel(port[0], ref[0]) <= RTOL and rel(port[1], ref[1]) <= RTOL
    with pytest.raises(NotImplementedError, match="radial="):
        ak._kernel_conventions(plan)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_kernel_tables_give_dense_dbda(cases, name):
    """K14's dense dB/dA rows, emulated in numpy as the kernel forms them
    from `kernel_tables` (each term's prefix and suffix products once,
    coef x each factor's cofactor; then each entry the sum of its (term,
    factor) contributions, written at its label's row and A-slot), equal
    the plain dense dB/dA on every slot but the padding slot 0, where the
    tangents are zero, and the terms' values summed per label equal B;
    `el_l` gives the labels of each central element."""
    _, plan, inputs = cases[name]
    A, Jp = ak.ace_pair_basis_plain(*(t(x) for x in inputs), plan)
    assert (Jp[..., 0] == 0).all() and (Jp[..., plan.nA] == 0).all()
    B, dBdA = ace.ace_b_and_dbda(A[:, :plan.nA], A[:, plan.nA:], plan)
    tabs = ak.kernel_tables(plan)
    nA, R = plan.nA, plan.rank_max
    a = A.numpy()
    z = a[:, :nA] + 1j * a[:, nA:]
    fact, coef = np.asarray(plan.t_fact), np.asarray(plan.t_coef)
    f = z[:, fact]                                   # (atoms, terms, R)
    ones = np.ones(f.shape[:2] + (1,))
    pre = np.cumprod(np.concatenate([ones, f], 2), axis=2)
    suf = np.cumprod(np.concatenate([f, ones], 2)[:, :, ::-1],
                     axis=2)[:, :, ::-1]
    cof = (coef[:, None] * pre[:, :, :R] * suf[:, :, 1:]).reshape(len(z),
                                                                  -1)
    dense = np.zeros(dBdA.shape)
    for e in range(tabs.nE):
        li, s = tabs.e_lab[e], tabs.e_slot[e]
        assert tabs.lab_e[li] <= e < tabs.lab_e[li + 1]
        q = tabs.c_tr[tabs.e_c[e]:tabs.e_c[e + 1]]
        assert (fact.ravel()[q] == s).all() and (np.diff(q) > 0).all()
        tot = cof[:, q].sum(axis=1)
        dense[:, li, s] = tot.real
        dense[:, li, nA + s] = -tot.imag
    ref = dBdA.numpy().copy()
    ref[..., 0] = ref[..., nA] = 0.0
    assert rel(dense, ref) <= RTOL
    val = (coef * pre[:, :, R]).real
    bsum = np.stack([val[:, tabs.lab_t[li]:tabs.lab_t[li + 1]].sum(1)
                     for li in range(len(plan.labels))], 1)
    assert rel(bsum, B) <= RTOL
    assert tabs.lab_t[-1] == len(coef) and tabs.nC <= len(coef) * R
    assert tabs.nE == tabs.lab_e[-1]
    mu0 = np.asarray(plan.t_mu0)
    assert tabs.el_l[0] == 0 and tabs.el_l[-1] == len(plan.labels)
    for e in range(plan.numtypes):
        assert (mu0[tabs.el_l[e]:tabs.el_l[e + 1]] == e).all()
    _, dBdD = ak.ace_b_dbdd_plain(A, Jp, t(inputs[3]), plan)
    live = mu0[None, :] == inputs[3][:, None]
    emu = np.einsum("alp,cakp->alkc", dense, Jp.numpy()) \
        * live[:, :, None, None]
    assert rel(emu, dBdD) <= RTOL


def two_element_configs():
    """Two small two-element cells (a 2-atom cell whose atoms meet their
    own images, a 9-atom cell) with seeded truths and weights."""
    rng = np.random.default_rng(9)
    small = (rng.uniform(0, 3.2, (2, 3)), np.diag([3.2, 3.3, 3.1]))
    out = []
    for pos, rows in (small, synthetic.liquid(rng, 9, 0.045, 1.7)):
        na, cell = len(pos), rows.T
        types = np.arange(na, dtype=np.int32) % 2
        st = rng.normal(size=(3, 3))
        out.append(SimpleNamespace(
            pos=pos, cell=cell, natoms=na, types=types,
            energy=float(rng.normal()), forces=rng.normal(size=(na, 3)),
            stress6=(st + st.T)[[0, 1, 2, 1, 0, 0], [0, 1, 2, 2, 2, 1]]))
    return out


@pytest.mark.parametrize("mode", ["direct", "residual"])
def test_k7_ace_layout_matches_jax(cases, mode):
    jplan, plan, _ = cases["two"]
    decl = SimpleNamespace(lmp_pairdecl=[
        "pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8",
        "pair_coeff * * zero", "pair_coeff 1 1 zbl 73 73",
        "pair_coeff 1 2 zbl 73 41", "pair_coeff 2 2 zbl 41 41"])
    spec, jspec = (refpot.parse_reference(decl, 2),
                   jrefpot.parse_reference(decl, 2))
    W = len(plan.labels) + 2
    coeff = np.random.default_rng(3).normal(size=W) \
        if mode == "residual" else None
    for cfg in two_element_configs():
        disp, jidx, mask, kc = neighbors.host_neighbors(
            cfg.pos, cfg.cell, cfg.natoms, 4.8)
        na = cfg.natoms
        truths = (cfg.energy, cfg.forces, cfg.stress6, 2.0, 0.5, 1e-3)
        port = fit.config_normal_contrib(
            t(disp)[None], t(jidx)[None], t(mask)[None], t(cfg.types)[None],
            t([na], torch.int32), t(cfg.cell)[None],
            *(t(np.asarray(x, np.float64))[None] for x in truths),
            params=None, numtypes=2, flags=FLAGS, refspec=spec,
            coeff=None if coeff is None else t(coeff),
            with_ata=coeff is None, kernel=fit.ace_kernel(plan),
            const_mode=("ace", 2))
        ref = jfit.config_normal_contrib(
            jnp.asarray(disp), jnp.asarray(jidx), jnp.asarray(mask),
            jnp.asarray(cfg.types), jnp.asarray(na), jnp.asarray(cfg.cell),
            *(jnp.asarray(x) for x in truths), params=None, numtypes=2,
            flags=FLAGS, refspec=jspec,
            coeff=None if coeff is None else jnp.asarray(coeff),
            with_ata=coeff is None, accum_dtype=jnp.float64,
            kernel=jfit.ace_kernel(jplan), const_mode=("ace", 2))
        assert port[1].shape == (W,)
        if coeff is None:
            assert rel(port[0], ref[0]) <= RTOL
        assert rel(port[1], ref[1]) <= RTOL
        assert float(port[2]) == float(ref[2]) == 1 + 3 * na + 6


def test_wrappers_take_plain_version_on_cpu_and_refuse_meta(cases):
    _, plan, inputs = cases["two"]
    args = [t(x) for x in inputs]
    args[1], args[3] = args[1].int(), args[3].int()
    ak.reset_launches()
    A, Jp = ak.ace_pair_basis(*args, plan)
    ref = ak.ace_pair_basis_plain(*args, plan)
    assert torch.equal(A, ref[0]) and torch.equal(Jp, ref[1])
    out = ak.ace_b_dbdd(A, Jp, args[3], plan)
    ref = ak.ace_b_dbdd_plain(A, Jp, args[3], plan)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert ak.launches() == {"ace_pair_basis": 0, "ace_b_dbdd": 0}
    with pytest.raises(ValueError, match="no kernel for device"):
        ak.ace_pair_basis(*(x.to("meta") for x in args), plan)
    with pytest.raises(ValueError, match="no kernel for device"):
        ak.ace_b_dbdd(A.to("meta"), Jp.to("meta"), args[3].to("meta"), plan)
