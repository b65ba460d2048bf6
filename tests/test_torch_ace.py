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
  no launch;
- K13's host tables (`ylm_table`, `radial_code`, `k13_columns`), read by
  a numpy emulation of the kernel's arithmetic (its records, then A and Jp
  through the column table): Yhat and its gradient against the plain
  `_ylm_and_gradient` at lmax 8 in the '4pi', 'std' and 'racah'
  conventions, the radial code against `_radial_and_derivative` in all six
  variants, and the emulated A and Jp against the plain K13 at lmax 8 in
  four convention pairs and on the two-element plan, within 1e-12; its
  launch shape (`k13_shape`) fits a block or raises;
- a plan of lmax 8 (ranks 1-2, nmax 4 2, lmax 0 8, nmaxbase 4) on 6 atoms
  x 16 slots: descriptors and jacobian equal JAX's in four convention
  pairs (the default and the three others), 1e-12.
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
    """The plain versions keep every closed-form convention: the tangents
    equal `jax.jvp`'s for them too, and with spline radials in the same
    convention (tests/test_torch_ace_spline.py holds the rest of the spline
    mode).  The kernels take them all."""
    jplan, plan, inputs = cases["two"]
    for spline in (None, 0.001):
        p = ace_plan_from_numpy(dict({k: getattr(plan, k)
                                      for k in ACE_PLAN_FIELDS},
                                     radial=radial, ylm=ylm,
                                     spline_delta=spline))
        jp = jace.AcePlan(**dict(jplan.__dict__, radial=radial, ylm=ylm,
                                 spline_delta=spline))
        port, ref = both(
            lambda *a: ace.ace_descriptors_with_jacobian(*a, p),
            lambda *a: jace.ace_descriptors_with_jacobian(*a, jp), inputs)
        assert rel(port[0], ref[0]) <= RTOL and rel(port[1], ref[1]) <= RTOL
        assert (ak._device_tables(p, "cpu").spline is None) == \
            (spline is None)


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


# ---------------------------------------------------------------------------
# K13's host tables, through a numpy emulation of csrc/ace_pair_basis.cu
# ---------------------------------------------------------------------------

LMAX8 = dict(numtypes=1, ranks=[1, 2], nmax=[4, 2], lmax=[0, 8],
             lmin=[0, 0], nmaxbase=4, rcutfac=[4.5], lmbda=[3.0],
             rcinner=[0.0], drcinner=[0.01])
CONVENTIONS = [("pace_px", "4pi"), ("pace_mx", "std"), ("v0_t1", "racah"),
               ("pace_x", "4pi")]
VARIANTS = ["v0", "pace_x", "v0_t1", "pace_x_t1", "pace_px", "pace_mx"]


def with_conventions(plan, radial, ylm):
    return ace_plan_from_numpy(dict({k: getattr(plan, k)
                                     for k in ACE_PLAN_FIELDS},
                                    radial=radial, ylm=ylm))


@pytest.fixture(scope="module")
def lmax8():
    """(JAX plan, port plan, numpy inputs) of a plan of lmax 8 on 6 atoms x
    16 slots: masked slots, an atom with no neighbor, pairs past the
    cutoff, an atom's own periodic image."""
    sec = SimpleNamespace(b_basis="minsub", **LMAX8)
    jplan = jace.build_ace_plan(sec)
    plan = ace_plan_from_numpy({k: getattr(jplan, k)
                                for k in ACE_PLAN_FIELDS})
    assert plan.lmax == 8
    rng = np.random.default_rng(11)
    A, K = 6, 16
    d = rng.normal(size=(A, K, 3))
    d *= rng.uniform(0.8, 5.0, (A, K, 1)) / np.linalg.norm(d, axis=-1,
                                                          keepdims=True)
    d[0, 1] = [3.3, 0.0, 0.0]
    mask = rng.uniform(size=(A, K)) < 0.85
    mask[0, 1] = True
    mask[-1] = False
    inputs = (d, np.zeros((A, K), np.int64), mask, np.zeros(A, np.int64))
    assert (np.linalg.norm(d, axis=-1)[mask] > 4.5).any()
    return jplan, plan, inputs


def np_ylm(u, r, ytab, lmax):
    """The kernel's Legendre columns: (..., ne, 8) entries per (l, m >= 0)
    at l (l + 1) / 2 + m: Yhat re, im, gradient re (3), im (3)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    ne = (lmax + 1) * (lmax + 2) // 2
    norm, ca, cb = ytab
    out = np.zeros(u.shape[:-1] + (ne, 8))
    for m in range(lmax + 1):
        er, ei = np.ones_like(x), np.zeros_like(x)
        erm = eim = np.zeros_like(x)
        for _ in range(m):
            erm, eim = er, ei
            er, ei = er * x - ei * y, er * y + ei * x
        e = m * (m + 3) // 2
        p1, dp1 = np.full_like(x, ca[e]), np.zeros_like(x)
        p2 = dp2 = np.zeros_like(x)
        for l in range(m, lmax + 1):
            if l > m:
                pl = ca[e] * z * p1 - cb[e] * p2
                dpl = ca[e] * (p1 + z * dp1) - cb[e] * dp2
                p2, dp2, p1, dp1 = p1, dp1, pl, dpl
            pl, dpl = norm[e] * p1, norm[e] * dp1
            gr = [pl * m * erm, -pl * m * eim, dpl * er]
            gi = [pl * m * eim, pl * m * erm, dpl * ei]
            ur = x * gr[0] + y * gr[1] + z * gr[2]
            ui = x * gi[0] + y * gi[1] + z * gi[2]
            out[..., e, 0], out[..., e, 1] = pl * er, pl * ei
            for c, uc in enumerate((x, y, z)):
                out[..., e, 2 + c] = (gr[c] - uc * ur) / r
                out[..., e, 5 + c] = (gi[c] - uc * ui) / r
            e += l + 1
    return out


def np_radial(r, rc, lam, code, nrad, fin=1.0, dfin=0.0):
    """The kernel's radial item: g and dg/dr (..., nrad), zero at r >= rc."""
    x0 = r / rc
    den = np.exp(lam) - 1.0
    if code & 1:
        el = np.exp(lam * x0)
        dx = -2.0 * lam * el / den / rc
    else:
        el = np.exp(lam * (1.0 - x0))
        dx = 2.0 * lam * el / den / rc
    x = 1.0 - 2.0 * (el - 1.0) / den
    out_range = (x < -1.0) | (x > 1.0)
    x, dx = np.clip(x, -1.0, 1.0), np.where(out_range, 0.0, dx)
    if code & 2:
        x, dx = -x, -dx
    cz = 0.5 * (1.0 + np.cos(np.pi * x0))
    dcz = -0.5 * np.pi * np.sin(np.pi * x0) / rc
    pace = bool(code & 4)
    skip = 1 if (code & 8) and not pace else 0
    g = np.zeros(r.shape + (nrad,))
    dg = np.zeros_like(g)
    tm = dtm = np.zeros_like(r)
    tc, dtc = np.ones_like(r), np.zeros_like(r)
    for t_ in range(nrad + skip):
        if t_ == 1:
            tm, dtm, tc, dtc = tc, dtc, x, dx
        elif t_ > 1:
            tm, dtm, tc, dtc = (tc, dtc, 2.0 * x * tc - tm,
                                2.0 * dx * tc + 2.0 * x * dtc - dtm)
        if t_ < skip:
            continue
        if not pace:
            h, dh = tc, dtc
        elif t_ == 0:
            h, dh = np.ones_like(r), np.zeros_like(r)
        else:
            h, dh = 0.5 * (1.0 - tc), -0.5 * dtc
        g[..., t_ - skip] = h * cz * fin
        dg[..., t_ - skip] = (dh * cz + h * dcz) * fin + h * cz * dfin
    live = (r < rc)[..., None]
    return np.where(live, g, 0.0), np.where(live, dg, 0.0)


def emulate_k13(disp, jelem, mask, ielem, plan):
    """A (N, 2nA) and Jp (3, N, K, 2nA) as csrc/ace_pair_basis.cu forms
    them from `kernel_tables`: each neighbor's record (g, dg/dr, the unit
    vector and 1 / r, the Legendre columns' entries 9 doubles apart, the
    constant entry), then every Jp column through `k13_columns`, A the sum
    of phi over the neighbors."""
    tabs = ak.kernel_tables(plan)
    rl, y0, c0 = ak.k13_record(plan)
    nrad = plan.nradbase
    safe = np.where(mask[..., None], disp, [1.0, 0.0, 0.0])
    r = np.sqrt((safe * safe).sum(-1))
    u = safe / r[..., None]
    bond = (ielem[:, None], jelem)
    rc = np.asarray(plan.rcut)[bond]
    lam = np.asarray(plan.lmbda)[bond]
    fin, dfin = np.ones_like(r), np.zeros_like(r)
    if np.any(np.asarray(plan.rcinner) > 0.0):
        din = np.asarray(plan.drcinner)[bond]
        dsafe = np.maximum(din, 1e-12)
        tt = (r - (np.asarray(plan.rcinner)[bond] - din)) / dsafe
        fin = np.where(tt <= 0.0, 0.0, np.where(
            tt < 1.0, 0.5 * (1.0 - np.cos(np.pi * tt)), 1.0))
        dfin = np.where((tt > 0.0) & (tt < 1.0),
                        0.5 * np.pi * np.sin(np.pi * tt) / dsafe, 0.0)
    g, dg = np_radial(r, rc, lam, tabs.radial, nrad, fin, dfin)
    live = mask[..., None]
    rec = np.zeros(r.shape + (rl,))
    rec[..., :nrad] = np.where(live, g, 0.0)
    rec[..., nrad:2 * nrad] = np.where(live, dg, 0.0)
    rec[..., 2 * nrad:y0] = np.concatenate([u, 1.0 / r[..., None]], -1)
    ent = np.zeros(r.shape + ((c0 - y0) // 9, 9))
    ent[..., :8] = np_ylm(u, r, tabs.ytab, plan.lmax)
    rec[..., y0:c0] = ent.reshape(r.shape + (-1,))
    rec[..., c0] = 1.0
    yo, go, n1, w = tabs.cols.T.astype(np.int64)
    sg = np.where(w < 0, -1.0, 1.0)
    chan = (w != 0) & (jelem[..., None] == np.abs(w) - 1)
    base = np.where(chan, rec[..., n1], 0.0)
    dbase = np.where(chan, rec[..., nrad + n1], 0.0)
    yv = sg * rec[..., yo]
    Jp = np.stack([dbase * u[..., c, None] * yv + base * (sg * rec[..., go + c])
                   for c in range(3)])
    A = (base * yv).sum(1)
    A[:, 0] = 1.0
    return A, Jp


@pytest.mark.parametrize("ylm", ["4pi", "std", "racah"])
def test_k13_ylm_tables_match_plain(ylm):
    """Yhat and its gradient from `ylm_table` (the kernel's Legendre
    columns) equal the plain `_ylm_and_gradient` at lmax 8, with m < 0 by
    the column table's rule Y_{l,-m} = (-1)^m conj(Y_lm)."""
    lmax = 8
    rng = np.random.default_rng(4)
    v = rng.normal(size=(64, 3))
    r = rng.uniform(0.5, 5.0, 64)
    u = v / np.linalg.norm(v, axis=1)[:, None]
    ent = np_ylm(u, r, ak.ylm_table(lmax, ylm), lmax)
    yr, yi, dyr, dyi = (x.numpy() for x in ace._ylm_and_gradient(
        t(u), t(r), lmax, ylm))
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            e = ent[:, l * (l + 1) // 2 + abs(m)]
            s = 1.0 if m >= 0 else (-1.0) ** m
            ip = l * l + l + m
            assert rel(s * e[:, 0], yr[:, ip]) <= RTOL
            assert rel(s * e[:, 2:5].T, dyr[:, :, ip]) <= RTOL
            assert rel((s if m >= 0 else -s) * e[:, 1], yi[:, ip]) <= RTOL
            assert rel((s if m >= 0 else -s) * e[:, 5:8].T,
                       dyi[:, :, ip]) <= RTOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_k13_radial_code_matches_plain(variant):
    rng = np.random.default_rng(6)
    r = rng.uniform(0.1, 5.5, 300)
    rc = rng.uniform(4.0, 5.0, 300)
    lam = np.full(300, 3.06)
    g, dg = np_radial(r, rc, lam, ak.radial_code(variant), 22)
    ref = ace._radial_and_derivative(t(r), t(rc), t(lam), 22, variant)
    assert (r > rc).any() and np.abs(ref[0].numpy()).max() > 0.1
    assert rel(g, ref[0]) <= RTOL and rel(dg, ref[1]) <= RTOL


@pytest.mark.parametrize("conv", CONVENTIONS + [("two", None)])
def test_k13_emulation_matches_plain(cases, lmax8, conv):
    """A and Jp as the kernel forms them from its host tables equal the
    plain K13: at lmax 8 in four convention pairs, and on the two-element
    plan (per-bond cutoffs, the inner ramp); structurally zero columns
    exactly 0."""
    if conv[0] == "two":
        _, plan, inputs = cases["two"]
    else:
        _, plan, inputs = lmax8
        plan = with_conventions(plan, *conv)
    A, Jp = emulate_k13(*inputs, plan)
    ref = ak.ace_pair_basis_plain(*(t(x) for x in inputs), plan)
    assert rel(A, ref[0]) <= RTOL and rel(Jp, ref[1]) <= RTOL
    nA = plan.nA
    slot = ace.slot_table(plan)
    zero = [0, nA] + [nA + s for s, (_, _, l, m) in enumerate(slot)
                      if s and (l < 0 or m == 0)]
    assert (Jp[..., zero] == 0).all() and (Jp[:, ~inputs[2]] == 0).all()


def test_k13_shape_fits_and_raises(lmax8):
    """The launch shape's working set fits a block; a plan whose records
    cannot fit one warp's one-neighbor tile is refused."""
    _, plan, _ = lmax8
    warps, nw_log, rl, smem = ak.k13_shape(plan, 64)
    assert rl % 2 == 1 and (plan.lmax + 1) << nw_log <= 48 and nw_log == 2
    assert smem <= ak.kl.SMEM_LIMIT and warps == 8
    assert ak.k13_shape(plan, 10)[0] == 3 and ak.k13_shape(plan, 1)[0] == 1
    assert ak.k13_record(plan)[2] + 8 <= rl
    big = SimpleNamespace(lmax=80, nradbase=22, nA=600)
    with pytest.raises(ValueError, match="shared memory"):
        ak.k13_shape(big, 64)
    w, nl, _, sm = ak.k13_shape(SimpleNamespace(lmax=40, nradbase=22,
                                                nA=500), 64)
    assert sm <= ak.kl.SMEM_LIMIT and w < 8


@pytest.mark.parametrize("radial,ylm", CONVENTIONS)
def test_lmax8_descriptors_with_jacobian_match_jax(lmax8, radial, ylm):
    jplan, plan, inputs = lmax8
    plan = with_conventions(plan, radial, ylm)
    jplan = jace.AcePlan(**dict(jplan.__dict__, radial=radial, ylm=ylm))
    port, ref = both(
        lambda *a: ace.ace_descriptors_with_jacobian(*a, plan),
        lambda *a: jace.ace_descriptors_with_jacobian(*a, jplan), inputs)
    assert port[1].shape == (6, len(plan.labels), 16, 3)
    assert rel(port[0], ref[0]) <= RTOL and rel(port[1], ref[1]) <= RTOL
