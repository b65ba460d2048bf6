"""fitsnap_tpu_torch's ACE spline radials (`FITSNAP_TPU_ACE_SPLINE`, kernel
K13's spline mode) against fitsnap_tpu (CPU, float64).

ML-PACE evaluates its radial functions from cubic Hermite tables of bin
width delta; both packages do so when `FITSNAP_TPU_ACE_SPLINE=<delta>` is
set.  Checks:

- `_hermite_radial_table` in the six radial variants against the JAX
  package's (node values and derivatives; at r = 0 the JAX package's
  `jax.jvp` derivative), 1e-12 relative to the table's largest magnitude;
- `build_ace_plan` reads the variable as the JAX package does;
- `spline_radial_basis` (values and the r derivative) against the JAX
  function and `jax.jvp` of it, per bond, 1e-12;
- descriptors and their jacobian on the plans and inputs of
  tests/test_torch_ace.py with spline plans, through the wrappers on CPU
  tensors (no launch) and `plain=True`, 1e-12; dead pairs exactly zero;
- a numpy emulation of K13's spline radial item (the bin, t, the four
  coefficients of each radial function, the inner ramp) from the table K13
  reads (`spline_tables`) against the plain radials, 1e-12;
- a LAMMPSPACE FitSnap fit with spline radials: A, b and the coefficients
  within 1e-10 of the JAX package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops import ace as jace
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.convert import ACE_PLAN_FIELDS, ace_plan_from_numpy
from fitsnap_tpu_torch.kernels import ace_kernels as ak
from fitsnap_tpu_torch.ops import ace
from tests.test_torch_ace import PLANS, both, rel, section, t
from tests.test_torch_ace_fit import settings, write_configs

RTOL = 1e-12
DELTA = 0.001
VARIANTS = ["v0", "pace_x", "v0_t1", "pace_x_t1", "pace_px", "pace_mx"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_hermite_table_matches_jax(variant):
    args = (4.604694451, 3.059235105, 6, variant, DELTA)
    tab = ace._hermite_radial_table(*args)
    ref = jace._hermite_radial_table(*args)
    assert tab.shape == ref.shape == (4606, 6, 4)
    assert rel(tab, ref) <= RTOL
    # row by row too: the small bins near r = 0 hold the r = 0 node
    assert rel(tab[:2], ref[:2]) <= RTOL


@pytest.fixture(scope="module")
def spline_cases(monkeypatch_module):
    """{plan name: (JAX plan, port plan, numpy inputs)} of
    tests/test_torch_ace.py's plans built with FITSNAP_TPU_ACE_SPLINE set,
    the port's plan from the JAX one and from its own section."""
    monkeypatch_module.setenv("FITSNAP_TPU_ACE_SPLINE", str(DELTA))
    out = {}
    for name in PLANS:
        jplan = jace.build_ace_plan(section(name))
        plan = ace.build_ace_plan(section(name))
        assert plan.spline_delta == jplan.spline_delta == DELTA
        carried = ace_plan_from_numpy({k: getattr(jplan, k)
                                       for k in ACE_PLAN_FIELDS})
        assert carried.spline_delta == DELTA
        nt = PLANS[name]["numtypes"]
        rng = np.random.default_rng(5)
        A, K = 8, 24
        d = rng.normal(size=(A, K, 3))
        d *= rng.uniform(0.8, 5.0, (A, K, 1)) / np.linalg.norm(
            d, axis=-1, keepdims=True)
        ielem = rng.integers(0, nt, A)
        jelem = rng.integers(0, nt, (A, K))
        mask = rng.uniform(size=(A, K)) < 0.85
        mask[-1] = False
        out[name] = (jplan, plan, carried, (d, jelem, mask, ielem))
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_plan_reads_the_variable(monkeypatch):
    monkeypatch.delenv("FITSNAP_TPU_ACE_SPLINE", raising=False)
    assert ace.build_ace_plan(section("one")).spline_delta is None
    monkeypatch.setenv("FITSNAP_TPU_ACE_SPLINE", "0.002")
    assert ace.build_ace_plan(section("one")).spline_delta == \
        jace.build_ace_plan(section("one")).spline_delta == 0.002


@pytest.mark.parametrize("name", sorted(PLANS))
def test_spline_radials_and_derivative_match_jax(spline_cases, name):
    jplan, plan, _, _ = spline_cases[name]
    nt = plan.numtypes
    rng = np.random.default_rng(9)
    r = rng.uniform(0.05, 5.2, 300)
    bond = rng.integers(0, nt * nt, 300)
    rcm = np.ravel(plan.rcut)[bond]
    g, dg = ace.spline_radial_basis(t(r), t(bond), t(rcm), plan)
    rcuts = tuple(np.ravel(jplan.rcut).astype(float))
    lams = tuple(np.ravel(jplan.lmbda).astype(float))

    def f(rr):
        return jace.spline_radial_basis(rr, rcuts, lams, jnp.asarray(bond),
                                        jplan.nradbase, jplan.radial, DELTA)

    jg, jdg = jax.jvp(f, (jnp.asarray(r),), (jnp.ones(300),))
    assert (r > rcm).any() and np.abs(np.asarray(jg)).max() > 0.1
    assert rel(g, jg) <= RTOL and rel(dg, jdg) <= RTOL


@pytest.mark.parametrize("name", sorted(PLANS))
def test_spline_descriptors_with_jacobian_match_jax(spline_cases, name):
    jplan, plan, carried, inputs = spline_cases[name]
    ak.reset_launches()
    for p in (plan, carried):
        for plain in (False, True):
            port, ref = both(
                lambda *a: ace.ace_descriptors_with_jacobian(*a, p,
                                                             plain=plain),
                lambda *a: jace.ace_descriptors_with_jacobian(*a, jplan),
                inputs)
            assert rel(port[0], ref[0]) <= RTOL
            assert rel(port[1], ref[1]) <= RTOL
    assert set(ak.launches().values()) == {0}
    A, Jp = ak.ace_pair_basis_plain(*(t(x) for x in inputs), plan)
    dead = ~t(inputs[2])
    assert (Jp[:, dead] == 0).all() and (A[-1, 1:] == 0).all()


def emulate_spline_radials(plan, r, bond, rcm, ielem, jelem):
    """g and dg/dr as K13's radial item forms them on a spline plan: bin b
    = clamp(floor(r / delta)), t = r / delta - b, the bin's coefficients of
    each n from `spline_tables`, zero at or past rcm, then the inner ramp."""
    tab = ace.spline_tables(plan)
    delta = plan.spline_delta
    xs = r / delta
    b = np.clip(np.floor(xs), 0, tab.shape[1] - 1)
    tt = (xs - b)[..., None]
    c = tab[bond, b.astype(np.int64)]
    h = ((c[..., 3] * tt + c[..., 2]) * tt + c[..., 1]) * tt + c[..., 0]
    dh = ((3.0 * c[..., 3] * tt + 2.0 * c[..., 2]) * tt + c[..., 1]) / delta
    fin, dfin = np.ones_like(r), np.zeros_like(r)
    if np.any(np.asarray(plan.rcinner) > 0.0):
        din = np.asarray(plan.drcinner)[ielem, jelem]
        dsi = 1.0 / np.maximum(din, 1e-12)
        u = (r - (np.asarray(plan.rcinner)[ielem, jelem] - din)) * dsi
        fin = np.where(u <= 0.0, 0.0, np.where(
            u < 1.0, 0.5 * (1.0 - np.cos(np.pi * u)), 1.0))
        dfin = np.where((u > 0.0) & (u < 1.0),
                        0.5 * np.pi * np.sin(np.pi * u) * dsi, 0.0)
    live = (r < rcm)[..., None]
    g = np.where(live, h * fin[..., None], 0.0)
    dg = np.where(live, dh * fin[..., None] + h * dfin[..., None], 0.0)
    return g, dg


@pytest.mark.parametrize("name", sorted(PLANS))
def test_k13_spline_scheme_matches_plain(spline_cases, name):
    _, plan, _, (d, jelem, mask, ielem) = spline_cases[name]
    r = np.sqrt((np.where(mask[..., None], d, [1.0, 0.0, 0.0]) ** 2).sum(-1))
    ie = ielem[:, None].repeat(d.shape[1], 1)
    bond = ie * plan.numtypes + jelem
    rcm = np.asarray(plan.rcut)[ie, jelem]
    g, dg = emulate_spline_radials(plan, r, bond, rcm, ie, jelem)
    pg, pdg = ace.spline_radial_basis(t(r), t(bond), t(rcm), plan)
    if np.any(np.asarray(plan.rcinner) > 0.0):
        tabs = ace.plan_tensors(plan, "cpu")
        ii, jj = torch.as_tensor(ie), torch.as_tensor(jelem)
        din = torch.clamp(tabs.drcinner[ii, jj], min=1e-12)
        u = (t(r) - (tabs.rcinner[ii, jj] - tabs.drcinner[ii, jj])) / din
        ramp = (u > 0.0) & (u < 1.0)
        u = torch.clamp(u, 0.0, 1.0)
        fin = (0.5 * (1.0 - torch.cos(torch.pi * u)))[..., None]
        dfin = torch.where(ramp, 0.5 * torch.pi * torch.sin(torch.pi * u)
                           / din, torch.zeros_like(u))[..., None]
        pg, pdg = pg * fin, pdg * fin + pg * dfin
    assert rel(g, pg) <= RTOL and rel(dg, pdg) <= RTOL
    tab = ace.spline_tables(plan)
    assert tab.shape[0] == plan.numtypes ** 2
    assert tab.shape[1] == int(np.ceil(np.max(plan.rcut) / DELTA)) + 1


@pytest.fixture(scope="module")
def spline_fits(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("FITSNAP_TPU_ACE_SPLINE", str(DELTA))
    root = tmp_path_factory.mktemp("acespline")
    (root / "JSON").mkdir()
    write_configs(root / "JSON", 23)
    s = settings(root / "JSON")
    out = {}
    cwd = os.getcwd()
    try:
        for name, make in (
                ("port", lambda: FitSnap(s, arglist=["--overwrite"],
                                         device="cpu")),
                ("jax", lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
            (root / name).mkdir()
            os.chdir(root / name)
            fs = make()
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
            out[name] = fs
    finally:
        os.chdir(cwd)
    return out


def test_spline_fit_matches_jax(spline_fits):
    """A and b within 1e-10 (they agree to about 1e-13: the tables' node
    values differ from the JAX package's by rounding, whose exp and cos
    differ from PyTorch's, and the spline's derivative scales a node
    difference by 1 / delta, so the force rows differ by up to 1e-12 of
    their largest entry); the fitted coefficients' predictions on every
    row within 1e-10 of the JAX fit's.  The coefficients themselves carry
    that A difference times cond(weighted A), 1.1e6 here: 3e-10 of their
    largest magnitude, held to 1e-9."""
    port, ref = spline_fits["port"], spline_fits["jax"]
    assert port.calculator.plan.spline_delta == DELTA
    assert port.a.shape == ref.a.shape
    assert rel(port.a, ref.a) <= 1e-10 and rel(port.b, ref.b) <= 1e-10
    assert rel(ref.a @ port.fit, ref.a @ np.asarray(ref.fit)) <= 1e-10
    assert rel(port.fit, ref.fit) <= 1e-9



def test_spline_fit_gap_is_the_node_values(spline_fits, monkeypatch,
                                           tmp_path):
    """The coefficients' 3e-10 above comes from the tables' node values
    alone.  The port forms them in the JAX package's order of operations,
    but XLA's exp and PyTorch's differ by an ulp at some nodes, and the
    spline's coefficients c2 and c3 take differences of neighboring nodes.  With the JAX package's node
    values and the port's own node derivatives (closed form, not `jax.jvp`)
    the port's fit agrees with the JAX fit's coefficients within the slice
    rule's 1e-10."""
    monkeypatch.setenv("FITSNAP_TPU_ACE_SPLINE", str(DELTA))
    own = ace._hermite_radial_table

    def jax_values(rcut, lmbda, nradbase, variant, delta):
        tab = own(rcut, lmbda, nradbase, variant, delta)
        rs = np.arange(tab.shape[0] + 1) * delta
        with jax.ensure_compile_time_eval():
            vals = np.asarray(jace.chebexpcos_basis(
                jnp.asarray(rs), rcut, lmbda, nradbase, variant))
        d0 = tab[..., 1]
        d1 = np.concatenate([d0[1:], [(tab[-1, :, 1] + 2 * tab[-1, :, 2]
                                       + 3 * tab[-1, :, 3])]])
        f0, f1 = vals[:-1], vals[1:]
        return np.stack([f0, d0, -3.0 * f0 - 2.0 * d0 + 3.0 * f1 - d1,
                         2.0 * f0 + d0 - 2.0 * f1 + d1], axis=-1)

    monkeypatch.setattr(ace, "_hermite_radial_table", jax_values)
    (tmp_path / "JSON").mkdir()
    write_configs(tmp_path / "JSON", 23)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        fs = FitSnap(settings(tmp_path / "JSON"), arglist=["--overwrite"],
                     device="cpu")
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
    finally:
        os.chdir(cwd)
    ref = spline_fits["jax"]
    assert rel(fs.a, ref.a) <= 1e-13
    assert rel(fs.fit, ref.fit) <= 1e-10
