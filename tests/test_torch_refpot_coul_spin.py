"""fitsnap_tpu_torch's coul/cut and spin/exchange/biquadratic references
(kernel K5's `ref_eav` mode) against fitsnap_tpu (CPU, float64).

- `reference_eav` with coul/cut, with the spin term (offset yes and no)
  and with the hybrid/overlay of zbl, coul/cut and the spin term, on the
  ZBL cases of tests/test_torch_zbl.py (two types, one-sided lists, atoms
  that meet their own periodic images, padding atoms) with seeded charges
  and unit spins: energy, forces and virial config by config, through the
  wrapper on CPU tensors (no launch) and `plain=True`, within 1e-12
  relative to each array's largest magnitude;
- the cases of tests/test_refpot.py: the two-atom Coulomb energy and its
  analytic forces, zero past the cutoff, and coul/cut without charges
  raising ValueError in both packages; the spin term without spins adds
  nothing (as in the JAX package) and its forces and virial are the
  non-spin terms' alone;
- the SNAP calculator's `_pack`: unit spins from `Spins` columns 1:4 and
  the charges under coul/cut, which raises without `Charges`;
- a FitSnap SNAP fit of a small Fe-shaped set (`synthetic.fe_configs`,
  `fe_settings`: zbl + coul/cut + spin, twojmax 4) whose JSON carries
  `Spins` and `Charges`: A, b, w and the coefficients within 1e-10;
- the paths that pass the reference no spins or charges, as the JAX
  package does: the ACE rows (a spin array that stays zero, no charges:
  coul/cut raises, the spin term adds its offset energy), the NN prep and
  the streamed fit (neither: coul/cut raises, no spin energy).
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.calculators.ace import AceCalculator as JaxAce
from fitsnap_tpu.calculators.snap import SnapCalculator as JaxSnap
from fitsnap_tpu.config import Config as JaxConfig
from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu.ops import refpot as jrefpot
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.calculators.ace import AceCalculator
from fitsnap_tpu_torch.calculators.snap import SnapCalculator, nn_prep
from fitsnap_tpu_torch.config import Config
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.ops import neighbors, refpot
from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_zbl import LIST_CUTOFF, case_cells, rel, t

RTOL = 1e-12
FIT_TOL = 1e-10
SPIN = ("pair_coeff * * spin/exchange/biquadratic biquadratic 4.5 0.2827 "
        "-4.747 0.7810 0.0234 -1.0 0.6 offset {}")
STYLES = {
    "coul": ["pair_style coul/cut 5.0"],
    "spin": ["pair_style spin/exchange/biquadratic 4.5", SPIN.format("yes")],
    "spin_no_offset": ["pair_style spin/exchange/biquadratic 4.5",
                       SPIN.format("no")],
    "hybrid": ["pair_style hybrid/overlay zero 10.0 zbl 4.0 4.8 coul/cut 5.0 "
               "spin/exchange/biquadratic 4.5", "pair_coeff * * zero",
               "pair_coeff * * zbl 73 41", "pair_coeff * * coul/cut",
               SPIN.format("yes")],
}


def specs(decls, ntypes=2):
    section = SimpleNamespace(lmp_pairdecl=decls)
    return (refpot.parse_reference(section, ntypes),
            jrefpot.parse_reference(section, ntypes))


@pytest.fixture(scope="module", params=["two_types", "one_sided",
                                        "self_image", "padding"])
def case(request):
    """A ZBL case of tests/test_torch_zbl.py (its cells, host lists at 5.4
    A and reverse table) with seeded charges (zero on padding atoms) and
    unit spins: (name, (disp, jidx, mask, rev, types), natoms, q, s)."""
    name = request.param
    rng = np.random.default_rng(21)
    cells = case_cells(name, rng)
    natoms = [len(p) for p, _, _ in cells]
    A = max(natoms) + (name == "padding")
    K = max(neighbors.count_neighbors(p, c, len(p), LIST_CUTOFF)
            for p, c, _ in cells)
    lists = [neighbors.host_neighbors(p, c, len(p), LIST_CUTOFF, a_pad=A,
                                      k_pad=K)[:3] for p, c, _ in cells]
    disp, jidx, mask = (np.stack(x) for x in zip(*lists))
    types = np.stack([np.pad(ty, (0, A - len(ty))) for _, _, ty in cells])
    if name == "one_sided":
        ci, ii, kk = np.nonzero(mask)
        pick = rng.choice(len(ci), size=len(ci) // 6, replace=False)
        mask[ci[pick], ii[pick], kk[pick]] = False
    rev = sk.reverse_table_plain(t(jidx, torch.int32), t(mask))[0].numpy()
    batch = (disp, jidx, mask, rev, types)
    rng = np.random.default_rng(27)
    C = len(cells)
    q = rng.normal(0.0, 0.4, (C, A))
    s = rng.normal(size=(C, A, 3))
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    for c, na in enumerate(natoms):
        q[c, na:] = 0.0
        s[c, na:] = 0.0
    return name, batch, natoms, q, s


@pytest.mark.parametrize("style", sorted(STYLES))
def test_reference_eav_modes_match_jax(case, style):
    name, batch, natoms, q, s = case
    spec, jspec = specs(STYLES[style])
    disp, jidx, mask, rev, types = batch
    args = (t(disp), t(jidx, torch.int32), t(mask), t(rev, torch.int32),
            t(types, torch.int32))
    sk.reset_launches()
    outs = [refpot.reference_eav(*args, spec, plain=plain, spins=t(s),
                                 charges=t(q)) for plain in (False, True)]
    assert sk.launches()["zbl_eav"] == 0
    for c, na in enumerate(natoms):
        je, jf, jv = jrefpot.reference_eav(
            jnp.asarray(disp[c]), jnp.asarray(jidx[c]), jnp.asarray(mask[c]),
            jnp.asarray(types[c]), na, jspec, spins=jnp.asarray(s[c]),
            charges=jnp.asarray(q[c]))
        assert abs(float(je)) > 0
        for energy, force, virial in outs:
            assert rel(energy[c], je) <= RTOL
            assert rel(force[c], jf) <= RTOL
            assert rel(virial[c], jv) <= RTOL
    if style.startswith("spin"):
        # energy only: no force, no virial
        assert all((f == 0).all() and (v == 0).all() for _, f, v in outs)


def test_coul_cut_pair_and_missing_charges():
    """tests/test_refpot.py's two-atom case: E = qqr2e q0 q1 / r, the
    analytic attractive forces, zero past rc; ValueError without charges
    in both packages."""
    spec, jspec = specs(["pair_style coul/cut 5.0"], 1)
    assert spec.coul.rc == 5.0 and refpot._QQR2E == jrefpot._QQR2E
    r = 2.5
    disp = np.array([[[[r, 0.0, 0.0]], [[-r, 0.0, 0.0]]]])
    jidx = np.array([[[1], [0]]], np.int32)
    mask = np.ones((1, 2, 1), bool)
    rev = sk.reverse_table_plain(t(jidx), t(mask))[0]
    types = torch.zeros((1, 2), dtype=torch.int32)
    q = torch.tensor([[0.8, -0.5]], dtype=torch.float64)
    e, f, _ = refpot.reference_eav(t(disp), t(jidx), t(mask), rev, types,
                                   spec, charges=q)
    assert abs(float(e[0]) - refpot._QQR2E * 0.8 * (-0.5) / r) < 1e-12
    fx = refpot._QQR2E * 0.8 * 0.5 / r ** 2
    np.testing.assert_allclose(f[0].numpy(), [[fx, 0, 0], [-fx, 0, 0]],
                               atol=1e-12)
    e6, _, _ = refpot.reference_eav(t(disp * 6.0 / r), t(jidx), t(mask),
                                    rev, types, spec, charges=q)
    assert float(e6[0]) == 0.0
    with pytest.raises(ValueError, match="[Cc]harge"):
        refpot.reference_eav(t(disp), t(jidx), t(mask), rev, types, spec)
    with pytest.raises(ValueError, match="[Cc]harge"):
        jrefpot.reference_eav(jnp.asarray(disp[0]), jnp.asarray(jidx[0]),
                              jnp.asarray(mask[0]), jnp.zeros(2, int), 2,
                              jspec)


def test_spin_term_without_spins_adds_nothing(case):
    """As in the JAX package: a spin term given no spins adds no energy,
    and the hybrid's forces and virial are the zbl and coul terms' alone
    whatever the spins."""
    _, batch, natoms, q, s = case
    spec, jspec = specs(STYLES["hybrid"])
    bare, _ = specs(STYLES["hybrid"][:1] + STYLES["hybrid"][1:4])
    args = [t(x) for x in batch[:3]] + [t(batch[3], torch.int32),
                                        t(batch[4], torch.int32)]
    none = refpot.reference_eav(*args, spec, charges=t(q))
    ref = refpot.reference_eav(*args, bare, charges=t(q))
    full = refpot.reference_eav(*args, spec, charges=t(q), spins=t(s))
    for a, b in zip(none, ref):
        assert torch.equal(a, b)
    assert rel(full[1], ref[1]) <= RTOL and rel(full[2], ref[2]) <= RTOL
    assert rel(full[0], ref[0]) > 1e-6
    c = 0
    je, _, _ = jrefpot.reference_eav(
        *(jnp.asarray(x[c]) for x in batch[:3]), jnp.asarray(batch[4][c]),
        natoms[c], jspec, charges=jnp.asarray(q[c]))
    assert rel(none[0][c], je) <= RTOL


def config_sections(tmp_path, decls):
    """Both packages' Config of the Ta SNAP settings with `decls` as the
    REFERENCE (a coul/cut pair style among them)."""
    s = synthetic.ta_settings(tmp_path, groups=[])
    style, *coeffs = decls
    s["REFERENCE"] = {"units": "metal", "atom_style": "charge",
                      "pair_style": style.removeprefix("pair_style "),
                      **{f"pair_coeff{i + 1}": c.removeprefix("pair_coeff ")
                         for i, c in enumerate(coeffs)}}
    return (Config(s, arglist=["--overwrite"]),
            JaxConfig(s, arglist=["--overwrite"]))


def test_pack_reads_spins_and_needs_charges(tmp_path):
    """`_pack` as JAX's: unit spins from Spins[:, 1:4] where the reference
    has a spin term, charges where it has coul/cut, ValueError naming
    `Charges` without them."""
    cfg, jcfg = config_sections(tmp_path, STYLES["hybrid"])
    calc = SnapCalculator("LAMMPSSNAP", cfg, "cpu")
    jcalc = JaxSnap("LAMMPSSNAP", jcfg)
    rng = np.random.default_rng(3)
    data = {"Positions": rng.uniform(0, 4, (3, 3)), "Lattice": np.eye(3) * 4,
            "AtomTypes": ["Ta"] * 3, "NumAtoms": 3, "File": "t",
            "Spins": np.c_[np.full(3, 2.2), rng.normal(size=(3, 3))],
            "Charges": rng.normal(size=3)}
    pc, jpc = calc._pack(data), jcalc._pack(data)
    np.testing.assert_array_equal(pc.spins, jpc.spins)
    np.testing.assert_array_equal(pc.charges, jpc.charges)
    assert np.allclose(np.linalg.norm(pc.spins, axis=1), 1.0)
    del data["Charges"]
    for c in (calc, jcalc):
        with pytest.raises(ValueError, match="Charges"):
            c._pack(data)


def write_fe(root, seed):
    """A small Fe-shaped set with Spins and Charges and seeded truths."""
    rng = np.random.default_rng(seed)
    confs = synthetic.fe_configs(
        seed, {"Volume_BCC": 3, "Spin_BCC": 2, "Displaced_BCC": 1})
    for (g, f), c in synthetic.write_dataset(root, confs).items():
        n = len(c[0])
        st = rng.normal(0.0, 2e3, (3, 3))
        (root / g / f).write_text(synthetic.config_json(
            c[0], c[1], energy=-8.3 * n + rng.normal(0.0, 0.5),
            forces=rng.normal(0.0, 0.3, (n, 3)), stress=0.5 * (st + st.T),
            types=c[2], extra=c[3]))


def fit_both(s, root):
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


@pytest.fixture(scope="module")
def fe_fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fe")
    write_fe(root / "JSON", 5)
    s = synthetic.fe_settings(root / "JSON")
    s["BISPECTRUM"]["twojmax"] = 4
    return fit_both(s, root)


def test_fe_fit_matches_jax(fe_fits):
    port, ref = fe_fits["port"], fe_fits["jax"]
    spec = port.calculator.refspec
    assert spec.zbl and spec.coul and spec.spin
    assert all(pc.spins is not None and pc.charges is not None
               for pc in port.calculator.host_preprocess(port.data)[0])
    assert port.a.shape == ref.a.shape
    for x in ("a", "b", "w"):
        assert rel(getattr(port, x), getattr(ref, x)) <= FIT_TOL, x
    assert rel(port.fit, ref.fit) <= FIT_TOL


def test_fe_reference_reads_the_spins(fe_fits, tmp_path):
    """b moves with the spins: the same set with every spin along +z has
    other energy rows (the spin term is energy only: the force rows stay)."""
    port = fe_fits["port"]
    calc = port.calculator
    data = [dict(d, Spins=np.c_[np.full(d["NumAtoms"], 2.2),
                                np.tile([0.0, 0.0, 1.0], (d["NumAtoms"], 1))])
            for d in port.data]
    _, b, _, fs = calc.process_configs(data)
    rows = np.asarray(fs["Row_Type"])
    assert rel(b[rows == "Force"], port.b[rows == "Force"]) <= RTOL
    assert rel(b[rows == "Energy"], port.b[rows == "Energy"]) > 1e-8


def test_ace_rows_pass_a_zero_spin_array_and_no_charges(fe_fits):
    """The ACE calculator passes the reference a spin array that stays zero
    (the spin term adds J(r) off + K(r) off a pair) and no charges (coul/cut
    raises), as JAX's does; its rows with the spin term equal JAX's."""
    port = fe_fits["port"]
    s = synthetic.ace_settings(port.config.sections["PATH"].datapath,
                               groups=[])
    s["ACE"].update(type="Fe", ranks="1 2", lmax="0 1", nmax="2 1",
                    nmaxbase=2, lmin=0)
    s["ESHIFT"] = {"Fe": 0.0}
    s["GROUPS"].update({g: " ".join(map(str, v))
                        for g, v in synthetic.FE_GROUPS.items()})
    decls = synthetic.fe_settings(".")["REFERENCE"]
    s["REFERENCE"] = dict(decls, pair_style="hybrid/overlay zero 10.0 zbl "
                          "4.0 4.8 spin/exchange/biquadratic 4.5",
                          pair_coeff3=decls["pair_coeff4"])
    del s["REFERENCE"]["pair_coeff4"]
    cfg, jcfg = (Config(s, arglist=["--overwrite"]),
                 JaxConfig(s, arglist=["--overwrite"]))
    calc, jcalc = AceCalculator("LAMMPSPACE", cfg, "cpu"), JaxAce(
        "LAMMPSPACE", jcfg)
    data = port.data
    a, b, _, _ = calc.process_configs(data)
    ja, jb, _, _ = jcalc.process_configs(data)
    assert rel(a, ja) <= FIT_TOL and rel(b, jb) <= FIT_TOL
    assert calc._pack(data[0]).spins is None
    s["REFERENCE"] = dict(s["REFERENCE"], pair_style="coul/cut 5.0",
                          pair_coeff1="* *")
    for key in ("pair_coeff2", "pair_coeff3"):
        del s["REFERENCE"][key]
    calc = AceCalculator("LAMMPSPACE", Config(s, arglist=["--overwrite"]),
                         "cpu")
    jcalc = JaxAce("LAMMPSPACE", JaxConfig(s, arglist=["--overwrite"]))
    for c in (calc, jcalc):
        with pytest.raises(ValueError, match="[Cc]harge"):
            c.process_configs(data[:1])


def test_nn_prep_passes_no_spins_or_charges(fe_fits):
    """The NN prep's reference gets no spins or charges (JAX
    `solvers/network.py:341`): no spin energy, and coul/cut raises."""
    calc = fe_fits["port"].calculator
    packed, buckets = calc.host_preprocess(fe_fits["port"].data)
    ids, args = next(iter(calc.batches(packed, buckets)))
    ref = calc.ref_tensors(packed, ids, args[0])
    assert ref["spins"] is not None and ref["charges"] is not None
    with pytest.raises(ValueError, match="[Cc]harge"):
        calc.nn_prep(*args[:6])
    spin_only, _ = specs(STYLES["spin"], 1)
    _, _, re, rf = nn_prep(calc.params, spin_only, *args[:6])
    assert (re == 0).all() and (rf == 0).all()


def test_streamed_fit_passes_no_spins_or_charges(fe_fits):
    """The streamed fit's rows (JAX `parallel/fit.py:316-317`) give the
    reference neither: coul/cut raises, the spin term adds nothing."""
    from fitsnap_tpu_torch.calculators.snap import snap_rows

    calc = fe_fits["port"].calculator
    packed, buckets = calc.host_preprocess(fe_fits["port"].data)
    ids, args = next(iter(calc.batches(packed, buckets)))
    ref = calc.ref_tensors(packed, ids, args[0])
    with pytest.raises(ValueError, match="[Cc]harge"):
        snap_rows(calc.params, 1, calc.refspec, *args)
    spin_only, _ = specs(STYLES["spin"], 1)
    rows = snap_rows(calc.params, 1, spin_only, *args)
    assert (rows["ref_e"] == 0).all()
    with_spins = snap_rows(calc.params, 1, spin_only, *args,
                           spins=ref["spins"])
    assert (with_spins["ref_e"] != 0).any()
