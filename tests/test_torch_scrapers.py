"""The port's XYZ, VASP and ASE scrapers against the JAX package's (CPU,
float64).

The test writes its own data from a seed:
- extended-XYZ groups of small Ta cells (Lattice, Properties with forces,
  energy, pbc): one group with `stress`, one with `virial`, one as
  `.extxyz`, floats written %.17g;
- two OUTCAR trees with ionic steps in the layout `_parse_outcar` reads,
  one step unconverged and one step cut short (`vasp_ignore_incomplete`);
- a stand-in for ASE's Atoms class (`ase` is not needed).

Both packages scrape the same files, with `random_sampling` on and off,
with the XYZ frame-offset cache written and then read, and with the VASP
vJSON cache written and then read: strings and ints equal, float arrays
`np.array_equal`.  Then one small SNAP model (twojmax 4) is fitted from
the XYZ set and from the VASP set through both `FitSnap`s: A, b and w to
1e-12 relative, the coefficients to 1e-10 relative.
"""

import os
from contextlib import contextmanager

import numpy as np
import pytest

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.tools import synthetic

XYZ_GROUPS = {"Bcc": ("xyz", "stress", (1, 1, 1), 4),
              "Fcc": ("xyz", "virial", (1, 1, 1), 4),
              "Super": ("extxyz", "stress", (2, 2, 1), 3)}
GROUP_ROW = "0.7 0.3 100.0 1.0 1e-4"


def _g(x):
    return " ".join(f"{v:.17g}" for v in np.ravel(x))


def write_xyz(root, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for group, (ext, key, reps, n) in XYZ_GROUPS.items():
        lines = []
        basis = synthetic.FCC if group == "Fcc" else synthetic.BCC
        for _ in range(n):
            pos, cell0 = synthetic.supercell(basis, rng.uniform(3.2, 4.2),
                                             reps)
            cell = synthetic.strained(cell0, rng, 0.03)
            pos = pos @ np.linalg.solve(cell0, cell) \
                + rng.normal(0.0, 0.08, pos.shape)
            s = rng.normal(0.0, 2e3, (3, 3))
            energy = -11.8 * len(pos) + rng.normal(0.0, 0.5)
            forces = rng.normal(0.0, 0.3, pos.shape)
            lines.append(str(len(pos)))
            lines.append(
                f'Lattice="{_g(cell)}" '
                "Properties=species:S:1:pos:R:3:forces:R:3 "
                f'energy={energy:.17g} {key}="{_g(0.5 * (s + s.T))}" '
                'pbc="T T T"')
            for p, f in zip(pos, forces):
                lines.append(f"ta {_g(p)} {_g(f)}")
        (root / f"{group}.{ext}").write_text("\n".join(lines) + "\n")


OUTCAR_HEAD = """ vasp.6.3.0 (build Jan 01 2024)
 POTCAR:    PAW_PBE Ta_pv 07Sep2000
   VRHFIN =Ta: 5p6s5d
   ions per type =               {n}
"""


def outcar_text(rng, n, nsteps, unconverged=(), cut=None):
    """An OUTCAR of `nsteps` ionic steps of an n-atom bcc Ta cell; steps in
    `unconverged` end their electronic loop unconverged, and step `cut`
    has a coordinate block cut short."""
    pos0, cell = synthetic.supercell(synthetic.BCC, 3.3, (1, 1, n // 2))
    out = [OUTCAR_HEAD.format(n=n)]
    for step in range(nsteps):
        cellj = cell * (1 + rng.normal(0.0, 0.01))
        pos = pos0 + rng.normal(0.0, 0.05, pos0.shape)
        frc = rng.normal(0.0, 0.3, pos.shape)
        kb = rng.normal(0.0, 5.0, 6)
        toten = -11.8 * n + rng.normal(0.0, 0.3)
        out.append("  aborting loop " + (
            "EDIFF was not reached (unconverged)" if step in unconverged
            else "because EDIFF is reached"))
        out.append(" direct lattice vectors                 reciprocal "
                   "lattice vectors")
        for v in cellj:
            out.append("   " + "  ".join(f"{x:.9f}" for x in v)
                       + "     0.000000000  0.000000000  0.000000000")
        out.append("  FORCE on cell =-STRESS in cart. coord.  units (eV):")
        out.append("  in kB   " + "  ".join(f"{x:.5f}" for x in kb))
        out.append("  external pressure =        1.23 kB  Pullay stress ="
                   "        0.00 kB")
        out.append(" POSITION                                       "
                   "TOTAL-FORCE (eV/Angst)")
        out.append(" " + "-" * 83)
        rows = [f"   {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}    "
                f"{f[0]:.6f} {f[1]:.6f} {f[2]:.6f}"
                for p, f in zip(pos, frc)]
        if step == cut:
            rows = rows[:n // 2] + [" " + "-" * 83]
        out += rows
        out.append(" " + "-" * 83)
        out.append("  FREE ENERGIE OF THE ION-ELECTRON SYSTEM (eV)")
        out.append("  ---------------------------------------------------")
        out.append(f"  free  energy   TOTEN  =       {toten:.8f} eV")
        out.append("")
        out.append(f"  energy  without entropy=      {toten + 0.01:.8f}  "
                   f"energy(sigma->0) =      {toten + 0.005:.8f}")
        out.append("")
    return "\n".join(out) + "\n"


def write_vasp(root, seed):
    """Two groups: `Bulk` with one OUTCAR two levels deep and `Strained`
    with two, one of them with an unconverged step and one with a step cut
    short."""
    rng = np.random.default_rng(seed)
    for rel, (n, nsteps, unconv, cut) in {
            "Bulk/run_a/relax/OUTCAR": (4, 5, (), None),
            "Strained/s1/OUTCAR": (2, 4, (2,), None),
            "Strained/s2/OUTCAR": (4, 4, (), 3)}.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(outcar_text(rng, n, nsteps, unconv, cut))


def settings(datapath, scraper, groups, random_sampling=0, extra=None):
    s = synthetic.ta_settings(datapath, groups=[])
    s["BISPECTRUM"]["twojmax"] = 4
    s["SCRAPER"] = {"scraper": scraper}
    s["GROUPS"].update({g: GROUP_ROW for g in groups},
                       random_sampling=random_sampling, random_seed=7)
    s["OUTFILE"] = {"metrics": "Ta_metrics.md", "potential": "Ta_pot"}
    for section, kv in (extra or {}).items():
        s.setdefault(section, {}).update(kv)
    return s


@contextmanager
def cwd(path):
    path.mkdir(parents=True, exist_ok=True)
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def scrape(package, s):
    """Scrape `s` with the scraper of `package` ("jax" or "port")."""
    if package == "jax":
        from fitsnap_tpu.config import Config
        from fitsnap_tpu.fitsnap import _scraper_factory
    else:
        from fitsnap_tpu_torch.config import Config
        from fitsnap_tpu_torch.fitsnap import _scraper_factory
    sc = _scraper_factory(Config(s, arglist=["--overwrite"]))
    sc.scrape_groups()
    sc.divvy_up_configs()
    return sc.scrape_configs()


def assert_same_dicts(port, ref):
    assert len(port) == len(ref) and len(ref)
    for p, r in zip(port, ref):
        assert sorted(p) == sorted(r)
        for key, v in r.items():
            if isinstance(v, np.ndarray):
                assert isinstance(p[key], np.ndarray), key
                assert p[key].dtype == v.dtype, key
                assert np.array_equal(p[key], v), key
            else:
                assert type(p[key]) is type(v), key
                assert p[key] == v, key


@pytest.mark.parametrize("random_sampling", [0, 1])
def test_xyz_dicts_equal(tmp_path, random_sampling):
    write_xyz(tmp_path / "XYZ", 3)
    s = settings(tmp_path / "XYZ", "XYZ", XYZ_GROUPS, random_sampling)
    ref = scrape("jax", s)
    port = scrape("port", s)
    assert_same_dicts(port, ref)
    assert {d["Group"] for d in port} == set(XYZ_GROUPS)
    assert any(d["test_bool"] for d in port)
    # training configs first, then the testing ones
    flags = [d["test_bool"] for d in port]
    assert flags == sorted(flags)


def test_xyz_offset_cache_written_then_read(tmp_path):
    """`save_group_scrape` writes the frame offsets; `read_group_scrape`
    reuses them; both packages write the same cache and read it alike."""
    write_xyz(tmp_path / "XYZ", 4)
    out = {}
    for package in ("jax", "port"):
        with cwd(tmp_path / package):
            s = settings(tmp_path / "XYZ", "XYZ", XYZ_GROUPS,
                         extra={"SCRAPER": {"save_group_scrape": "offs.txt"}})
            first = scrape(package, s)
            s = settings(tmp_path / "XYZ", "XYZ", XYZ_GROUPS,
                         extra={"SCRAPER": {"read_group_scrape": "offs.txt"}})
            out[package] = (first, scrape(package, s),
                            (tmp_path / package / "offs.txt").read_text())
    assert out["port"][2] == out["jax"][2]
    assert len(out["port"][2].splitlines()) == len(XYZ_GROUPS)
    assert_same_dicts(out["port"][0], out["jax"][0])
    assert_same_dicts(out["port"][1], out["jax"][1])
    assert_same_dicts(out["port"][1], out["port"][0])


def test_vasp_dicts_and_cache(tmp_path):
    """First run parses the OUTCARs and writes the vJSON cache (an
    unconverged step labeled, the cut step dropped); the second run reads
    the cache; TRAINSHIFT applies at scrape time."""
    write_vasp(tmp_path / "VASP", 5)
    s = settings(tmp_path / "VASP", "VASP", ["Bulk", "Strained"],
                 extra={"GROUPS": {"vasp_ignore_incomplete": 1},
                        "TRAINSHIFT": {"Ta": 0.25}})
    out = {}
    for package in ("jax", "port"):
        with cwd(tmp_path / package):
            out[package] = (scrape(package, s), scrape(package, s),
                            sorted(str(p.relative_to(tmp_path / package))
                                   for p in (tmp_path / package).rglob(
                                       "*.json")))
    assert out["port"][2] == out["jax"][2]
    names = out["port"][2]
    assert len(names) == 5 + 4 + 3
    assert sum(n.endswith("_UNCONVERGED.json") for n in names) == 1
    for run in (0, 1):
        assert_same_dicts(out["port"][run], out["jax"][run])
    assert len(out["port"][0]) == 5 + 4 + 3


def test_vasp_incomplete_step_raises_in_both(tmp_path):
    from fitsnap_tpu.scrapers.vasp_scraper import IncompleteStep as JaxInc
    from fitsnap_tpu_torch.scrapers.vasp_scraper import IncompleteStep

    write_vasp(tmp_path / "VASP", 6)
    s = settings(tmp_path / "VASP", "VASP", ["Strained"])
    for package, exc in (("jax", JaxInc), ("port", IncompleteStep)):
        with cwd(tmp_path / package), pytest.raises(exc, match="incomplete"):
            scrape(package, s)


class StandInAtoms:
    """The parts of ase.Atoms that `collate_data` calls."""

    def __init__(self, cell, positions, symbols, energy=None, forces=None,
                 stress=None):
        self.cell = np.asarray(cell, float)
        self._pos = np.asarray(positions, float)
        self._sym = list(symbols)
        self._energy, self._forces, self._stress = energy, forces, stress
        self.info = {}

    def __len__(self):
        return len(self._pos)

    def get_positions(self):
        return self._pos

    def get_chemical_symbols(self):
        return self._sym

    def get_potential_energy(self):
        if self._energy is None:
            raise RuntimeError("no calculator")
        return self._energy

    def get_forces(self):
        if self._forces is None:
            raise RuntimeError("no calculator")
        return self._forces

    def get_stress(self, voigt=False):
        if self._stress is None:
            raise RuntimeError("no calculator")
        return self._stress


def stand_in_atoms(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, reps in enumerate(((1, 1, 1), (2, 1, 1), (2, 2, 1))):
        pos, cell = synthetic.supercell(synthetic.BCC, 3.31, reps)
        cell = cell.copy()
        cell[1, 0] = 0.3        # a tilt for the LAMMPS-normal rotation
        pos = pos + rng.normal(0.0, 0.05, pos.shape)
        s = rng.normal(0.0, 0.5, (3, 3))
        out.append(StandInAtoms(
            cell, pos, ["Ta"] * len(pos),
            energy=-11.8 * len(pos) if i != 1 else None,
            forces=rng.normal(0.0, 0.2, pos.shape),
            stress=0.5 * (s + s.T) if i == 2 else None))
    out[1].info["energy"] = -23.0
    return out


def test_ase_dicts_equal_and_feed_process_single(tmp_path):
    from fitsnap_tpu.scrapers.ase_funcs import ase_scraper as jax_ase
    from fitsnap_tpu_torch.scrapers.ase_funcs import ase_scraper

    frames = stand_in_atoms(8)
    weights = {"eweight": 2.0, "fweight": 3.0, "vweight": 0.5}
    port = ase_scraper(frames, name="ASE", group_dict=weights)
    ref = jax_ase(frames, name="ASE", group_dict=weights)
    assert_same_dicts(port, ref)
    assert_same_dicts(ase_scraper(frames), jax_ase(frames))

    s = settings(tmp_path, "JSON", ["ASE"])
    with cwd(tmp_path):
        fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
        jfs = JaxFitSnap(s, arglist=["--overwrite"])
        for d, r in zip(port, ref):
            a, b, w = fs.calculator.process_single(d)
            ja, jb, jw = jfs.calculator.process_single(r)
            assert rel(a, ja) <= 1e-12
            assert rel(b, jb) <= 1e-12 and rel(w, jw) <= 1e-12


def rel(port, ref):
    port, ref = np.asarray(port, float), np.asarray(ref, float)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """One SNAP fit of the XYZ set and one of the VASP set through both
    facades."""
    root = tmp_path_factory.mktemp("scraped_fits")
    write_xyz(root / "XYZ", 11)
    write_vasp(root / "VASP", 12)
    sets = {"XYZ": settings(root / "XYZ", "XYZ", XYZ_GROUPS),
            "VASP": settings(root / "VASP", "VASP", ["Bulk", "Strained"],
                             extra={"GROUPS": {"vasp_ignore_incomplete": 1}})}
    out = {}
    for kind, s in sets.items():
        for package, make in (
                ("port", lambda: FitSnap(s, arglist=["--overwrite"],
                                         device="cpu")),
                ("jax", lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
            with cwd(root / kind / package):
                fs = make()
                fs.scrape_configs()
                fs.process_configs()
                fs.perform_fit()
                fs.write_output()
                out[kind, package] = fs
    return out


@pytest.mark.parametrize("kind", ["XYZ", "VASP"])
def test_scraped_fit_matches(fits, kind):
    port, ref = fits[kind, "port"], fits[kind, "jax"]
    for name in ("a", "b", "w"):
        assert rel(getattr(port, name), getattr(ref, name)) <= 1e-12, name
    assert port.a.shape[1] == 15
    assert list(port.fs_dict["Row_Type"]) == list(ref.fs_dict["Row_Type"])
    assert rel(port.solver.fit, ref.solver.fit) <= 1e-10
