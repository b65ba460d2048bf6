"""Quadratic SNAP and explicit multi-element (chemflag) SNAP fits through
fitsnap_tpu_torch.FitSnap against fitsnap_tpu.FitSnap (CPU, float64).

Two small sets go through both facades (scrape -> process_configs ->
perform_fit -> write_output):

- "quadratic": eight jittered, strained bcc Ta cells (four of 2 atoms,
  four of 16) with `synthetic.quadratic_settings` at twojmax 6 (30 base +
  465 quadratic columns, bzeroflag 0: 496 coefficients);
- "inp": zincblende In/P cells of `synthetic.inp_configs` (8-atom volume
  and strain scans, 64-atom cells with antisite defects) with
  `synthetic.inp_settings` (chemflag, wselfallflag, bnormflag, bzeroflag
  1, per-element ESHIFT, ZBL for Z = 49 / 15) at twojmax 4 (2 x 112
  columns).

Truths are seeded random numbers.  Checks:

- a, b and w within 1e-12 relative to the largest magnitude, the per-row
  bookkeeping exactly;
- the weighted Aᵀb and the column norms of A within 1e-12; the
  coefficients within 1e-10 relative where the fit is determined: cond < 1e8
  over the singular values that lstsq keeps (rcond 1e-13), none of them
  near the cutoff (lstsq carries the 1e-16-level differences of a into the
  coefficients times the condition number).  The InP-shaped matrix is rank
  deficient at rounding level (chemflag's symmetric blocks repeat columns:
  48 equal column pairs) with the kept part at cond 4e6; the quadratic set
  has fewer rows than columns, so for it only Aᵀb and the norms hold;
- the `.snapcoeff` and `.snapparam` that the port's writer makes from the
  JAX fit's coefficients equal the JAX writer's character for character,
  apart from the header line of the `.snapcoeff` (date) and the package
  name, with the run hash set equal;
- `python -m fitsnap_tpu_torch inp.in --overwrite --device cpu` writes the
  InP-shaped potential: 2 x 113 coefficients.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.tools import synthetic

ROOT = Path(__file__).resolve().parent.parent
TA_GROUPS = {"Small": "1.0 0.0 100.0 1.0 1e-4",
             "Super": "0.75 0.25 100.0 1.0 1e-4"}
INP_COUNTS = {"Volume_ZB": 3, "Strain_ZB": 5, "Antisite_ZB64": 2}


def write_ta(root, seed):
    rng = np.random.default_rng(seed)
    for group, reps in (("Small", (1, 1, 1)), ("Super", (2, 2, 2))):
        (root / group).mkdir()
        for i in range(4):
            pos, cell0 = synthetic.supercell(synthetic.BCC,
                                             rng.uniform(3.15, 3.45), reps)
            cell = synthetic.strained(cell0, rng, 0.03)
            pos = pos @ np.linalg.solve(cell0, cell)
            pos = pos + rng.normal(0.0, 0.08, pos.shape)
            n = len(pos)
            st = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-11.8 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (st + st.T)))


def write_inp(root, seed):
    rng = np.random.default_rng(seed)
    for group, confs in synthetic.inp_configs(seed, INP_COUNTS).items():
        (root / group).mkdir()
        for i, (pos, cell, names) in enumerate(confs):
            n = len(pos)
            st = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-3.4 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (st + st.T), types=names))


def settings(kind, data):
    if kind == "quadratic":
        s = synthetic.quadratic_settings(data, groups=[])
        s["BISPECTRUM"]["twojmax"] = 6
        s["GROUPS"].update(TA_GROUPS)
    else:
        s = synthetic.inp_settings(data, groups=list(INP_COUNTS))
        s["BISPECTRUM"]["twojmax"] = "4 4"
    return s


@pytest.fixture(scope="module", params=["quadratic", "inp"])
def fits(request, tmp_path_factory):
    kind = request.param
    root = tmp_path_factory.mktemp(kind)
    data = root / "JSON"
    data.mkdir()
    (write_ta if kind == "quadratic" else write_inp)(data, 31)
    s = settings(kind, data)
    cwd = os.getcwd()
    out = {"kind": kind, "root": root, "settings": s}
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
            fs.write_output()
            out[name] = fs
        # both writers on the JAX coefficients, with one run hash
        coeffs = np.asarray(out["jax"].solver.fit)
        for name in ("port", "jax"):
            (root / f"{name}_on_jax").mkdir()
            os.chdir(root / f"{name}_on_jax")
            out[name].config.hash = "0" * 32
            out[name].output.write_lammps(coeffs)
    finally:
        os.chdir(cwd)
    return out


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", ["a", "b", "w"])
def test_linear_system(fits, name):
    port, ref = fits["port"], fits["jax"]
    sec = ref.config.sections["BISPECTRUM"]
    assert port.a.shape[1] == {"quadratic": 496, "inp": 224}[fits["kind"]]
    assert port.a.shape[1] == port.calculator.get_width() \
        == ref.calculator.get_width() == sec.ncoeff * sec.numtypes \
        + (0 if sec.bzeroflag else sec.numtypes)
    assert rel(getattr(port, name), getattr(ref, name)) <= 1e-12


def test_fs_dict(fits):
    port, ref = fits["port"].fs_dict, fits["jax"].fs_dict
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert list(port[key]) == list(ref[key]), key


def test_normal_equations_and_coefficients(fits):
    port, ref = fits["port"], fits["jax"]
    aw_p, aw_r = port.a * port.w[:, None], ref.a * ref.w[:, None]
    assert rel(aw_p.T @ (port.b * port.w), aw_r.T @ (ref.b * ref.w)) <= 1e-12
    assert rel(np.linalg.norm(aw_p, axis=0),
               np.linalg.norm(aw_r, axis=0)) <= 1e-12
    train = ~np.asarray(ref.fs_dict["Testing"])
    sv = np.linalg.svd(aw_r[train], compute_uv=False)
    kept = sv[sv > 1e-13 * sv[0]]
    # chemflag's symmetric blocks repeat columns exactly, so lstsq's
    # 1e-13 cutoff drops a null space at rounding level; the solution is
    # determined when the kept part is well conditioned and no singular
    # value lies near the cutoff
    well_posed = aw_r[train].shape[0] >= aw_r.shape[1] \
        and kept[0] < 1e8 * kept[-1] and (sv <= 1e-8 * sv[0]).sum() \
        == (sv <= 1e-13 * sv[0]).sum()
    assert well_posed == (fits["kind"] == "inp")
    if well_posed:
        assert rel(port.solver.fit, ref.solver.fit) <= 1e-10


def test_written_files(fits):
    root = fits["root"]
    pot = {"quadratic": "Ta_quad_pot", "inp": "InP_pot"}[fits["kind"]]
    for ext in (".snapcoeff", ".snapparam"):
        port = (root / "port_on_jax" / (pot + ext)).read_text()
        ref = (root / "jax_on_jax" / (pot + ext)).read_text()
        port = port.replace("fitsnap_tpu_torch", "fitsnap_tpu")
        if ext == ".snapcoeff":
            port, ref = (t.split("\n", 1)[1] for t in (port, ref))
        assert port == ref
    lines = (root / "port" / (pot + ".snapcoeff")).read_text().splitlines()
    sec = fits["jax"].config.sections["BISPECTRUM"]
    assert lines[2].split() == [str(sec.numtypes), str(sec.ncoeff + 1)]
    param = (root / "port" / (pot + ".snapparam")).read_text()
    flag = {"quadratic": "quadraticflag 1", "inp": "chemflag 1"}
    assert flag[fits["kind"]] in param.splitlines()


def test_cli_inp_on_cpu(tmp_path):
    data = tmp_path / "JSON"
    data.mkdir()
    write_inp(data, 5)
    synthetic.write_ini(tmp_path / "inp.in", settings("inp", data))
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "inp.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    lines = (tmp_path / "InP_pot.snapcoeff").read_text().splitlines()
    assert lines[2].split() == ["2", "113"]
    assert (tmp_path / "InP_metrics.md").exists()
