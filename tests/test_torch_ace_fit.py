"""The ACE linear fit (LAMMPSPACE, PACE output) through
fitsnap_tpu_torch.FitSnap against fitsnap_tpu.FitSnap (CPU, float64).

Seven small jittered, strained bcc Ta configs (four of 2 atoms, three of
16) with seeded truths in two groups go through both facades: scrape ->
process_configs -> perform_fit -> write_output, with an [ACE] section of
ranks 1-3 (nmax 4 2 1, lmax 0 2 2, lmin 0 0 1, nmaxbase 4, minsub basis),
bzeroflag 0 (the constant column) and the ZBL reference.

- a, b and w within 1e-12 relative to the largest magnitude, the per-row
  bookkeeping exactly;
- the coefficients within 1e-10 relative, on a set whose weighted design
  matrix has cond(Aw) < 1e8 (asserted: lstsq carries the 1e-16-level
  differences of a into the coefficients times the condition number);
- the written files: the `.acecoeff` and `.yace` that the port's writer
  makes from the JAX fit's coefficients equal the JAX files after the
  header line (date and hash) character for character; those that each
  pipeline wrote from its own coefficients have the same text apart from
  the numbers (and the padding after them), which agree within 1e-10
  relative to their largest;
- the port's `.yace` read back with the port's `plan_from_yace` (PyYAML)
  gives, per label, the fitted plan's descriptor times its coefficient
  (the file folds the coefficients into the ctildes), within 1e-12;
- `python -m fitsnap_tpu_torch ace.in --overwrite --device cpu` writes the
  `.acecoeff`, `.yace` and `.mod`.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.ops.ace import (ace_descriptors_with_jacobian,
                                       plan_from_yace)
from fitsnap_tpu_torch.tools import synthetic

ROOT = Path(__file__).resolve().parent.parent
ACE = {"numTypes": 1, "type": "Ta", "ranks": "1 2 3", "nmax": "4 2 1",
       "lmax": "0 2 2", "lmin": "0 0 1", "nmaxbase": 4,
       "rcutfac": 4.604694451, "lambda": 3.059235105, "b_basis": "minsub"}
GROUPS = {"Small": "1.0 0.0 100.0 1.0 1e-4",
          "Super": "0.7 0.3 100.0 1.0 1e-4"}
NUMBER = re.compile(r"-?\d+\.\d*(?:[eE][-+]?\d+)?|-?\d+[eE][-+]?\d+")


def write_configs(root, seed):
    rng = np.random.default_rng(seed)
    for group, reps, n in (("Small", (1, 1, 1), 4), ("Super", (2, 2, 2), 3)):
        (root / group).mkdir()
        for i in range(n):
            pos, cell0 = synthetic.supercell(synthetic.BCC,
                                             rng.uniform(3.15, 3.45), reps)
            cell = synthetic.strained(cell0, rng, 0.03)
            pos = pos @ np.linalg.solve(cell0, cell)
            pos = pos + rng.normal(0.0, 0.1, pos.shape)
            na = len(pos)
            st = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-11.8 * na + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (na, 3)),
                    stress=0.5 * (st + st.T)))


def settings(root):
    s = synthetic.ace_settings(root, groups=[])
    s["ACE"] = dict(ACE)
    s["GROUPS"].update(GROUPS)
    return s


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("acefit")
    data = root / "JSON"
    data.mkdir()
    write_configs(data, 23)
    s = settings(data)
    cwd = os.getcwd()
    out = {}
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
        # the port's writer on the JAX coefficients
        (root / "port_on_jax").mkdir()
        os.chdir(root / "port_on_jax")
        out["port"].output.write_potential(np.asarray(out["jax"].fit))
    finally:
        os.chdir(cwd)
    out["root"] = root
    return out


def rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_linear_system_matches_jax(fits):
    port, ref = fits["port"], fits["jax"]
    assert type(port.calculator).__name__ == "AceCalculator"
    assert port.a.shape == ref.a.shape and port.a.shape[1] > 10
    assert rel(port.a, ref.a) <= 1e-12
    assert rel(port.b, ref.b) <= 1e-12
    assert rel(port.w, ref.w) <= 1e-12
    for key in ("Groups", "Configs", "Row_Type", "Atom_I", "Atom_Type",
                "Testing"):
        assert list(port.fs_dict[key]) == list(ref.fs_dict[key]), key
    sec = port.config.sections["ACE"]
    assert sec.ncoeff == port.a.shape[1] - 1
    assert sec.blist == ref.config.sections["ACE"].blist


def test_coefficients_match_jax(fits):
    port, ref = fits["port"], fits["jax"]
    train = ~np.asarray(ref.fs_dict["Testing"])
    aw = ref.w[train][:, None] * ref.a[train]
    sv = np.linalg.svd(aw, compute_uv=False)
    assert sv[0] / sv[-1] < 1e8
    assert np.isfinite(port.fit).all()
    assert rel(port.fit, ref.fit) <= 1e-10


def shape(text):
    """The text with each number replaced by # and runs of blanks (the
    padding of the left-aligned coefficients) made one."""
    return re.sub(r" +", " ", NUMBER.sub("#", text))


@pytest.mark.parametrize("ext", [".acecoeff", ".yace"])
def test_written_potential_matches_jax(fits, ext):
    root = fits["root"]
    jax_text = (root / "jax" / f"Ta_pot{ext}").read_text()
    port_text = (root / "port" / f"Ta_pot{ext}").read_text()
    same_coeffs = (root / "port_on_jax" / f"Ta_pot{ext}").read_text()
    if ext == ".acecoeff":
        assert jax_text.startswith("# fitsnap_tpu ACE fit")
        assert port_text.startswith("# fitsnap_tpu_torch ACE fit")
        jax_text, port_text, same_coeffs = (
            x.split("\n", 1)[1] for x in (jax_text, port_text, same_coeffs))
    assert same_coeffs == jax_text
    assert shape(port_text) == shape(jax_text)
    nums = [np.array([float(x) for x in NUMBER.findall(s)])
            for s in (port_text, jax_text)]
    assert len(nums[0]) >= 16 and rel(*nums) <= 1e-10
    if ext == ".yace":
        assert (root / "port" / "Ta_pot.mod").exists()


def test_yace_reads_back(fits):
    """Descriptors with the plan of the port's own `.yace` are the fitted
    plan's times the label coefficients (the constant column is E0)."""
    port = fits["port"]
    plan = port.calculator.plan
    yplan = plan_from_yace(fits["root"] / "port" / "Ta_pot.yace")
    assert [lab[:4] for lab in yplan.labels] == \
        [lab[:4] for lab in plan.labels]
    assert yplan.nradbase == plan.nradbase and yplan.lmax == plan.lmax
    np.testing.assert_allclose(yplan.rcut, plan.rcut)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(6, 20, 3))
    d *= rng.uniform(1.5, 5.0, (6, 20, 1)) / np.linalg.norm(
        d, axis=-1, keepdims=True)
    mask = torch.as_tensor(np.linalg.norm(d, axis=-1) < 4.6)
    args = (torch.as_tensor(d), torch.zeros((6, 20), dtype=torch.int32),
            mask, torch.zeros(6, dtype=torch.int32))
    B, G = ace_descriptors_with_jacobian(*args, plan)
    yB, yG = ace_descriptors_with_jacobian(*args, yplan)
    beta = torch.as_tensor(np.asarray(port.fit)[1:])
    assert rel(yB, B * beta) <= 1e-12
    assert rel(yG, G * beta[None, :, None, None]) <= 1e-12
    e0 = re.search(r"E0: \[([^\]]*)\]",
                   (fits["root"] / "port" / "Ta_pot.yace").read_text())
    assert float(e0.group(1)) == pytest.approx(float(port.fit[0]), rel=1e-15)


def test_cli_ace_fit_on_cpu(tmp_path):
    data = tmp_path / "JSON"
    data.mkdir()
    write_configs(data, 5)
    synthetic.write_ini(tmp_path / "ace.in", settings(data))
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "ace.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for ext in (".acecoeff", ".yace", ".mod"):
        assert (tmp_path / f"Ta_pot{ext}").exists(), ext
    assert "pace" in (tmp_path / "Ta_pot.mod").read_text()
