"""fitsnap_tpu_torch.FitSnap against fitsnap_tpu.FitSnap end to end (CPU,
float64).

Eight small bcc Ta configs (2 and 16 atoms, seeded jitter and strain, seeded
truths) in two groups with train/test fractions go through both facades:
scrape -> process_configs -> perform_fit -> write_output, with
`random_sampling 0` so that both make the same train/test split.

Tolerances: the linear system (a, b, w) to 1e-12 relative to the largest
magnitude, the per-row bookkeeping exactly, the coefficients to 1e-10
relative (lstsq amplifies the 1e-16-level differences of a by the
condition number of the weighted system), every number of the grouped
error table to 1e-12 relative (see `test_error_table_end_to_end` for the
scale), and the written .snapcoeff values to the same 1e-10.
"""

import os

import numpy as np
import pytest
import torch

from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
from fitsnap_tpu_torch import FitSnap
from fitsnap_tpu_torch.convert import coeffs_from_numpy
from fitsnap_tpu_torch.solvers.solver import error_table
from fitsnap_tpu_torch.tools import synthetic

GROUPS = {"Small": "0.5 0.5 100.0 1.0 1e-4",
          "Super": "0.75 0.25 100.0 1.0 1e-4"}


def write_configs(root, seed):
    """Four 2-atom and four 16-atom bcc cells with random truths."""
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
            stress = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-11.8 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (stress + stress.T)))


def settings(root):
    s = synthetic.ta_settings(root, groups=[])
    s["GROUPS"].update(GROUPS)
    s["OUTFILE"] = {"metrics": "Ta_metrics.md", "potential": "Ta_pot"}
    return s


def run(fs):
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    return fs


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    data = root / "JSON"
    data.mkdir()
    write_configs(data, 17)
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
            out[name] = run(make())
    finally:
        os.chdir(cwd)
    out["root"] = root
    return out


def rel(port, ref):
    port, ref = np.asarray(port, float), np.asarray(ref, float)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", ["a", "b", "w"])
def test_linear_system(fits, name):
    assert rel(getattr(fits["port"], name), getattr(fits["jax"], name)) \
        <= 1e-12


def test_fs_dict(fits):
    port, ref = fits["port"].fs_dict, fits["jax"].fs_dict
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert list(port[key]) == list(ref[key]), key
    assert any(port["Testing"]) and not all(port["Testing"])


def test_coefficients(fits):
    port, ref = fits["port"].solver.fit, fits["jax"].solver.fit
    assert port.shape == (31,)
    assert rel(port, ref) <= 1e-10


def test_jax_coefficients_on_port_rows(fits):
    """The JAX fit, carried across with `coeffs_from_numpy`, predicts the
    same values from the port's rows as from its own."""
    jfs = fits["jax"]
    beta = coeffs_from_numpy(jfs.solver.fit)
    assert beta.dtype == torch.float64 and beta.device.type == "cpu"
    preds = torch.from_numpy(fits["port"].a) @ beta
    assert rel(preds.numpy(), jfs.a @ jfs.solver.fit) <= 1e-12


def test_process_single(fits):
    """Library mode: one config's rows equal its block of the full system."""
    port = fits["port"]
    data = port.data[0]
    a, b, w = port.calculator.process_single(data)
    n = 1 + 3 * data["NumAtoms"] + 6
    assert a.shape == (n, 31)
    assert rel(a, port.a[:n]) <= 1e-12
    assert rel(b, port.b[:n]) <= 1e-12
    np.testing.assert_array_equal(w, port.w[:n])


def _table_close(port, ref, floor=0.0):
    """Same index and ncount; every number within 1e-12 of the JAX value,
    relative to max(|value|, floor)."""
    assert port.index == list(ref.index)
    want = ref[list(port.columns)].to_numpy(float)
    assert port.values.shape == want.shape
    assert (port.values[:, 0] == want[:, 0]).all()
    both = np.isfinite(want)
    assert (np.isfinite(port.values) == both).all()
    scale = np.maximum(np.abs(want[both]), max(floor, 1e-300))
    assert (np.abs(port.values[both] - want[both]) / scale).max() <= 1e-12


def test_error_table_from_jax_rows(fits):
    """The numpy error table of the port, fed the JAX package's rows and
    coefficients, equals its pandas table number by number."""
    jfs = fits["jax"]
    fs = jfs.fs_dict
    table = error_table(jfs.b, jfs.a @ jfs.solver.fit, jfs.w, fs["Groups"],
                        fs["Testing"], fs["Row_Type"])
    _table_close(table, jfs.solver.errors)


def test_error_table_end_to_end(fits):
    """The tables of the two fits.  A residual is a difference of truths
    and predictions, so 1e-16-level differences of the predictions show in
    an error metric relative to the predictions' magnitude, not the
    metric's: the floor of the relative scale is the largest |prediction|."""
    port, jfs = fits["port"], fits["jax"]
    floor = np.abs(jfs.a @ jfs.solver.fit).max()
    assert rel(port.a @ port.solver.fit, jfs.a @ jfs.solver.fit) <= 1e-12
    _table_close(port.solver.errors, jfs.solver.errors, floor)


def snapcoeff_values(path):
    return np.array([float(line.split()[0])
                     for line in path.read_text().splitlines()
                     if "#  B" in line])


def test_written_snapcoeff(fits):
    port = snapcoeff_values(fits["root"] / "port" / "Ta_pot.snapcoeff")
    ref = snapcoeff_values(fits["root"] / "jax" / "Ta_pot.snapcoeff")
    assert port.shape == (31,)
    assert rel(port, ref) <= 1e-10
    assert (fits["root"] / "port" / "Ta_metrics.md").read_text() \
        .startswith("| Group | Weighting | Testing | Subsystem |")
