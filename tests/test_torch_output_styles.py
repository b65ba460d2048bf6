"""The port's JSON and DF metric styles, `dump_dataframe` and
`--torchprof` against the JAX package (CPU, float64).

- Error tables from the same inputs (the linear table from the same rows,
  the NN and PAS tables from the same per-config predictions through each
  package's `error_analysis`): the port's JSON text equals pandas'
  `to_json` of the JAX table byte for byte, and its DataFrame equals the
  JAX one exactly.
- Both `SnapOutput.write_errors` in the JSON and DF styles on those
  tables: the JSON files are equal text, the DF pickles equal frames.
- Both `FitSnap`s end to end on one small SNAP set with metrics style
  JSON, then DF, with `dump_dataframe`: the JSON metrics parse to the same
  object with every number within 1e-12 relative, the DF and the dumped
  DataFrame pickles are equal frames (`pandas.testing`, rtol 1e-12).
- `python -m fitsnap_tpu_torch ... --torchprof DIR` on the CPU writes a
  Chrome trace into DIR, also when the run raises.
"""

import json
import os
import runpy
import sys
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pandas.testing as pdt
import pytest
import torch

from fitsnap_tpu_torch.tools import synthetic

GROUPS = {"Small": "0.5 0.5 100.0 1.0 1e-4",
          "Super": "0.75 0.25 100.0 1.0 1e-4"}


def write_configs(root, seed):
    """Four 2-atom and four 16-atom bcc cells with seeded truths."""
    rng = np.random.default_rng(seed)
    for group, reps in (("Small", (1, 1, 1)), ("Super", (2, 2, 2))):
        (root / group).mkdir(parents=True)
        for i in range(4):
            pos, cell0 = synthetic.supercell(synthetic.BCC,
                                             rng.uniform(3.15, 3.45), reps)
            cell = synthetic.strained(cell0, rng, 0.03)
            pos = pos @ np.linalg.solve(cell0, cell) \
                + rng.normal(0.0, 0.08, pos.shape)
            n = len(pos)
            s = rng.normal(0.0, 2e3, (3, 3))
            (root / group / f"{group}_{i}.json").write_text(
                synthetic.config_json(
                    pos, cell, energy=-11.8 * n + rng.normal(0.0, 0.5),
                    forces=rng.normal(0.0, 0.3, (n, 3)),
                    stress=0.5 * (s + s.T)))


def settings(root, style):
    s = synthetic.ta_settings(root, groups=[])
    s["BISPECTRUM"]["twojmax"] = 4
    s["GROUPS"].update(GROUPS)
    s["OUTFILE"] = {"metrics": "Ta_metrics", "potential": "Ta_pot",
                    "metrics_style": style, "dataframe": "Ta.df"}
    s["EXTRAS"] = {"dump_dataframe": 1}
    return s


# ---------------- tables from the same inputs ----------------


def linear_tables(seed=2):
    """The JAX Solver's and the port's linear error table of the same
    truths, predictions, weights and rows."""
    from fitsnap_tpu.solvers.solver import Solver as JaxSolver
    from fitsnap_tpu_torch.solvers.solver import error_table

    rng = np.random.default_rng(seed)
    n, width = 60, 4
    a = rng.normal(size=(n, width))
    fit = rng.normal(size=width)
    b = a @ fit + rng.normal(0.0, 1e-3, n)
    w = rng.uniform(0.5, 2.0, n)
    w[::7] = 0.0
    fs_dict = {"Groups": [("g1", "g2", "Liq")[i % 3] for i in range(n)],
               "Testing": [i % 4 == 0 for i in range(n)],
               "Row_Type": [("Energy", "Force", "Force", "Stress")[i % 4]
                            for i in range(n)]}
    cfg = SimpleNamespace(sections={
        "EXTRAS": SimpleNamespace(dump_dataframe=0),
        "CALCULATOR": SimpleNamespace(calculator="LAMMPSSNAP"),
        "BISPECTRUM": SimpleNamespace(bzeroflag=0)})
    jax = JaxSolver("SVD", cfg)
    jax.fit = fit
    jax.error_analysis(a, b, w, fs_dict)
    port = error_table(b, a @ fit, w, fs_dict["Groups"], fs_dict["Testing"],
                       fs_dict["Row_Type"])
    return jax.errors, port


def nn_tables(pas, seed=3):
    """The JAX NN solver's and the port's error table (PAS: per-atom
    scalars) through each `error_analysis`, on the same buckets of
    predictions and targets."""
    from fitsnap_tpu.solvers.network import NetworkSolver as JaxSolver
    from fitsnap_tpu_torch.solvers.network import NetworkSolver

    rng = np.random.default_rng(seed)
    buckets = []
    for n, A in ((3, 2), (4, 5)):
        real = np.arange(A)[None, :] < rng.integers(1, A + 1, n)[:, None]
        buckets.append({
            "e": rng.normal(size=n), "f": rng.normal(size=(n, A, 3)),
            "p": rng.normal(size=(n, A)),
            "e_target": rng.normal(size=n),
            "f_target": rng.normal(size=(n, A, 3)),
            "pas_target": rng.normal(size=(n, A)), "real": real,
            "groups": [("Bulk", "Liquid", "Surf")[i % 3] for i in range(n)],
            "test": np.array([i % 2 == 1 for i in range(n)])})
    extras = SimpleNamespace(dump_perconfig=0, dump_peratom=0)

    def evaluate(ds):
        return (ds["p"], None) if pas else (ds["e"], ds["f"])

    out = []
    for cls, put in ((JaxSolver, np.asarray), (NetworkSolver,
                                               torch.as_tensor)):
        fake = SimpleNamespace(
            params=1, model=1, pas=pas, evaluate_bucket=evaluate,
            config=SimpleNamespace(sections={"EXTRAS": extras}),
            buckets=[dict(ds, **{k: put(ds[k]) for k in (
                "e_target", "f_target", "pas_target", "real")})
                for ds in buckets])
        fake._error_analysis_pas = lambda f=fake, c=cls: \
            c._error_analysis_pas(f)
        cls.error_analysis(fake)
        out.append(fake.errors)
    return out


TABLES = {"linear": linear_tables, "nn": lambda: nn_tables(False),
          "pas": lambda: nn_tables(True)}


@pytest.mark.parametrize("kind", list(TABLES))
def test_table_json_and_frame(kind):
    jax, port = TABLES[kind]()
    assert len(port) == len(jax) > 2
    assert port.to_json() == jax.to_json()
    pdt.assert_frame_equal(port.to_dataframe(), jax, check_exact=True)


def output_config(tmp_path, style, name):
    return SimpleNamespace(sections={"OUTFILE": SimpleNamespace(
        metric_file=str(tmp_path / name), metrics_style=style)})


@pytest.mark.parametrize("kind", list(TABLES))
def test_write_errors_json_and_df(kind, tmp_path):
    from fitsnap_tpu.io.outputs.snap_output import SnapOutput as JaxOutput
    from fitsnap_tpu_torch.io.outputs.snap_output import SnapOutput

    jax, port = TABLES[kind]()
    for style in ("JSON", "DF"):
        JaxOutput("SNAP", output_config(tmp_path, style, "jax")) \
            .write_errors(jax)
        SnapOutput("SNAP", output_config(tmp_path, style, "port")) \
            .write_errors(port)
        if style == "JSON":
            text = (tmp_path / "port").read_text()
            assert text == (tmp_path / "jax").read_text()
            assert json.loads(text).keys() == set(port.columns)
        else:
            pdt.assert_frame_equal(pd.read_pickle(tmp_path / "port"),
                                   pd.read_pickle(tmp_path / "jax"),
                                   check_exact=True)


# ---------------- end to end ----------------


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both FitSnaps on the same set, metrics style JSON then DF, with
    dump_dataframe."""
    from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
    from fitsnap_tpu_torch import FitSnap

    root = tmp_path_factory.mktemp("styles")
    write_configs(root / "JSON", 17)
    cwd = os.getcwd()
    out = {}
    try:
        for style in ("JSON", "DF"):
            s = settings(root / "JSON", style)
            for name, make in (
                    ("port", lambda: FitSnap(s, arglist=["--overwrite"],
                                             device="cpu")),
                    ("jax", lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
                (root / style / name).mkdir(parents=True)
                os.chdir(root / style / name)
                fs = make()
                fs.scrape_configs()
                fs.process_configs()
                fs.perform_fit()
                fs.write_output()
                out[style, name] = root / style / name
    finally:
        os.chdir(cwd)
    return out


def numbers_close(port, ref, rtol):
    """Two parsed JSON objects: the same keys, and each number within rtol
    of its twin, relative to the larger of the two (null stays null)."""
    assert type(port) is type(ref)
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            numbers_close(port[k], ref[k], rtol)
    elif isinstance(ref, float):
        assert abs(port - ref) <= rtol * max(abs(port), abs(ref)), \
            (port, ref)
    else:
        assert port == ref


def test_fitsnap_json_metrics(fits):
    port = json.loads((fits["JSON", "port"] / "Ta_metrics").read_text())
    ref = json.loads((fits["JSON", "jax"] / "Ta_metrics").read_text())
    assert set(ref) == {"ncount", "mae", "rmse", "rsq"}
    assert len(ref["mae"]) == 2 * 2 * 3 * 3
    numbers_close(port, ref, 1e-12)


def frames_close(port, ref, rtol):
    """Equal frames: dtypes, index and columns exactly; numbers within
    rtol of the larger magnitude of their column."""
    pdt.assert_index_equal(port.columns, ref.columns)
    pdt.assert_index_equal(port.index, ref.index)
    pdt.assert_series_equal(port.dtypes, ref.dtypes)
    for c in ref.columns:
        if pd.api.types.is_numeric_dtype(ref[c]):
            scale = max(np.abs(ref[c].to_numpy(float)).max(), 1e-300)
            pdt.assert_series_equal(port[c], ref[c], check_exact=False,
                                    rtol=rtol, atol=rtol * scale)
        else:
            pdt.assert_series_equal(port[c], ref[c])


def test_fitsnap_df_metrics(fits):
    port = pd.read_pickle(fits["DF", "port"] / "Ta_metrics")
    ref = pd.read_pickle(fits["DF", "jax"] / "Ta_metrics")
    assert list(ref.index.names) == ["Group", "Weighting", "Testing",
                                     "Subsystem"]
    frames_close(port, ref, 1e-12)


@pytest.mark.parametrize("style", ["JSON", "DF"])
def test_fitsnap_dump_dataframe(fits, style):
    port = pd.read_pickle(fits[style, "port"] / "Ta.df")
    ref = pd.read_pickle(fits[style, "jax"] / "Ta.df")
    assert {"truths", "preds", "weights", "Groups", "Testing", "Row_Type",
            "Configs", "Atom_I", "Atom_Type"} <= set(ref.columns)
    assert len(ref) == 8 + 3 * (4 * 2 + 4 * 16) + 6 * 8
    frames_close(port, ref, 1e-12)


# ---------------- --torchprof ----------------


def run_cli(tmp_path, monkeypatch, s, prof):
    from fitsnap_tpu_torch.tools.config_convert import settings_dict_to_input

    monkeypatch.chdir(tmp_path)
    settings_dict_to_input(s, str(tmp_path / "prof.in"))
    monkeypatch.setattr(sys, "argv", [
        "fitsnap_tpu_torch", str(tmp_path / "prof.in"), "--overwrite",
        "--device", "cpu", "--torchprof", str(prof)])
    runpy.run_module("fitsnap_tpu_torch", run_name="__main__")


def read_trace(prof):
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    return json.loads(traces[0].read_text())["traceEvents"]


def test_torchprof_writes_trace(tmp_path, monkeypatch):
    """--torchprof DIR captures a torch.profiler trace of the CLI run."""
    write_configs(tmp_path / "JSON", 5)
    s = settings(tmp_path / "JSON", "MD")
    s["EXTRAS"] = {}
    run_cli(tmp_path, monkeypatch, s, tmp_path / "trace")
    events = read_trace(tmp_path / "trace")
    assert any(e.get("name") == "aten::mm" for e in events)
    assert (tmp_path / "Ta_pot.snapcoeff").exists()


def test_torchprof_writes_trace_when_the_run_raises(tmp_path, monkeypatch):
    s = settings(tmp_path / "missing", "MD")
    s["EXTRAS"] = {}
    with pytest.raises(Exception):
        run_cli(tmp_path, monkeypatch, s, tmp_path / "trace")
    assert isinstance(read_trace(tmp_path / "trace"), list)
