"""The port's tools against the JAX package's (CPU, float64).

Each tool and its JAX twin get the same inputs:
- `group_tools`: the group table and both validation splits;
- `config_convert`: the INI text of a settings dict and its round trip;
- `ace_defaults`: the [ACE] strings, bond ranges and ZBL block;
- `vasp2json`: the JSON of a seeded OUTCAR and vasprun.xml, and the XYZ
  of the latter;
- `potential_tools`: MAE and RMSE of a written `.snapcoeff` read back on
  the same set (1e-10 relative);
- `dataframe_tools` on both packages' `dump_dataframe` pickles, and
  `nn_tools` on both NN solvers' per-config and per-atom dumps of the same
  predictions (1e-10 relative), plots included.
Then the port's torch finite-difference force harness on a small
precompute NN on the CPU: the mean error within the bound of
`tests/test_tools.py` (1e-5).
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.tools import synthetic
from tests.test_torch_output_styles import settings as style_settings
from tests.test_torch_output_styles import write_configs
from tests.test_torch_scrapers import cwd, outcar_text


def close(port, ref, rtol=1e-10):
    """Nested dicts of numbers: the same keys, each number within rtol of
    its twin (NaN matches NaN)."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys()
        for k in ref:
            close(port[k], ref[k], rtol)
    elif isinstance(ref, np.ndarray) and ref.dtype.kind in "fi":
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(port - ref).max() <= rtol * scale
    elif isinstance(ref, np.ndarray):
        assert np.array_equal(port, ref)
    elif isinstance(ref, float):
        assert (np.isnan(port) and np.isnan(ref)) or \
            abs(port - ref) <= rtol * max(abs(ref), 1e-300), (port, ref)
    else:
        assert port == ref


def test_group_tools():
    from fitsnap_tpu.tools import group_tools as jax_gt
    from fitsnap_tpu_torch.tools import group_tools as gt

    spec = {"group_sections": ["name", "training_size", "testing_size",
                               "eweight", "fweight", "vweight"],
            "A": ["A", 0.7, 0.3, 1.0, 1.0, 1e-8],
            "B": ["B", 0.5, 0.5, 2.0, 1.0, 1e-6]}
    assert gt.make_table(spec) == jax_gt.make_table(spec)
    for random_test in (False, True):
        tables = []
        for mod in (jax_gt, gt):
            random.seed(5)
            table = {"A": {"nconfigs": 10, "testing_size": 0.3},
                     "B": {"nconfigs": 7, "testing_size": 0.5}}
            mod.assign_validation(table, random_test=random_test)
            tables.append(table)
        assert tables[1] == tables[0]
        assert len(tables[1]["A"]["test_bools"]) == 10


def test_config_convert_round_trip(tmp_path):
    from fitsnap_tpu.tools import config_convert as jax_cc
    from fitsnap_tpu_torch.tools import config_convert as cc

    s = synthetic.nn_settings("JSON")
    s["GROUPS"]["Bulk"] = [0.7, 0.3, 100.0, 1.0, 1e-4]
    text = cc.settings_dict_to_input(s, str(tmp_path / "port.in"))
    assert text == jax_cc.settings_dict_to_input(s, str(tmp_path / "j.in"))
    back = cc.input_to_settings_dict(str(tmp_path / "port.in"))
    assert back == jax_cc.input_to_settings_dict(str(tmp_path / "j.in"))
    assert back["GROUPS"]["Bulk"] == "0.7 0.3 100.0 1.0 0.0001"
    cc.settings_dict_to_input(back, str(tmp_path / "rt.in"))
    assert cc.input_to_settings_dict(str(tmp_path / "rt.in")) == back


@pytest.mark.parametrize("elems", [["Ta"], ["In", "P"], ["C", "Ta"],
                                   ["N", "W"], ["Fe", "Ni", "O"]])
def test_ace_defaults(elems):
    from fitsnap_tpu.tools.ace_defaults import default_ace_settings as jax_d
    from fitsnap_tpu_torch.tools.ace_defaults import default_ace_settings

    for kw in ({}, {"nshell": 1.8, "metal_max": False}):
        port, ref = default_ace_settings(elems, **kw), jax_d(elems, **kw)
        assert port == ref
        assert port["rcutfac"].count(".") == len(elems) ** 2
    with pytest.raises(ValueError, match="alphabetically"):
        default_ace_settings(["P", "In"])


VASPRUN = """<?xml version="1.0" encoding="ISO-8859-1"?>
<modeling>
 <parameters>
  <separator name="electronic">
   <separator name="electronic convergence">
    <i type="int" name="NELM">    3</i>
   </separator>
  </separator>
 </parameters>
 <atominfo>
  <array name="atoms">
   <set>
{atoms}
   </set>
  </array>
 </atominfo>
{calcs}
</modeling>
"""


def vasprun_text(rng, n=4, steps=3):
    """A vasprun.xml of `steps` ionic steps of an n-atom cell; the second
    runs its SCF loop to NELM (unconverged)."""
    atoms = "\n".join(f"    <rc><c>{e}</c><c>{i % 2 + 1}</c></rc>"
                      for i, e in enumerate(["In", "P"] * (n // 2)))
    calcs = []
    for step in range(steps):
        basis = np.eye(3) * 5.87 + rng.normal(0.0, 0.02, (3, 3))
        frac = rng.uniform(0.0, 1.0, (n, 3))

        def varray(name, rows):
            return (f'  <varray name="{name}">\n' + "\n".join(
                "   <v>" + " ".join(f"{x:.8f}" for x in r) + "</v>"
                for r in rows) + "\n  </varray>")

        scsteps = "\n".join("  <scstep/>" for _ in range(
            3 if step == 1 else 2))
        calcs.append(
            " <calculation>\n" + scsteps + "\n  <structure>\n"
            "   <crystal>\n" + varray("basis", basis) + "\n   </crystal>\n"
            + varray("positions", frac) + "\n  </structure>\n"
            + varray("forces", rng.normal(0.0, 0.3, (n, 3))) + "\n"
            + varray("stress", rng.normal(0.0, 3.0, (3, 3))) + "\n"
            f'  <energy>\n   <i name="e_0_energy">{-4.1 * n + step:.8f}'
            "</i>\n  </energy>\n </calculation>")
    return VASPRUN.format(atoms=atoms, calcs="\n".join(calcs))


def json_files(folder):
    """{name: the JSON object after the header line} of a folder."""
    out = {}
    for p in sorted(folder.glob("*.json")):
        lines = p.read_text().splitlines()
        assert lines[0].startswith("# Generated by ")
        out[p.name] = json.loads("\n".join(lines[1:]))
    return out


def test_vasp2json(tmp_path):
    from fitsnap_tpu.tools import vasp2json as jax_v2j
    from fitsnap_tpu_torch.tools import vasp2json as v2j

    rng = np.random.default_rng(9)
    (tmp_path / "Bulk").mkdir()
    outcar = tmp_path / "Bulk" / "OUTCAR"
    outcar.write_text(outcar_text(rng, 4, 3))
    xml = tmp_path / "vasprun.xml"
    xml.write_text(vasprun_text(rng))
    for name, mod in (("jax", jax_v2j), ("port", v2j)):
        docs = mod.outcar_to_json(str(outcar), str(tmp_path / name / "o_"))
        assert len(docs) == 3
        docs = mod.vasprun_to_json(str(xml), str(tmp_path / name / "x_"))
        assert len(docs) == 2       # the NELM step is skipped
        assert mod.main([str(xml), str(tmp_path / name / "v.xyz")]) == 0
    ref = json_files(tmp_path / "jax")
    assert sorted(ref) == ["o_1.json", "o_2.json", "o_3.json", "x_1.json",
                           "x_3.json"]
    assert json_files(tmp_path / "port") == ref
    assert (tmp_path / "port" / "v.xyz").read_text() == \
        (tmp_path / "jax" / "v.xyz").read_text()


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Both FitSnaps on one small SNAP set (metrics MD, dump_dataframe),
    each in its own folder."""
    from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
    from fitsnap_tpu_torch import FitSnap

    root = tmp_path_factory.mktemp("tool_fits")
    write_configs(root / "JSON", 21)
    s = style_settings(root / "JSON", "MD")
    # potential_tools reads a .snapcoeff back only under bzeroflag 1 (in
    # both packages: under 0 it drops the constant column's coefficient)
    s["BISPECTRUM"]["bzeroflag"] = 1
    out = {"settings": s, "root": root}
    for name, make in (
            ("port", lambda: FitSnap(s, arglist=["--overwrite"],
                                     device="cpu")),
            ("jax", lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
        with cwd(root / name):
            fs = make()
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
            fs.write_output()
            out[name] = fs
    return out


def test_potential_tools(fits):
    """Each package's PotentialTools reads the `.snapcoeff` its fit wrote
    back and scores it on the same set."""
    from fitsnap_tpu.tools.potential_tools import PotentialTools as JaxPT
    from fitsnap_tpu_torch.tools.potential_tools import PotentialTools

    out = {}
    for name, make in (("jax", lambda: JaxPT(fits["settings"])),
                       ("port", lambda: PotentialTools(fits["settings"],
                                                       device="cpu"))):
        with cwd(fits["root"] / name):
            out[name] = make().calculate()
    port, ref = out["port"], out["jax"]
    assert {"energy_mae", "energy_rmse", "force_mae", "force_rmse",
            "stress_mae", "stress_rmse"} <= set(port)
    close(port, ref)
    fs = fits["port"]
    pred = fs.a @ fs.fit
    assert np.abs(port["predictions"] - pred).max() <= \
        1e-12 * np.abs(pred).max()


def test_dataframe_tools(fits, tmp_path):
    from fitsnap_tpu.tools.dataframe_tools import DataframeTools as JaxDT
    from fitsnap_tpu_torch.tools.dataframe_tools import DataframeTools

    port = DataframeTools(str(fits["root"] / "port" / "Ta.df"))
    ref = JaxDT(str(fits["root"] / "jax" / "Ta.df"))
    assert list(port.natoms_per_config()) == list(ref.natoms_per_config())
    for quantity in ("Energy", "Force", "Stress"):
        for fitting_set in ("Training", "Testing"):
            for metric in ("mae", "rmse"):
                for group_set in (None, "Super"):
                    kw = dict(fitting_set=fitting_set, metric=metric,
                              group_set=group_set)
                    close(port.calc_error(quantity, **kw),
                          ref.calc_error(quantity, **kw))
    close(port.calc_error("Energy", "Training", peratom=False),
          ref.calc_error("Energy", "Training", peratom=False))
    port.plot_agreement("Energy", "Training", mode="Linear",
                        fname=str(tmp_path / "agree.png"))
    port.plot_agreement("Force", "Training", mode="Distribution",
                        fname=str(tmp_path / "dist.png"))
    assert (tmp_path / "agree.png").exists() and \
        (tmp_path / "dist.png").exists()
    with pytest.raises(ValueError, match="mode"):
        port.plot_agreement("Force", "Training", mode="Scatter")


def nn_dumps(tmp_path, seed=4):
    """Each NN solver's per-config and per-atom dumps of the same
    predictions and targets, through its `error_analysis`."""
    from fitsnap_tpu.solvers.network import NetworkSolver as JaxSolver
    from fitsnap_tpu_torch.solvers.network import NetworkSolver

    rng = np.random.default_rng(seed)
    buckets = []
    for n, A in ((3, 2), (4, 5)):
        nat = rng.integers(1, A + 1, n)
        buckets.append({
            "e": rng.normal(size=n), "f": rng.normal(size=(n, A, 3)),
            "e_target": rng.normal(size=n),
            "f_target": rng.normal(size=(n, A, 3)),
            "real": np.arange(A)[None, :] < nat[:, None],
            "types": rng.integers(0, 2, (n, A)).astype(np.int32),
            "nat_host": nat,
            "groups": [("Bulk", "Liquid")[i % 2] for i in range(n)],
            "files": [f"c{n}_{i}.json" for i in range(n)],
            "test": np.array([i % 3 == 2 for i in range(n)])})
    paths = {}
    for name, cls, put in (("jax", JaxSolver, np.asarray),
                           ("port", NetworkSolver, torch.as_tensor)):
        paths[name] = (tmp_path / f"{name}_peratom.dat",
                       tmp_path / f"{name}_perconfig.dat")
        fake = SimpleNamespace(
            params=1, model=1, pas=False,
            evaluate_bucket=lambda ds: (ds["e"], ds["f"]),
            config=SimpleNamespace(sections={
                "EXTRAS": SimpleNamespace(dump_perconfig=1, dump_peratom=1),
                "OUTFILE": SimpleNamespace(peratom_file=str(paths[name][0]),
                                           perconfig_file=str(
                                               paths[name][1]))}),
            buckets=[dict(ds, **{k: put(ds[k]) for k in (
                "e_target", "f_target", "real", "types")})
                for ds in buckets])
        fake._dump_details = lambda f=fake, c=cls: c._dump_details(f)
        cls.error_analysis(fake)
    return paths


def test_nn_tools(tmp_path):
    from fitsnap_tpu.tools.nn_tools import NNTools as JaxNNTools
    from fitsnap_tpu_torch.tools.nn_tools import NNTools

    paths = nn_dumps(tmp_path)
    for p, r in zip(paths["port"], paths["jax"]):
        assert p.read_text() == r.read_text()
    port = NNTools(*map(str, paths["port"]))
    ref = JaxNNTools(*map(str, paths["jax"]))
    for quantity in ("Energy", "Force"):
        close(port.calc_errors(quantity), ref.calc_errors(quantity))
    port.plot_comparisons("Force", fname=str(tmp_path / "f.png"))
    assert (tmp_path / "f.png").exists()


def test_fd_harness_precompute_nn(tmp_path, monkeypatch):
    """TestTools.finite_difference on a small precompute NN fit on the
    CPU (reference tools/test_tools.py usage pattern)."""
    from fitsnap_tpu_torch.tools.test_tools import TestTools

    monkeypatch.chdir(tmp_path)
    files = synthetic.write_dataset(
        tmp_path / "JSON", synthetic.ta_configs(0, {"Displaced_FCC": 6}))
    assert len(files) == 6
    s = synthetic.nn_settings(tmp_path / "JSON", groups=["Displaced_FCC"])
    s["BISPECTRUM"]["twojmax"] = 4
    tt = TestTools(s, device="cpu")
    assert tt.fs.solver.device.type == "cpu"
    mean_err, max_err, details = tt.finite_difference(
        "Displaced_FCC", config_index=0, max_atoms=2)
    assert len(details) == 6
    assert mean_err < 1e-5
    assert max_err < 1e-4
    assert tt.fs.solver.net.num_epochs == 2 and len(tt.fs.solver.history)
    # the model's forces are not all zero, so the check is not empty
    assert max(abs(d[3]) for d in details) > 1e-6
