"""fitsnap_tpu_torch stands alone: no JAX, no fitsnap_tpu, no silent CPU.

- Every module of the package imports in a fresh interpreter without
  bringing in `jax` or any `fitsnap_tpu` module.
- `FitSnap` with no device asks for CUDA and raises where there is none;
  `device="cpu"` or `--device cpu` runs on the CPU.
- Each kernel wrapper takes its plain version for CPU tensors (launching
  nothing) and raises for a device that is neither CPU nor CUDA.
- `kernels/csrc/` holds one CUDA source for each of K1-K5, K6q, K7, K8
  (K8r shares K8's), K12 (K12T and the force gather share it), K13, K14,
  K9 with K11 and K11T (`nn_grid.cu`), K10 with K10T (`nn_dedu.cu`) and
  K15 with K15V and K15T (`pair_desc.cu`), each naming the JAX function it
  replaces, built for sm_90a; the chemflag modes of K1-K3 share their
  sources.
- `FitSnap` fits on the CPU with every linear solver the port registers:
  the device ones and the host ones (SVD, RIDGE, LASSO, ARD, ANL, BCS,
  MCMC, OPT, MERR).
- With sklearn, pandas and matplotlib blocked, as on the machine with the
  card, every module imports and `FitSnap` fits on the CPU with the XYZ
  and VASP scrapers and every solver that needs no sklearn; LASSO and ARD
  raise ModuleNotFoundError naming sklearn, the DF metric style pandas.
- `chip_smoke.py` exits non-zero and prints no result without a card.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from fitsnap_tpu_torch.kernels import build
from fitsnap_tpu_torch.kernels import snap_kernels as sk
from fitsnap_tpu_torch.tools import synthetic

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "fitsnap_tpu_torch"


def run_python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def all_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_imports_neither_jax_nor_fitsnap_tpu():
    mods = all_modules()
    assert {"fitsnap_tpu_torch.kernels.snap_kernels",
            "fitsnap_tpu_torch.kernels.ace_kernels",
            "fitsnap_tpu_torch.ops.ace", "fitsnap_tpu_torch.ops.ace_ref_basis",
            "fitsnap_tpu_torch.calculators.ace",
            "fitsnap_tpu_torch.io.outputs.pace_output",
            "fitsnap_tpu_torch.kernels.nn_kernels",
            "fitsnap_tpu_torch.models.mlp",
            "fitsnap_tpu_torch.solvers.network",
            "fitsnap_tpu_torch.io.export_torch",
            "fitsnap_tpu_torch.ops.custom_desc",
            "fitsnap_tpu_torch.kernels.custom_kernels",
            "fitsnap_tpu_torch.calculators.custom",
            "fitsnap_tpu_torch.io.outputs.custom_output",
            "fitsnap_tpu_torch.scrapers.xyz_scraper",
            "fitsnap_tpu_torch.scrapers.vasp_scraper",
            "fitsnap_tpu_torch.scrapers.ase_funcs",
            "fitsnap_tpu_torch.solvers.linear",
            "fitsnap_tpu_torch.solvers.merr",
            "fitsnap_tpu_torch.tools.config_convert",
            "fitsnap_tpu_torch.tools.group_tools",
            "fitsnap_tpu_torch.tools.ace_defaults",
            "fitsnap_tpu_torch.tools.vasp2json",
            "fitsnap_tpu_torch.tools.potential_tools",
            "fitsnap_tpu_torch.tools.dataframe_tools",
            "fitsnap_tpu_torch.tools.nn_tools",
            "fitsnap_tpu_torch.tools.test_tools"} <= set(mods)
    proc = run_python(f"""
        import importlib, json, sys
        for name in {mods!r}:
            importlib.import_module(name)
        import fitsnap_tpu_torch
        fitsnap_tpu_torch.FitSnap
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "fitsnap_tpu" or m.startswith("fitsnap_tpu."))
        print(json.dumps(bad))
    """)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_default_device_is_cuda_and_raises_without_one(tmp_path):
    """With CUDA reported absent, the default device raises and nothing
    falls back; asking for the CPU works."""
    root = tmp_path / "JSON"
    (root / "Cells").mkdir(parents=True)
    pos, cell = synthetic.supercell(synthetic.BCC, 3.3, (1, 1, 1))
    (root / "Cells" / "c.json").write_text(synthetic.config_json(pos, cell))
    s = synthetic.ta_settings(root, groups=[])
    s["GROUPS"]["Cells"] = "1.0 0.0 1.0 1.0 1.0"
    proc = run_python(f"""
        import torch
        torch.cuda.is_available = lambda: False
        from fitsnap_tpu_torch import FitSnap
        from fitsnap_tpu_torch.utils.torchsetup import resolve_device
        s = {s!r}
        for kwargs in (dict(), dict(device="cuda")):
            try:
                FitSnap(s, arglist=["--overwrite"], **kwargs)
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            else:
                raise SystemExit("FitSnap did not raise without CUDA")
        fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
        assert fs.device.type == "cpu"
        assert fs.calculator.params.L.device.type == "cpu"
        fs = FitSnap(s, arglist=["--overwrite", "--device", "cpu"])
        assert fs.device.type == "cpu"
        assert resolve_device("cpu").type == "cpu"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        print("ok")
    """, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_cli_fit_on_cpu(tmp_path):
    """`python -m fitsnap_tpu_torch input.in --overwrite --device cpu`
    writes the potential and the metrics."""
    root = tmp_path / "JSON"
    rng = np.random.default_rng(2)
    (root / "Cells").mkdir(parents=True)
    for i in range(3):
        pos, cell = synthetic.supercell(synthetic.BCC, 3.2 + 0.1 * i,
                                        (1, 1, 1))
        pos = pos + rng.normal(0.0, 0.05, pos.shape)
        (root / "Cells" / f"c{i}.json").write_text(synthetic.config_json(
            pos, cell, energy=-23.0 + i, forces=rng.normal(0, 0.1, (2, 3))))
    s = synthetic.ta_settings(root, groups=[])
    s["GROUPS"]["Cells"] = "1.0 0.0 1.0 1.0 1.0"
    synthetic.write_ini(tmp_path / "Ta.in", s)
    proc = subprocess.run(
        [sys.executable, "-m", "fitsnap_tpu_torch", "Ta.in", "--overwrite",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    lines = (tmp_path / "Ta_pot.snapcoeff").read_text().splitlines()
    assert lines[2].split() == ["1", "31"]
    assert (tmp_path / "Ta_metrics.md").exists()


def _k4_inputs(device):
    rng = np.random.default_rng(0)
    C, A, X, K, R = 1, 3, 2, 4, 5
    g = torch.as_tensor(rng.normal(size=(C, A, X, K, 3)), device=device)
    disp = torch.as_tensor(rng.normal(size=(C, A, K, 3)), device=device)
    mask = torch.ones((C, A, K), dtype=torch.bool, device=device)
    rev = torch.full((C, A, R), -1, dtype=torch.int32, device=device)
    types = torch.zeros((C, A), dtype=torch.int32, device=device)
    return g, disp, mask, rev, types, 1


def test_wrappers_take_plain_version_on_cpu():
    sk.reset_launches()
    args = _k4_inputs("cpu")
    out = sk.pair_scatter_rows(*args)
    ref = sk.pair_scatter_rows_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert set(sk.launches()) == {"pair_u_duals", "zlist", "dbdd",
                                  "pair_scatter_rows", "zbl_eav",
                                  "normal_contrib", "device_neighbors",
                                  "reverse_table", "pair_u_duals_chem",
                                  "zlist_chem", "dbdd_chem", "quad_chain"}
    assert set(sk.launches().values()) == {0}


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on another device (here `meta`) is refused, not computed
    with the plain version."""
    with pytest.raises(ValueError, match="no kernel for device"):
        sk.pair_scatter_rows(*_k4_inputs("meta"))
    with pytest.raises(ValueError, match="several devices"):
        g, disp, mask, rev, types, t = _k4_inputs("cpu")
        sk.pair_scatter_rows(g.to("meta"), disp, mask, rev, types, t)


def _new_kernel_calls(device):
    """A call of each of K5, K7, K8 and K8r on small inputs on `device`."""
    rng = np.random.default_rng(1)
    C, A, K, S, T, W = 1, 3, 4, 2, 1, 3

    def t(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    disp = t(rng.normal(size=(C, A, K, 3)))
    jidx = t(np.zeros((C, A, K)), torch.int32)
    mask = t(np.ones((C, A, K)), torch.bool)
    types = t(np.zeros((C, A)), torch.int32)
    natoms = t([A], torch.int32)
    rows = {"e_cols": t(np.ones((C, W))),
            "force_rows": t(np.ones((C, A, 3, W))),
            "virial_rows": t(np.ones((C, 6, W))), "ref_e": t(np.zeros(C)),
            "ref_f": t(np.zeros((C, A, 3))), "ref_v": t(np.zeros((C, 6)))}
    truths = (t(np.ones(C)), t(np.ones((C, A, 3))), t(np.ones((C, 6))))
    weights = (t(np.ones(C)),) * 3
    flags = {"energy": True, "force": True, "stress": True}
    pos = t(rng.uniform(0, 3, (C, A, 3)))
    svec = t(np.stack([np.zeros((C, 3)), np.full((C, 3), 3.0)], 1))
    return {
        "zbl_eav": lambda: sk.zbl_eav(
            disp, jidx, mask, t(np.full((C, A, K), -1), torch.int32), types,
            t(np.ones((T, T, 6))), 4.0, 4.8),
        "normal_contrib": lambda: sk.normal_contrib(
            rows, truths, weights, natoms, types, T, False, flags),
        "device_neighbors": lambda: sk.device_neighbors(
            pos, torch.zeros_like(pos), svec, torch.zeros_like(svec),
            natoms, 4.0, K),
        "reverse_table": lambda: sk.reverse_table(jidx, mask),
    }


@pytest.mark.parametrize("name", ["zbl_eav", "normal_contrib",
                                  "device_neighbors", "reverse_table"])
def test_new_wrappers_plain_on_cpu_and_raise_on_meta(name):
    """K5, K7, K8 and K8r run their plain version for CPU tensors without
    counting a launch, and refuse a `meta` tensor."""
    sk.reset_launches()
    out = _new_kernel_calls("cpu")[name]()
    assert all(torch.isfinite(x.double()).all() for x in out)
    assert sk.launches()[name] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        _new_kernel_calls("meta")[name]()


def _flag_kernel_calls(device):
    """A call of each of the chemflag modes of K1-K3 and of K6q on small
    inputs on `device`, with a two-element chemflag plan and a quadratic
    one (twojmax 2)."""
    from types import SimpleNamespace

    from fitsnap_tpu_torch.ops.snap import make_params

    def section(**flags):
        base = dict(twojmax=["2", "2"], numtypes=2, wj=["1.0", "0.9"],
                    radelem=["0.5", "0.45"], rcutfac=4.6, rfac0=0.99,
                    rmin0=0.0, chemflag=0, quadraticflag=0, bnormflag=0,
                    wselfallflag=0, bzeroflag=1, switchflag=1,
                    switchinnerflag=0, sinner=None, dinner=None)
        return SimpleNamespace(**dict(base, **flags))

    pc = make_params(section(chemflag=1), device)
    pq = make_params(section(quadraticflag=1), device)
    rng = np.random.default_rng(3)
    N, K, U = 2, 4, pc.u_len

    def t(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    disp = t(rng.normal(size=(N, K, 3)) + 2.0)
    jelem = t(rng.integers(0, 2, (N, K)), torch.int32)
    mask = t(np.ones((N, K)), torch.bool)
    ielem = t([0, 1], torch.int32)
    ut = t(rng.normal(size=(N, 2 * 2 * U)))
    z = t(rng.normal(size=(N, 4, pc.nz)))
    J = t(rng.normal(size=(3, N, K, 2 * U)))
    W = pq.nb_base
    return {
        "pair_u_duals_chem": lambda: sk.pair_u_duals_chem(
            disp, jelem, mask, ielem, pc),
        "zlist_chem": lambda: sk.zlist_chem(ut, pc),
        "dbdd_chem": lambda: sk.dbdd_chem(ut, z, z, J, jelem, pc),
        "quad_chain": lambda: sk.quad_chain(
            t(rng.normal(size=(N, W))), t(rng.normal(size=(N, W, K, 3))),
            pq),
    }


@pytest.mark.parametrize("name", ["pair_u_duals_chem", "zlist_chem",
                                  "dbdd_chem", "quad_chain"])
def test_flag_wrappers_plain_on_cpu_and_raise_on_meta(name):
    """The chemflag modes of K1-K3 and K6q run their plain version for CPU
    tensors without counting a launch, and refuse a `meta` tensor."""
    sk.reset_launches()
    out = _flag_kernel_calls("cpu")[name]()
    assert all(torch.isfinite(x).all() for x in out)
    assert sk.launches()[name] == 0
    with pytest.raises(ValueError, match="no kernel for device"):
        _flag_kernel_calls("meta")[name]()


def _nn_kernel_calls(device):
    """A call of K12, K12T, the force gather, K9, K10, K10T, K11 and K11T on
    small inputs on `device` (the pair-grid kernels at twojmax 2)."""
    from types import SimpleNamespace

    from fitsnap_tpu_torch.kernels import nn_kernels as nk
    from fitsnap_tpu_torch.ops.snap import make_params, nn_tables

    rng = np.random.default_rng(5)
    N, A, W, K = 2, 3, 4, 2

    def t(x, dtype=torch.float64):
        return torch.as_tensor(x, dtype=dtype, device=device)

    G = t(rng.normal(size=(N, A, W, K, 3)))
    jidx = t(rng.integers(0, A, (N, A, K)), torch.int32)
    rev = t(np.full((N, A, 1), -1), torch.int32)
    p = make_params(SimpleNamespace(
        twojmax=["2"], numtypes=1, wj=["1.0"], radelem=["0.5"], rcutfac=4.6,
        rfac0=0.99, rmin0=0.0, chemflag=0, quadraticflag=0, bnormflag=0,
        wselfallflag=0, bzeroflag=1, switchflag=1, switchinnerflag=0,
        sinner=None, dinner=None), "cpu")
    n_t, M = nn_tables(p).n_t, N * A
    block = (t(rng.normal(size=(M, K, 3)) + 1.5),
             t(np.zeros((M, K)), torch.int32), t(np.ones((M, K)), torch.bool),
             t(np.zeros(M), torch.int32))
    z = (t(rng.normal(size=(M, p.nz))),) * 2
    vg = t(rng.normal(size=(M, n_t, n_t)))
    return {
        "nn_force": lambda: nk.nn_force(t(rng.normal(size=(N, A, W))), G,
                                        jidx, rev),
        "nn_force_t": lambda: nk.nn_force_t(t(rng.normal(size=(N, A, 3))),
                                            G, jidx),
        "nn_pair_gather": lambda: nk.nn_pair_gather(
            t(rng.normal(size=(N, A, K, 3))), rev),
        "nn_ut_b": lambda: nk.nn_ut_b(*block, p)[1],
        "nn_dedu_vg": lambda: nk.nn_dedu_vg(
            t(rng.normal(size=(M, p.ntriples))), *z, p),
        "nn_dedu_vg_t": lambda: nk.nn_dedu_vg_t(vg, *z, p),
        "nn_pair_force": lambda: nk.nn_pair_force(vg, *block, p),
        "nn_pair_force_t": lambda: nk.nn_pair_force_t(
            t(rng.normal(size=(N, A, 3))), jidx, *block, p),
    }


@pytest.mark.parametrize("name", ["nn_force", "nn_force_t", "nn_pair_gather",
                                  "nn_ut_b", "nn_dedu_vg", "nn_dedu_vg_t",
                                  "nn_pair_force", "nn_pair_force_t"])
def test_nn_wrappers_plain_on_cpu_and_raise_on_meta(name):
    """K12, K12T, the force gather, K9, K10, K10T, K11 and K11T run their
    plain version for CPU tensors without counting a launch, and refuse a
    `meta` tensor."""
    from fitsnap_tpu_torch.kernels import nn_kernels as nk

    nk.reset_launches()
    out = _nn_kernel_calls("cpu")[name]()
    assert torch.isfinite(out).all()
    assert nk.launches() == dict.fromkeys(
        ["nn_force", "nn_force_t", "nn_pair_gather", "nn_ut_b",
         "nn_dedu_vg", "nn_dedu_vg_t", "nn_pair_force", "nn_pair_force_t"],
        0)
    with pytest.raises(ValueError, match="no kernel for device"):
        _nn_kernel_calls("meta")[name]()


@pytest.mark.parametrize("solver", ["TPUSVD", "SCALAPACK", "TENSORFLOWSVD"])
def test_device_solvers_fit_on_cpu(tmp_path, solver):
    """`FitSnap` with each device solver fits on `device="cpu"`, and its
    coefficients agree with the host SVD on the same rows."""
    from fitsnap_tpu_torch import FitSnap

    root = tmp_path / "JSON"
    rng = np.random.default_rng(4)
    (root / "Cells").mkdir(parents=True)
    for i in range(6):
        pos, cell = synthetic.supercell(synthetic.BCC, 3.1 + 0.06 * i,
                                        (1, 1, 2))
        pos = pos + rng.normal(0.0, 0.08, pos.shape)
        (root / "Cells" / f"c{i}.json").write_text(synthetic.config_json(
            pos, cell, energy=-47.0 + i, forces=rng.normal(0, 0.2, (4, 3)),
            stress=np.diag(rng.normal(0, 1e3, 3))))
    s = synthetic.ta_settings(root, groups=[])
    s["GROUPS"]["Cells"] = "1.0 0.0 1.0 1.0 1e-4"
    s["SOLVER"]["solver"] = solver
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
        fs.scrape_configs()
        fs.process_configs()
        fs.perform_fit()
    finally:
        os.chdir(cwd)
    assert type(fs.solver).__name__ == {"TENSORFLOWSVD": "TfSVD"}.get(
        solver, "TpuSVD")
    assert fs.solver.device.type == "cpu"
    assert fs.fit.shape == (31,) and np.isfinite(fs.fit).all()
    aw = fs.w[:, None] * fs.a
    ref, *_ = np.linalg.lstsq(aw, fs.w * fs.b, rcond=None)
    resid = np.linalg.norm(aw @ fs.fit - fs.w * fs.b)
    assert resid <= 1.0001 * np.linalg.norm(aw @ ref - fs.w * fs.b) + 1e-12


# the host solvers and the class each factory name gives
HOST_SOLVERS = {"SVD": "SVD", "RIDGE": "Ridge", "LASSO": "Lasso",
                "ARD": "ARD", "ANL": "ANL", "BCS": "BCS", "MCMC": "MCMC",
                "OPT": "OPT", "MERR": "MERR"}


def host_solver_settings(root, solver):
    """Six jittered 4-atom bcc cells with seeded truths, fitted at twojmax
    4 with `solver` (short chains for MCMC and MERR's sampler)."""
    rng = np.random.default_rng(4)
    (root / "Cells").mkdir(parents=True, exist_ok=True)
    for i in range(6):
        pos, cell = synthetic.supercell(synthetic.BCC, 3.1 + 0.06 * i,
                                        (1, 1, 2))
        pos = pos + rng.normal(0.0, 0.08, pos.shape)
        (root / "Cells" / f"c{i}.json").write_text(synthetic.config_json(
            pos, cell, energy=-47.0 + i, forces=rng.normal(0, 0.2, (4, 3)),
            stress=np.diag(rng.normal(0, 1e3, 3))))
    s = synthetic.ta_settings(root, groups=[])
    s["BISPECTRUM"]["twojmax"] = 4
    s["GROUPS"]["Cells"] = "1.0 0.0 1.0 1.0 1e-4"
    s["SOLVER"] = {"solver": solver, "mcmc_num": 300, "nsam": 5}
    return s


@pytest.mark.parametrize("solver", list(HOST_SOLVERS))
def test_host_solvers_fit_on_cpu(tmp_path, solver, monkeypatch):
    """`FitSnap` with each host solver fits on `device="cpu"`: the JAX
    factory's class, finite coefficients, the same as the class gives on
    the facade's rows (every solver here is seeded or deterministic)."""
    from fitsnap_tpu_torch import FitSnap

    monkeypatch.chdir(tmp_path)
    fs = FitSnap(host_solver_settings(tmp_path / "JSON", solver),
                 arglist=["--overwrite"], device="cpu")
    fs.scrape_configs()
    fs.process_configs()
    fs.perform_fit()
    fs.write_output()
    assert type(fs.solver).__name__ == HOST_SOLVERS[solver]
    assert fs.fit.shape == (15,) and np.isfinite(fs.fit).all()
    ref = type(fs.solver)(solver, fs.config)
    ref.perform_fit(fs.a, fs.b, fs.w, fs.fs_dict)
    assert np.array_equal(fs.fit, ref.fit)
    assert (tmp_path / "Ta_metrics.md").exists()


def test_blocked_sklearn_pandas_matplotlib(tmp_path):
    """As on the machine with the card: every module of the port imports,
    and `FitSnap` fits on the CPU with the XYZ and VASP scrapers and every
    solver that needs no sklearn (RIDGE falls back to its local normal
    equations); LASSO and ARD raise naming sklearn, the DF metric style
    and `dump_dataframe` naming pandas."""
    from tests.test_torch_scrapers import XYZ_GROUPS, settings
    from tests.test_torch_scrapers import write_vasp, write_xyz

    write_xyz(tmp_path / "XYZ", 13)
    write_vasp(tmp_path / "VASP", 14)
    sets = {"XYZ": settings(tmp_path / "XYZ", "XYZ", XYZ_GROUPS),
            "VASP": settings(tmp_path / "VASP", "VASP", ["Bulk", "Strained"],
                             extra={"GROUPS": {"vasp_ignore_incomplete": 1}})}
    proc = run_python(f"""
        import importlib, os, sys
        # one thread a library: the suite runs several workers at once
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ[var] = "1"
        for name in ("sklearn", "pandas", "matplotlib"):
            sys.modules[name] = None
        for name in {all_modules()!r}:
            importlib.import_module(name)
        import numpy as np
        from fitsnap_tpu_torch import FitSnap

        def fit(s, solver, **extra):
            s = dict(s, SOLVER={{"solver": solver, "mcmc_num": 300,
                                 "nsam": 5}})
            for section, kv in extra.items():
                s[section] = dict(s.get(section, {{}}), **kv)
            fs = FitSnap(s, arglist=["--overwrite"], device="cpu")
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
            fs.write_output()
            assert np.isfinite(fs.fit).all(), solver
            return fs

        for kind, s in {sets!r}.items():
            for solver in ("SVD", "RIDGE", "ANL", "BCS", "MCMC", "OPT",
                           "MERR"):
                fit(s, solver)
            fit(s, "RIDGE", RIDGE={{"local_solver": 1}})
            for solver in ("LASSO", "ARD"):
                try:
                    fit(s, solver)
                except ModuleNotFoundError as e:
                    assert "sklearn" in str(e), e
                else:
                    raise SystemExit(solver + " fitted without sklearn")
            for extra in (dict(OUTFILE=dict(s["OUTFILE"],
                                             metrics_style="DF")),
                          dict(EXTRAS={{"dump_dataframe": 1}})):
                try:
                    fit(s, "SVD", **extra)
                except ModuleNotFoundError as e:
                    assert "pandas" in str(e), e
                else:
                    raise SystemExit("a DataFrame without pandas")
        print("ok")
    """, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("source,replaces", [
    ("pair_u_duals", "_pair_wu_duals"),
    ("zlist", "_compute_zcat_pair"),
    ("dbdd", "_dbdu_ylist"),
    ("dbdd", "_chem_b_and_dbdu"),
    ("zlist", "_chem_b_and_dbdu"),
    ("pair_u_duals", "_utot_from_wu"),
    ("quad_chain", "_quad_chain"),
    ("pair_scatter", "calculators/snap.py"),
    ("zbl_pair", "reference_eav"),
    ("device_neighbors", "parallel/fit.py `device_neighbors`"),
    ("normal_contrib", "config_normal_contrib"),
    ("ace_pair_basis", "`ace_pair_phi`"),
    ("ace_b_dbdd", "`ace_b_and_dbda`"),
    ("nn_force", "`_forward_batch`"),
    ("nn_force", "`_forward_batch_cached`"),
    ("nn_grid", "`compute_utot_mono`"),
    ("nn_grid", "`nn_pair_force`"),
    ("nn_dedu", "`nn_dEdu`"),
    ("pair_desc", "`pair_descriptors`"),
    ("pair_desc", "`_forward_pairwise`"),
])
def test_cuda_source_per_kernel(source, replaces):
    path = build.CSRC / f"{source}.cu"
    text = path.read_text()
    assert source in build.SOURCES
    assert "__global__" in text and 'extern "C"' in text
    assert replaces in text and "Bound on the H100" in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _c_entry_points():
    """{entry point: ctypes argument types} parsed from the sources'
    `extern "C" int` functions (their stream argument included)."""
    import re

    from fitsnap_tpu_torch.kernels import launch as kl

    kinds = {"int": kl.I, "long long": kl.LL, "double": kl.D}
    out = {}
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                arg = arg.replace("const", "").strip()
                base = arg.rsplit(" ", 1)[0].strip()
                types.append(kl.P if "*" in arg else kinds[base])
            out[fn] = types
    return out


def test_registered_argtypes_match_the_c_signatures():
    """Every registered entry point passes exactly the C function's
    arguments, a pointer-sized one for each pointer and the stream (an int
    in place of a pointer would cut it to 32 bits)."""
    from fitsnap_tpu_torch.kernels import ace_kernels  # noqa: F401
    from fitsnap_tpu_torch.kernels import custom_kernels  # noqa: F401
    from fitsnap_tpu_torch.kernels import launch as kl
    from fitsnap_tpu_torch.kernels import nn_kernels  # noqa: F401

    c = _c_entry_points()
    assert set(kl._ENTRY) <= set(c)
    for name, (library, argtypes) in kl._ENTRY.items():
        assert library in build.SOURCES
        assert argtypes == c[name], name


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result, both
    from the checkout and alone in an empty directory."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
