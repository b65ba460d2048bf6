"""fitsnap_tpu_torch stands alone: no JAX, no fitsnap_tpu, no silent CPU.

- Every module of the package imports in a fresh interpreter without
  bringing in `jax` or any `fitsnap_tpu` module.
- `FitSnap` with no device asks for CUDA and raises where there is none;
  `device="cpu"` or `--device cpu` runs on the CPU.
- Each kernel wrapper takes its plain version for CPU tensors (launching
  nothing) and raises for a device that is neither CPU nor CUDA.
- `kernels/csrc/` holds one CUDA source for each of K1-K5, K7 and K8 (K8r
  shares K8's), each naming the JAX function it replaces, built for sm_90a.
- `FitSnap` fits on the CPU with every linear solver the port registers.
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
    assert "fitsnap_tpu_torch.kernels.snap_kernels" in mods
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
                                  "pair_scatter_rows", "zbl_pair_grad",
                                  "normal_contrib", "device_neighbors",
                                  "reverse_table"}
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
        "zbl_pair_grad": lambda: sk.zbl_pair_grad(
            disp, jidx, mask, types, t(np.ones((T, T, 6))), 4.0, 4.8),
        "normal_contrib": lambda: sk.normal_contrib(
            rows, truths, weights, natoms, types, T, False, flags),
        "device_neighbors": lambda: sk.device_neighbors(
            pos, torch.zeros_like(pos), svec, torch.zeros_like(svec),
            natoms, 4.0, K),
        "reverse_table": lambda: sk.reverse_table(jidx, mask),
    }


@pytest.mark.parametrize("name", ["zbl_pair_grad", "normal_contrib",
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


@pytest.mark.parametrize("source,replaces", [
    ("pair_u_duals", "_pair_wu_duals"),
    ("zlist", "_compute_zcat_pair"),
    ("dbdd", "_dbdu_ylist"),
    ("pair_scatter", "calculators/snap.py"),
    ("zbl_pair", "reference_eav"),
    ("device_neighbors", "parallel/fit.py `device_neighbors`"),
    ("normal_contrib", "config_normal_contrib"),
])
def test_cuda_source_per_kernel(source, replaces):
    path = build.CSRC / f"{source}.cu"
    text = path.read_text()
    assert source in build.SOURCES
    assert "__global__" in text and 'extern "C"' in text
    assert replaces in text and "Bound on the H100" in text
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


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
