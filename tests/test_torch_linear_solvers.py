"""The port's linear and Bayesian solvers against the JAX package's (CPU,
float64).

The same seeded numpy A, b, w and fs_dict (a train/test mask, weights that
differ by row) go to each JAX solver class and its port twin, each built
on its own package's `Config` of the same settings: RIDGE (sklearn and the
local normal equations), LASSO, ARD (both branches), ANL, BCS, MCMC, OPT
and MERR (each method with the BFGS sampler, and the MCMC sampler).
`fit`, `cov` and `fit_sam` agree to 1e-12 relative (they are the same
numpy, scipy and sklearn calls, so they agree bit for bit).  MERR's MCMC
sampler draws from an unseeded `np.random.default_rng()` in both packages,
so the test seeds that call for both runs alike.

Then the coverage of `tests/test_solvers.py` on the port: each solver's
recovery of the truths, MCMC's `nsam` clamp, MERR's refusal of an unknown
sampler and its zero-column backfill, ANL's seeded samples and files.
Last, one `FitSnap` fit with bzeroflag 1 and ANL through both packages:
`_offset` pads the posterior samples as it pads the coefficients.
"""

import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from fitsnap_tpu_torch.tools import synthetic


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread: the solvers loop over small products, which many
    threads a worker only slow down when the suite runs several workers."""
    with threadpool_limits(limits=1):
        yield

SOLVER_CASES = {
    "ridge_sklearn": ("RIDGE", {"RIDGE": {"alpha": 1e-4}}),
    "ridge_local": ("RIDGE", {"RIDGE": {"alpha": 1e-4, "local_solver": 1}}),
    "lasso": ("LASSO", {"LASSO": {"alpha": 1e-4, "max_iter": 5000}}),
    "ard": ("ARD", {"ARD": {"logcut": -4}}),
    "ard_direct": ("ARD", {"ARD": {"directmethod": 1,
                                   "threshold_lambda": 10000}}),
    "anl": ("ANL", {"SOLVER": {"nsam": 25, "cov_nugget": 1e-10}}),
    "bcs": ("BCS", {}),
    "mcmc": ("MCMC", {"SOLVER": {"mcmc_num": 1500, "nsam": 40}}),
    "opt": ("OPT", {}),
    "merr_iid": ("MERR", {"SOLVER": {"merr_method": "iid"}}),
    "merr_abc": ("MERR", {"SOLVER": {"merr_method": "abc"}}),
    "merr_full": ("MERR", {"SOLVER": {"merr_method": "full"}}),
    "merr_mcmc": ("MERR", {"SOLVER": {"merr_method": "iid",
                                      "merr_sampler": "mcmc",
                                      "mcmc_num": 1500, "nsam": 30}}),
}


def system(npt=120, nbas=5, noise=0.01, seed=0):
    """A well-posed weighted system with truths 1..nbas, every tenth row a
    testing row and the weights of the last three quarters doubled."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(npt, nbas))
    x_true = np.arange(1, nbas + 1, dtype=float)
    b = a @ x_true + noise * rng.normal(size=npt)
    w = np.ones(npt)
    w[npt // 4:] = 2.0
    fs_dict = {"Testing": [i % 10 == 0 for i in range(npt)]}
    return a, b, w, fs_dict, x_true


def settings(solver, extra):
    s = synthetic.ta_settings("JSON", groups=[])
    s["SOLVER"] = {"solver": solver}
    for section, kv in extra.items():
        s.setdefault(section, {}).update(kv)
    return s


def make(package, solver, extra):
    """The `package`'s ("jax" or "port") solver of `settings`, built by
    its own factory on its own Config."""
    if package == "jax":
        from fitsnap_tpu.config import Config
        from fitsnap_tpu.fitsnap import _solver_factory
        return _solver_factory(Config(settings(solver, extra),
                                      arglist=["--overwrite"]))
    from fitsnap_tpu_torch.config import Config
    from fitsnap_tpu_torch.fitsnap import _solver_factory
    return _solver_factory(Config(settings(solver, extra),
                                  arglist=["--overwrite"]), "cpu")


def seeded_default_rng(monkeypatch):
    """`np.random.default_rng()` without a seed draws seed 123 (the one
    call MERR's MCMC sampler makes); seeded calls are unchanged."""
    default_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: default_rng(
                            123 if seed is None else seed))


def rel(port, ref):
    port, ref = np.asarray(port, float), np.asarray(ref, float)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    solver, extra = SOLVER_CASES[case]
    a, b, w, fs_dict, _ = system()
    if solver == "BCS":
        a, b, w, fs_dict = sparse_system()[:4]
    out = {}
    for package in ("jax", "port"):
        seeded_default_rng(monkeypatch)
        s = make(package, solver, extra)
        s.perform_fit(a, b, w, fs_dict)
        out[package] = s
    jax, port = out["jax"], out["port"]
    assert type(port).__name__ == type(jax).__name__
    assert rel(port.fit, jax.fit) <= 1e-12
    for name in ("cov", "fit_sam"):
        ref = getattr(jax, name)
        if ref is None:
            assert getattr(port, name) is None, name
        else:
            assert rel(getattr(port, name), ref) <= 1e-12, name
    if solver in ("ANL", "MCMC") or case == "merr_mcmc":
        assert port.fit_sam is not None and len(port.fit_sam)


def sparse_system(seed=7, npt=300, nbas=40):
    """tests/test_solvers.py's BCS system: three live basis functions."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(npt, nbas))
    x_true = np.zeros(nbas)
    x_true[[3, 11, 27]] = [2.0, -1.5, 3.0]
    b = a @ x_true + 0.01 * rng.normal(size=npt)
    return a, b, np.ones(npt), None, x_true


@pytest.mark.parametrize("case,tol", [
    ("ridge_sklearn", 0.05), ("ridge_local", 0.05), ("lasso", 0.05),
    ("ard_direct", 0.05), ("anl", 0.05), ("bcs", 0.05), ("mcmc", 0.1),
    ("opt", 0.05), ("merr_iid", 0.1), ("merr_abc", 0.1),
    ("merr_full", 0.1), ("merr_mcmc", 0.2)])
def test_port_solver_recovers_truth(case, tol, tmp_path, monkeypatch):
    """tests/test_solvers.py's truth checks on the port's solvers."""
    monkeypatch.chdir(tmp_path)
    seeded_default_rng(monkeypatch)
    solver, extra = SOLVER_CASES[case]
    a, b, w, fs_dict, x_true = sparse_system() if solver == "BCS" \
        else system()
    s = make("port", solver, extra)
    fit = s.perform_fit(a, b, w, fs_dict)
    assert np.abs(fit - x_true).max() < tol
    if solver == "BCS":
        assert np.abs(fit[x_true == 0]).max() < 0.05
    if solver in ("ANL", "MCMC", "MERR"):
        assert s.cov.shape == (len(x_true),) * 2
    if case == "merr_mcmc":
        assert np.abs(s.fit_sam.mean(axis=0) - x_true).max() < 0.5


def test_lasso_matches_sklearn():
    from sklearn.linear_model import Lasso as SkLasso

    a, b, _, _, _ = system(noise=0.001)
    s = make("port", "LASSO", {"LASSO": {"alpha": 1e-4, "max_iter": 5000}})
    fit = s.perform_fit(a, b, np.ones(len(b)), None)
    ref = SkLasso(alpha=1e-4, fit_intercept=False, max_iter=5000).fit(a, b)
    np.testing.assert_allclose(fit, ref.coef_, rtol=1e-10)


def test_mcmc_nsam_clamped():
    a, b, w, _, _ = system(npt=60, nbas=3)
    s = make("port", "MCMC", {"SOLVER": {"mcmc_num": 1000, "nsam": 7}})
    s.perform_fit(a, b, w, None)
    assert s.fit_sam.shape[0] <= 7


def test_merr_bad_sampler_raises():
    """An unknown sampler is refused: by the Config when it reads the
    section, and by MERR itself when its section is set after."""
    from fitsnap_tpu_torch.solvers.merr import MERR

    with pytest.raises(ValueError, match="merr_sampler"):
        make("port", "MERR", {"SOLVER": {"merr_sampler": "nuts"}})
    s = make("port", "MERR", {})
    assert isinstance(s, MERR)
    s.config.sections["SOLVER"].merr_sampler = "nuts"
    a, b, w, _, _ = system(npt=30, nbas=3)
    with pytest.raises(ValueError, match="merr_sampler"):
        s.perform_fit(a, b, w, None)


def test_merr_zero_column_backfill():
    a, b, w, _, x_true = system()
    s = make("port", "MERR", {"SOLVER": {"merr_method": "iid",
                                         "cov_nugget": 1e-8}})
    fit = s.perform_fit(np.insert(a, 2, 0.0, axis=1), b, w, None)
    assert fit[2] == 0.0
    assert np.abs(np.delete(fit, 2) - x_true).max() < 0.1


def test_anl_samples_seeded_and_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    a, b, w, _, _ = system(npt=400)
    fits = []
    for _ in range(2):
        s = make("port", "ANL", {"SOLVER": {"nsam": 25}})
        s.perform_fit(a, b, w, None)
        fits.append(s.fit_sam)
    assert fits[0].shape == (25, 5)
    np.testing.assert_array_equal(fits[0], fits[1])
    np.testing.assert_allclose(s.cov, s.cov.T)
    assert (tmp_path / "covariance.npy").exists()
    assert (tmp_path / "mean.npy").exists()


def test_adaptive_metropolis_gaussian_moments():
    from fitsnap_tpu_torch.solvers.linear import adaptive_metropolis

    mu = np.array([1.0, -2.0])
    prec = np.array([[4.0, 0.0], [0.0, 1.0]])
    samples, cmode, _ = adaptive_metropolis(
        lambda x: 0.5 * (x - mu) @ prec @ (x - mu), np.zeros(2), 20000,
        0.5, rng=np.random.default_rng(42))
    tail = samples[10000:]
    assert np.abs(tail.mean(axis=0) - mu).max() < 0.15
    assert abs(tail[:, 0].var() - 0.25) < 0.1
    assert np.abs(cmode - mu).max() < 0.2


def test_fitsnap_anl_bzeroflag_offsets_samples(tmp_path):
    """FitSnap with bzeroflag 1 and ANL: the coefficients and every
    posterior sample gain the zero offset column per type, in both
    packages; the port's fit equals JAX's to 1e-10 and its samples are
    ANL's draws on its own rows with that column inserted."""
    from fitsnap_tpu.fitsnap import FitSnap as JaxFitSnap
    from fitsnap_tpu_torch import FitSnap
    from fitsnap_tpu_torch.solvers.linear import ANL

    rng = np.random.default_rng(3)
    root = tmp_path / "JSON"
    (root / "Cells").mkdir(parents=True)
    for i in range(6):
        pos, cell = synthetic.supercell(synthetic.BCC, 3.15 + 0.05 * i,
                                        (1, 1, 2))
        pos = pos + rng.normal(0.0, 0.08, pos.shape)
        (root / "Cells" / f"c{i}.json").write_text(synthetic.config_json(
            pos, cell, energy=-47.0 + i, forces=rng.normal(0, 0.2, (4, 3)),
            stress=np.diag(rng.normal(0, 1e3, 3))))
    s = synthetic.ta_settings(root, groups=[])
    s["BISPECTRUM"].update(twojmax=4, bzeroflag=1)
    s["GROUPS"]["Cells"] = "1.0 0.0 1.0 1.0 1e-4"
    s["SOLVER"] = {"solver": "ANL", "nsam": 6, "cov_nugget": 1e-10}
    out = {}
    for name, make_fs in (
            ("port", lambda: FitSnap(s, arglist=["--overwrite"],
                                     device="cpu")),
            ("jax", lambda: JaxFitSnap(s, arglist=["--overwrite"]))):
        (tmp_path / name).mkdir()
        cwd = os.getcwd()
        os.chdir(tmp_path / name)
        try:
            fs = make_fs()
            fs.scrape_configs()
            fs.process_configs()
            fs.perform_fit()
            fs.write_output()
        finally:
            os.chdir(cwd)
        out[name] = fs
    port, jax = out["port"], out["jax"]
    ncoeff = port.config.sections["BISPECTRUM"].ncoeff
    assert port.fit.shape == (ncoeff,)
    assert port.solver.fit.shape == (ncoeff + 1,)
    assert port.solver.fit_sam.shape == jax.solver.fit_sam.shape \
        == (6, ncoeff + 1)
    assert port.solver.fit[0] == 0.0
    assert not port.solver.fit_sam[:, 0].any()
    assert not jax.solver.fit_sam[:, 0].any()
    assert rel(port.solver.fit, jax.solver.fit) <= 1e-10
    raw = ANL("ANL", port.config)
    os.chdir(tmp_path / "port")
    try:
        raw.perform_fit(port.a, port.b, port.w, port.fs_dict)
    finally:
        os.chdir(cwd)
    np.testing.assert_array_equal(port.solver.fit_sam[:, 1:], raw.fit_sam)
