"""Linear and Bayesian/UQ solvers.

Mirrors the reference solver family (`fitsnap3lib/solvers/`): RIDGE, LASSO,
ARD (sklearn-backed with a local ridge fallback, like the reference), ANL
(analytic Bayesian posterior), MCMC (adaptive Metropolis), OPT (BFGS on the
residual norm), BCS (sequential sparse Bayesian learning / fast RVM).

Each implements `perform_fit(a, b, w, fs_dict)` and stores `self.fit`
(+ `self.cov` / `self.fit_sam` for the UQ solvers).

Copy of `fitsnap_tpu/solvers/linear.py`.  sklearn and scipy are imported
inside the methods that use them.
"""

import numpy as np

from fitsnap_tpu_torch.solvers.solver import Solver


def _solver_rng(config):
    """Deterministic RNG for stochastic solvers (ANL samples, OPT x0, MCMC).

    The reference broadcasts one shared seed to every rank
    (`fitsnap3lib/parallel_tools.py:239`); here the GROUPS `random_seed`
    (when set) plays that role so UQ artifacts are reproducible run-to-run.
    """
    seed = None
    groups = getattr(config, "sections", {}).get("GROUPS") \
        if config is not None else None
    if groups is not None and getattr(groups, "random_seed_set",
                                      groups.random_seed != 0):
        seed = int(groups.random_seed)
    # None = unset (default 13); an explicit random_seed = 0 is a real seed
    return np.random.default_rng(13 if seed is None else seed)


def _weighted_training(a, b, w, fs_dict, trainall=False):
    if fs_dict is not None and not trainall:
        training = np.array([not t for t in fs_dict["Testing"]])
    else:
        training = np.ones(a.shape[0], bool)
    wt = w[training]
    return wt[:, None] * a[training], wt * b[training]


class Ridge(Solver):
    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        alpha = self.config.sections["RIDGE"].alpha \
            if self.config.has_section("RIDGE") else 1e-6
        local = self.config.sections["RIDGE"].local_solver \
            if self.config.has_section("RIDGE") else False
        if not local:
            try:
                from sklearn.linear_model import Ridge as SkRidge
                reg = SkRidge(alpha=alpha, fit_intercept=False)
                reg.fit(aw, bw)
                self.fit = reg.coef_
                return self.fit
            except ModuleNotFoundError:
                pass
        # local ridge: regularized normal equations
        # (reference `lib/ridge_solver/regressor.py`)
        ata = aw.T @ aw + alpha * np.eye(aw.shape[1])
        self.fit = np.linalg.solve(ata, aw.T @ bw)
        return self.fit


class Lasso(Solver):
    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        from sklearn.linear_model import Lasso as SkLasso
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        sec = self.config.sections.get("LASSO")
        alpha = sec.alpha if sec else 1e-6
        max_iter = sec.max_iter if sec else 2000
        reg = SkLasso(alpha=alpha, fit_intercept=False, max_iter=max_iter)
        reg.fit(aw, bw)
        self.fit = reg.coef_
        return self.fit


class ARD(Solver):
    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        from sklearn.linear_model import ARDRegression
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        sec = self.config.sections.get("ARD")
        ap = 1.0 / np.var(bw)
        logcut = sec.logcut if sec else -4
        scap = getattr(sec, "scap", 1.0) if sec else 1.0
        scai = getattr(sec, "scai", 1.0) if sec else 1.0
        if sec and sec.directmethod:
            reg = ARDRegression(
                max_iter=1000, threshold_lambda=sec.threshold_lambda,
                alpha_1=sec.alphabig, alpha_2=sec.alphabig,
                lambda_1=sec.lambdasmall, lambda_2=sec.lambdasmall,
                fit_intercept=False)
        else:
            reg = ARDRegression(
                max_iter=1000, alpha_1=scap * ap, alpha_2=scap * ap,
                lambda_1=ap * scai, lambda_2=ap * scai, fit_intercept=False,
                threshold_lambda=10 ** (int(abs(np.log10(ap))) + logcut))
        reg.fit(aw, bw)
        self.fit = reg.coef_
        return self.fit


class ANL(Solver):
    """Analytic Bayesian posterior (reference `solvers/anl.py:13`)."""

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        npt, nbas = aw.shape
        nugget = self.config.sections["SOLVER"].cov_nugget
        invptp = np.linalg.pinv(aw.T @ aw + nugget * np.eye(nbas))
        invptp = 0.5 * (invptp + invptp.T)
        self.fit = invptp @ (aw.T @ bw)
        res = bw - aw @ self.fit
        bp = res @ res / 2.0
        ap = (npt - nbas) / 2.0
        sigmahat = bp / (ap - 1.0)
        self.cov = sigmahat * invptp
        np.save("covariance.npy", self.cov)
        np.save("mean.npy", self.fit)
        nsam = self.config.sections["SOLVER"].nsam
        if nsam:
            self.fit_sam = _solver_rng(self.config).multivariate_normal(
                self.fit, self.cov, size=(nsam,))
        return self.fit


def adaptive_metropolis(neg_logpost, x0, nmcmc, gamma, rng=None,
                        propcov_scale=0.01, propcov_ini=None,
                        t0=100, tadapt=100):
    """Adaptive Metropolis (Haario) chain over `neg_logpost`.

    Shared by the MCMC linear solver and MERR's sampling mode (reference
    `solvers/mcmc.py` / `solvers/lreg.py:127` both run this recipe).
    Returns (samples, cmode, pmode): the chain, the MAP sample, and its
    negative log-posterior.
    """
    cdim = x0.shape[0]
    rng = rng or np.random.default_rng()
    samples = np.zeros((nmcmc, cdim))
    samples[0] = x0
    cov = np.zeros((cdim, cdim))
    propcov = (propcov_ini if propcov_ini is not None
               else propcov_scale * np.eye(cdim))
    sigcv = gamma * 2.4 ** 2 / cdim
    p1 = neg_logpost(samples[0])
    pmode, cmode = p1, samples[0]
    Xm = samples[0]
    for k in range(nmcmc - 1):
        if k > 0:
            Xm = (k * Xm + samples[k]) / (k + 1.0)
            rt = (k - 1.0) / k
            st = (k + 1.0) / k ** 2
            d = (samples[k] - Xm)[:, None]
            cov = rt * cov + st * (d @ d.T)
            if k > t0 and k % tadapt == 0:
                propcov = sigcv * (cov + 1e-8 * np.eye(cdim))
        u = rng.multivariate_normal(samples[k], propcov)
        p2 = neg_logpost(u)
        if rng.random() <= np.exp(min(0.0, p1 - p2)):
            samples[k + 1] = u
            p1 = p2
            if p1 <= pmode:
                pmode, cmode = p1, samples[k + 1]
        else:
            samples[k + 1] = samples[k]
    return samples, cmode, pmode


class MCMC(Solver):
    """Adaptive Metropolis over coefficients (reference `solvers/mcmc.py`)."""

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        sec = self.config.sections["SOLVER"]
        nmcmc = sec.mcmc_num
        sigma = sec.mcmc_sigma
        # start from the least-squares solution
        x0, *_ = np.linalg.lstsq(aw, bw, rcond=1e-13)

        def neg_logpost(x):
            r = aw @ x - bw
            return 0.5 * np.sum(r * r) / (sigma * sigma)

        samples, cmode, _ = adaptive_metropolis(
            neg_logpost, x0, nmcmc, sec.mcmc_gamma,
            rng=_solver_rng(self.config))
        nburn = nmcmc // 2
        self.fit = cmode
        nsam = sec.nsam or 100
        # thin to AT MOST nsam draws: stride arithmetic alone can overshoot
        stride = max(1, (nmcmc - nburn) // max(1, nsam))
        self.fit_sam = samples[nburn:][::stride][:nsam]
        self.cov = np.cov(samples[nburn:].T)
        return self.fit


class OPT(Solver):
    """BFGS minimization of ||Ax - b|| (reference `solvers/opt.py`)."""

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        from scipy.optimize import minimize
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)

        def distance(x):
            return np.linalg.norm(aw @ x - bw)

        def grad(x):
            return aw.T @ (aw @ x - bw)

        x0 = _solver_rng(self.config).standard_normal(aw.shape[1])
        res = minimize(distance, x0, method="BFGS", jac=grad,
                       options={"gtol": 1e-13})
        self.fit = res.x
        np.save("mean.npy", self.fit)
        return self.fit


class BCS(Solver):
    """Bayesian compressive sensing via sequential sparse Bayesian learning
    (fast RVM; reference `solvers/bcs.py` ports the same algorithm)."""

    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False, eta=1e-8, max_iter=1000):
        aw, bw = _weighted_training(a, b, w, fs_dict, trainall)
        N, M = aw.shape
        sigma2 = max(np.var(bw) * 0.1, 1e-12)
        beta = 1.0 / sigma2
        phi_norms = np.einsum("nm,nm->m", aw, aw)
        proj = aw.T @ bw
        # start with the best-aligned basis function
        ratios = proj ** 2 / np.clip(phi_norms, 1e-300, None)
        i0 = int(np.argmax(ratios))
        active = [i0]
        alpha = np.full(M, np.inf)
        alpha[i0] = phi_norms[i0] / max(ratios[i0] - 1.0 / beta, 1e-12)

        for _ in range(max_iter):
            Phi = aw[:, active]
            Sigma_inv = np.diag(alpha[active]) + beta * Phi.T @ Phi
            Sigma = np.linalg.pinv(Sigma_inv)
            mu = beta * Sigma @ (Phi.T @ bw)
            # sparsity/quality factors for all candidates
            PhiSPhiT = Phi @ Sigma @ Phi.T
            S = beta * phi_norms - beta ** 2 * np.einsum(
                "nm,nk,km->m", aw, PhiSPhiT, aw, optimize=True)
            Q = beta * proj - beta ** 2 * np.einsum(
                "nm,n->m", aw, PhiSPhiT @ bw, optimize=True)
            with np.errstate(invalid="ignore"):
                # inf*x/inf in the inactive branch is masked by the where
                s = np.where(np.isinf(alpha), S,
                             alpha * S / np.clip(alpha - S, 1e-300, None))
                q = np.where(np.isinf(alpha), Q,
                             alpha * Q / np.clip(alpha - S, 1e-300, None))
            theta = q ** 2 - s
            changed = False
            # single best re-estimation/addition/deletion per pass
            cand = np.where(theta > 0)[0]
            if len(cand):
                delta = np.zeros(M)
                for i in cand:
                    new_alpha = s[i] ** 2 / theta[i]
                    if np.isinf(alpha[i]):
                        delta[i] = (Q[i] ** 2 - S[i]) / S[i] + np.log(
                            S[i] / np.clip(Q[i] ** 2, 1e-300, None))
                    else:
                        delta[i] = abs(np.log(
                            np.clip(new_alpha, 1e-300, None)
                            / alpha[i]))
                i = int(np.argmax(np.abs(delta)))
                new_alpha = s[i] ** 2 / max(theta[i], 1e-300)
                if np.isinf(alpha[i]):
                    active.append(i)
                    alpha[i] = new_alpha
                    changed = True
                elif abs(np.log(new_alpha) - np.log(alpha[i])) > eta:
                    alpha[i] = new_alpha
                    changed = True
            # deletions
            for i in list(active):
                if theta[i] <= 0 and len(active) > 1:
                    active.remove(i)
                    alpha[i] = np.inf
                    changed = True
            # noise update
            Phi = aw[:, active]
            Sigma_inv = np.diag(alpha[active]) + beta * Phi.T @ Phi
            Sigma = np.linalg.pinv(Sigma_inv)
            mu = beta * Sigma @ (Phi.T @ bw)
            res = bw - Phi @ mu
            gamma_sum = len(active) - np.sum(
                np.array(alpha[active]) * np.diag(Sigma))
            beta = max((N - gamma_sum) / max(res @ res, 1e-300), 1e-12)
            if not changed:
                break

        self.fit = np.zeros(M)
        self.fit[active] = mu
        cov = np.zeros((M, M))
        cov[np.ix_(active, active)] = Sigma
        self.cov = cov
        return self.fit
