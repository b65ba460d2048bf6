"""Model-error-embedding solver (reference `solvers/merr.py` + `lreg.py`).

Embeds per-coefficient model-error scales sigma_i into the likelihood and
optimizes (BFGS) or samples (adaptive MCMC) the joint (coeffs, sigmas)
posterior.  Methods: 'iid', 'abc', 'full' (`lreg.py:67 logpost_emb`).

Copy of `fitsnap_tpu/solvers/merr.py`; scipy is imported inside the
methods.
"""

import numpy as np

from fitsnap_tpu_torch.solvers.solver import Solver


def logpost_emb(x, aw, bw, ind_sig, datavar=0.0, multiplicative=False,
                merr_method="abc"):
    npt, nbas = aw.shape
    cfs = x[:nbas]
    sig_cfs = x[nbas:]
    if multiplicative:
        sig_cfs = np.abs(cfs[ind_sig]) * sig_cfs
    ss = aw[:, ind_sig] * sig_cfs

    if merr_method == "full":
        from scipy.stats import multivariate_normal
        cov = np.einsum("ij,ij->i", ss, ss) + datavar
        val = multivariate_normal.logpdf(
            aw @ cfs, mean=bw, cov=np.diag(cov), allow_singular=False)
    elif merr_method == "iid":
        err = aw @ cfs - bw
        stds = np.sqrt(np.linalg.norm(ss, axis=1) ** 2 + datavar)
        val = -0.5 * np.sum((err / stds) ** 2)
        val -= 0.5 * npt * np.log(2.0 * np.pi)
        val -= np.sum(np.log(stds))
    elif merr_method == "abc":
        abceps, abcalpha = 0.1, 1.0
        err = aw @ cfs - bw
        stds = np.sqrt(np.linalg.norm(ss, axis=1) ** 2 + datavar)
        err2 = abcalpha * np.abs(err) - stds
        val = -0.5 * np.sum((err2 / abceps) ** 2)
        val -= 0.5 * np.log(2.0 * np.pi)
        val -= np.log(abceps)
    else:
        raise ValueError(f"merr method {merr_method} unknown")
    return val


class MERR(Solver):
    def perform_fit(self, a=None, b=None, w=None, fs_dict=None,
                    trainall=False):
        from scipy.optimize import minimize

        if fs_dict is not None and not trainall:
            training = np.array([not t for t in fs_dict["Testing"]])
        else:
            training = np.ones(a.shape[0], bool)
        wt = w[training]
        aw, bw = wt[:, None] * a[training], wt * b[training]

        # drop all-zero columns (mixed-2J blank2J masking), backfill later
        zero_cols = [i for i in range(aw.shape[1]) if not np.any(aw[:, i])]
        keep = [i for i in range(aw.shape[1]) if i not in zero_cols]
        aw_full_width = aw.shape[1]
        aw = aw[:, keep]
        npt, nbas = aw.shape

        sec = self.config.sections["SOLVER"]
        nugget = sec.cov_nugget
        invptp = np.linalg.pinv(aw.T @ aw + nugget * np.eye(nbas))
        invptp = 0.5 * (invptp + invptp.T)
        cf0 = invptp @ (aw.T @ bw)

        if sec.merr_cfs == "all":
            ind_embed = np.arange(nbas)
        else:
            ind_embed = np.array([int(i) for i in sec.merr_cfs.split()])
        nemb = len(ind_embed)
        params_ini = np.concatenate([cf0, 0.1 * np.ones(nemb)])
        kw = dict(aw=aw, bw=bw, ind_sig=ind_embed, datavar=nugget,
                  multiplicative=bool(sec.merr_mult),
                  merr_method=sec.merr_method)
        if sec.merr_sampler not in ("bfgs", "mcmc"):
            raise ValueError(
                f"merr_sampler must be 'bfgs' or 'mcmc', got "
                f"{sec.merr_sampler!r}")
        res = minimize(lambda x: -logpost_emb(x, **kw), params_ini,
                       method="BFGS", options={"gtol": 1e-3})
        xopt = res.x
        if sec.merr_sampler == "mcmc":
            # Sample the embedded posterior with adaptive Metropolis and take
            # the MAP sample (reference `solvers/lreg.py:127-175`; there the
            # branch is only reachable by constructing lreg_merr directly —
            # here `merr_sampler = mcmc` in [SOLVER] selects it).  Warm-start
            # at the BFGS mode with a Laplace (inverse-Hessian) proposal —
            # a cold chain on an ill-conditioned A (SNAP systems reach
            # cond~1e16) never mixes into the mode (the reference left the
            # same BFGS pre-step commented out at lreg.py:159).
            from fitsnap_tpu_torch.solvers.linear import \
                adaptive_metropolis
            hinv = 0.5 * (res.hess_inv + res.hess_inv.T)
            ew, ev = np.linalg.eigh(hinv)
            propcov = (ev * np.clip(ew, 1e-12, None)) @ ev.T
            samples, cmode, _ = adaptive_metropolis(
                lambda x: -logpost_emb(x, **kw), res.x,
                sec.mcmc_num, sec.mcmc_gamma, propcov_ini=propcov)
            nburn = sec.mcmc_num // 2
            sam = samples[nburn:, :nbas][
                :: max(1, (sec.mcmc_num - nburn) // max(1, sec.nsam or 100))]
            fit_sam = np.zeros((sam.shape[0], aw_full_width))
            fit_sam[:, keep] = sam
            self.fit_sam = fit_sam
            xopt = cmode
        coeffs = xopt[:nbas]
        sig = xopt[nbas:]
        sig_all = np.zeros(nbas)
        if sec.merr_mult:
            sig_all[ind_embed] = np.abs(coeffs[ind_embed]) * sig
        else:
            sig_all[ind_embed] = sig
        fit = np.zeros(aw_full_width)
        fit[keep] = coeffs
        self.fit = fit
        cov = np.zeros((aw_full_width, aw_full_width))
        cov[np.ix_(keep, keep)] = np.diag(sig_all ** 2)
        self.cov = cov
        return self.fit
