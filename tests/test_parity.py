"""Posterior parity: the JAX sampler vs an independent NumPy implementation of the
Goodman & Weare (2010) stretch move (the algorithm emcee implements; emcee itself is
not available in this environment).  Parity must be *distributional* — posterior
moments/quantiles within Monte-Carlo error — not samplewise (SURVEY.md hard parts).
"""

import math

import numpy as np

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ConstantFit
from mcmc_dynamics_jax.sampler import autocorr_time, init_state, run_ensemble
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def numpy_stretch_sampler(lnprob, p0, n_steps, a=2.0, seed=0):
    """Independent reference implementation of the affine-invariant stretch move
    (Goodman & Weare 2010, eqs. 7-10; the emcee 'StretchMove')."""
    rng = np.random.default_rng(seed)
    pos = np.array(p0, dtype=float)
    n_walkers, ndim = pos.shape
    lnp = np.array([lnprob(p) for p in pos])
    half = n_walkers // 2
    chain = np.empty((n_walkers, n_steps, ndim))
    for step in range(n_steps):
        for first in (True, False):
            sel = slice(0, half) if first else slice(half, n_walkers)
            other = slice(half, n_walkers) if first else slice(0, half)
            z = ((a - 1.0) * rng.random(half) + 1.0) ** 2 / a
            partners = pos[other][rng.integers(0, half, half)]
            prop = partners + z[:, None] * (pos[sel] - partners)
            new_lnp = np.array([lnprob(p) for p in prop])
            ln_acc = (ndim - 1.0) * np.log(z) + new_lnp - lnp[sel]
            accept = np.log(rng.random(half)) < ln_acc
            pos[sel][accept] = prop[accept]
            block = pos[sel]
            block[accept] = prop[accept]
            pos[sel] = block
            lnp_block = lnp[sel]
            lnp_block[accept] = new_lnp[accept]
            lnp[sel] = lnp_block
        chain[:, step, :] = pos
    return chain


def _fit(n=250, seed=0):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0, 60, n)) + 1.0
    phi = rng.uniform(-np.pi, np.pi, n)
    theta_0, v_max, sigma = 0.8, 4.0, 7.0
    v = v_max * np.sin(phi - theta_0) + sigma * rng.normal(size=n)
    verr = 0.3 + 0.2 * rng.random(n)
    v = v + verr * rng.normal(size=n)
    ra = RA_C - (r / 3600) * np.cos(phi) / math.cos(math.radians(DEC_C))
    dec = DEC_C + (r / 3600) * np.sin(phi)
    data = DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                       "v": u.Quantity(v, "km/s"), "verr": u.Quantity(verr, "km/s")})
    params = ConstantFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.3, size=n)")
    params["v_maxx"].set(initials="rng.normal(loc=0, scale=3, size=n)")
    params["v_maxy"].set(initials="rng.normal(loc=0, scale=3, size=n)")
    return ConstantFit(data, parameters=params, seed=seed)


class TestPosteriorParity:
    def test_same_posterior_as_independent_numpy_sampler(self):
        fit = _fit()
        lnprob_jax = fit.build_lnprob()
        lnprob_np = lambda p: float(fit.lnprob(p))

        pos = fit.get_initials(64)
        n_steps, n_burn = 600, 300

        state = init_state(lnprob_jax, jnp.asarray(pos), jax.random.PRNGKey(0))
        ours = np.asarray(run_ensemble(lnprob_jax, state, n_steps=n_steps).chain)
        ref = numpy_stretch_sampler(lnprob_np, pos, n_steps, seed=1)

        ours_flat = ours[:, n_burn:, :].reshape(-1, 4)
        ref_flat = ref[:, n_burn:, :].reshape(-1, 4)

        # Monte-Carlo error of the means given the autocorrelation time
        tau = np.maximum(autocorr_time(ours[:, n_burn:, :]), 1.0)
        n_eff = ours_flat.shape[0] / tau
        mc_err = ours_flat.std(axis=0) / np.sqrt(n_eff)

        delta = np.abs(ours_flat.mean(axis=0) - ref_flat.mean(axis=0))
        assert np.all(delta < 5 * mc_err + 1e-3), (delta, mc_err)

        # matching posterior widths (5% tolerance + MC error margin)
        s_ours = ours_flat.std(axis=0)
        s_ref = ref_flat.std(axis=0)
        assert np.all(np.abs(s_ours - s_ref) / s_ref < 0.15)

        # matching quantiles
        for q in (0.16, 0.5, 0.84):
            dq = np.abs(np.quantile(ours_flat, q, axis=0)
                        - np.quantile(ref_flat, q, axis=0))
            assert np.all(dq < 6 * mc_err + 1e-3)

    def test_exact_conjugate_gaussian_posterior(self):
        """Ground truth with NO reference sampler: with sigma_max fixed and flat
        priors, the ConstantFit posterior over beta = (v_sys, v_maxx, v_maxy) is
        exactly Gaussian — v_i ~ N(phi_i . beta, n_i) with known n_i, so

            Lambda = sum_i phi_i phi_i^T / n_i,   mu = Lambda^{-1} sum_i phi_i v_i / n_i.

        Sampler moments and quantiles must match the closed form within
        Monte-Carlo error (VERDICT r1 item 6)."""
        fit = _fit(seed=3)
        sigma = 7.0
        fit.parameters["sigma_max"].set(value=sigma, fixed=True)
        fit.parameters["v_sys"].set(min=-math.inf, max=math.inf)
        fit.parameters["v_maxx"].set(min=-math.inf, max=math.inf)
        fit.parameters["v_maxy"].set(min=-math.inf, max=math.inf)
        assert fit.fitted_parameters == ["v_sys", "v_maxx", "v_maxy"]

        # closed-form posterior from the design matrix (independent numpy math)
        data = fit.data.data
        v = data.value("v")
        verr = data.value("verr")
        ra, dec = data.value("ra"), data.value("dec")
        dx = -(ra - RA_C) * math.cos(math.radians(DEC_C)) * 60.0
        dy = (dec - DEC_C) * 60.0
        r = np.hypot(dx, dy)
        phi = np.column_stack([np.ones_like(v), dy / r, -dx / r])
        n = verr ** 2 + sigma ** 2
        lam = (phi.T / n) @ phi
        cov_true = np.linalg.inv(lam)
        mu_true = cov_true @ (phi.T @ (v / n))

        lnprob_jax = fit.build_lnprob()
        pos = fit.get_initials(128)
        state = init_state(lnprob_jax, jnp.asarray(pos), jax.random.PRNGKey(9))
        res = run_ensemble(lnprob_jax, state, n_steps=1500)
        chain = np.asarray(res.chain)[:, 500:, :]
        flat = chain.reshape(-1, 3)

        tau = np.maximum(autocorr_time(chain), 1.0)
        n_eff = flat.shape[0] / tau
        mc_err = flat.std(axis=0) / np.sqrt(n_eff)

        # means against the analytic posterior mean
        assert np.all(np.abs(flat.mean(axis=0) - mu_true) < 5 * mc_err), \
            (flat.mean(axis=0), mu_true, mc_err)
        # marginal standard deviations against the analytic covariance
        sd_true = np.sqrt(np.diag(cov_true))
        assert np.all(np.abs(flat.std(axis=0) - sd_true) / sd_true < 0.1), \
            (flat.std(axis=0), sd_true)
        # analytic Gaussian quantiles
        from scipy import stats
        for q in (0.16, 0.5, 0.84):
            want = mu_true + stats.norm.ppf(q) * sd_true
            got = np.quantile(flat, q, axis=0)
            assert np.all(np.abs(got - want) < 6 * mc_err + 0.02 * sd_true), \
                (q, got, want)
        # full covariance (correlations) within 15%
        cov_got = np.cov(flat.T)
        scale = np.sqrt(np.outer(np.diag(cov_true), np.diag(cov_true)))
        assert np.all(np.abs(cov_got - cov_true) / scale < 0.15)

    def test_acceptance_rates_match(self):
        fit = _fit(seed=2)
        lnprob_jax = fit.build_lnprob()
        pos = fit.get_initials(32)
        state = init_state(lnprob_jax, jnp.asarray(pos), jax.random.PRNGKey(3))
        res = run_ensemble(lnprob_jax, state, n_steps=400)
        acc_ours = float(np.mean(np.asarray(res.acceptance_fraction)))

        # acceptance of the independent implementation
        lnprob_np = lambda p: float(fit.lnprob(p))
        ref = numpy_stretch_sampler(lnprob_np, pos, 400, seed=4)
        moved = np.mean(np.any(np.diff(ref, axis=1) != 0, axis=2))
        assert abs(acc_ours - moved) < 0.1
