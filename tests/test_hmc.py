"""Gradient-based HMC sampler: correctness on analytic targets and on the
differentiable model likelihoods."""

import math

import numpy as np

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax.sampler import autocorr_time
from mcmc_dynamics_jax.sampler.hmc import init_hmc, run_hmc

RA_C, DEC_C = 56.345, -26.675


class TestHMC:
    def test_gaussian_moments(self):
        cov = np.array([[2.0, 0.7], [0.7, 1.0]])
        icov = jnp.asarray(np.linalg.inv(cov))
        lnprob = lambda t: -0.5 * t @ icov @ t

        rng = np.random.default_rng(0)
        state = init_hmc(lnprob, jnp.asarray(rng.normal(size=(32, 2))),
                         jax.random.PRNGKey(0), step_size=0.3)
        warm = run_hmc(lnprob, state, n_steps=300, n_leapfrog=8, adapt=True,
                       store_chain=False)
        res = run_hmc(lnprob, warm.final, n_steps=1500, n_leapfrog=8)

        samples = np.asarray(res.chain).reshape(-1, 2)
        np.testing.assert_allclose(samples.mean(axis=0), 0.0, atol=0.1)
        np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.25)
        acc = np.asarray(res.acceptance_fraction)
        assert acc.mean() > 0.5

    def test_decorrelates_faster_than_stretch(self):
        """On a smooth 8-D Gaussian, HMC's autocorrelation time should beat the
        stretch move by a wide margin at equal lnprob-evaluation budget."""
        ndim = 8
        lnprob = lambda t: -0.5 * jnp.sum(t ** 2)
        rng = np.random.default_rng(1)
        pos = rng.normal(size=(32, ndim))

        state = init_hmc(lnprob, jnp.asarray(pos), jax.random.PRNGKey(1),
                         step_size=0.4)
        warm = run_hmc(lnprob, state, n_steps=200, n_leapfrog=8, adapt=True,
                       store_chain=False)
        res = run_hmc(lnprob, warm.final, n_steps=800, n_leapfrog=8)
        tau_hmc = autocorr_time(np.asarray(res.chain)).max()

        from mcmc_dynamics_jax.sampler import init_state, run_ensemble
        st = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(2))
        ens = run_ensemble(lnprob, st, n_steps=800)
        tau_stretch = autocorr_time(np.asarray(ens.chain)).max()

        assert tau_hmc * 2 < tau_stretch, (tau_hmc, tau_stretch)

    def test_on_model_likelihood(self):
        """HMC through a real model lnprob (bounds -> -inf rejections handled)."""
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(2)
        n = 200
        data = DataReader({
            "ra": u.Quantity(RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(np.full(n, 0.4), "km/s")})
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
        fit = ConstantFit(data, parameters=params)
        lnprob = fit.build_lnprob()

        pos = np.column_stack([rng.normal(0, 1, 16),
                               5.0 + rng.random(16),
                               rng.normal(0, 1, 16), rng.normal(0, 1, 16)])
        state = init_hmc(lnprob, jnp.asarray(pos), jax.random.PRNGKey(3),
                         step_size=0.05)
        warm = run_hmc(lnprob, state, n_steps=200, n_leapfrog=10, adapt=True,
                       store_chain=False)
        res = run_hmc(lnprob, warm.final, n_steps=400, n_leapfrog=10)
        chain = np.asarray(res.chain)
        assert np.isfinite(np.asarray(res.log_prob)).all()
        # sigma posterior concentrates near the truth (6 km/s)
        sig = chain[:, 200:, 1].reshape(-1)
        assert abs(np.median(sig) - 6.0) < 0.6

    def test_jam_gradients_flow(self):
        """End-to-end gradient through the JAM engine inside HMC (a capability the
        reference's C physics cannot provide)."""
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        def lnprob(theta):
            mlr = theta[0]
            res = jam_los_moments(jnp.asarray([10.0, 25.0]), jnp.asarray([0.0, 5.0]),
                                  jnp.asarray([5000.0]), jnp.asarray([20.0]),
                                  jnp.asarray([0.95]), jnp.asarray([10000.0]),
                                  jnp.asarray([20.0]), jnp.asarray([0.95]),
                                  d=5.0, beta=0.0, kappa=0.3, mscale=mlr,
                                  incl=math.radians(60.0), n_u=8, n_zeta=12)
            # pseudo-likelihood pulling sigma toward 10 km/s
            return -jnp.sum((jnp.sqrt(res.v2zz) - 10.0) ** 2)

        state = init_hmc(lnprob, jnp.asarray([[2.0], [2.5], [1.5], [3.0]]),
                         jax.random.PRNGKey(4), step_size=0.02)
        res = run_hmc(lnprob, state, n_steps=60, n_leapfrog=5, adapt=True)
        assert np.isfinite(np.asarray(res.log_prob)).all()
        assert np.asarray(res.acceptance_fraction).mean() > 0.2


class TestMassMatrixAdaptation:
    def test_diagonal_mass_fixes_anisotropy(self):
        """On a Gaussian with 100x scale separation, an identity-mass HMC
        either crawls (small eps) or rejects (large eps); the variance-matched
        diagonal metric samples both dimensions efficiently."""
        scales = jnp.asarray([1.0, 100.0])

        def lnprob(theta):
            return -0.5 * jnp.sum((theta / scales) ** 2)

        rng = np.random.default_rng(0)
        pos = jnp.asarray(rng.normal(size=(32, 2)) * np.asarray(scales))
        state = init_hmc(lnprob, pos, jax.random.PRNGKey(1), step_size=0.05)
        warm = run_hmc(lnprob, state, n_steps=200, n_leapfrog=10, adapt=True,
                       store_chain=False)

        # identity mass: after step-size adaptation the SMALL dimension mixes,
        # the large one barely moves within the same trajectory length
        res_id = run_hmc(lnprob, warm.final, n_steps=400, n_leapfrog=10)
        # matched diagonal metric: m_inv = posterior variance
        warm2 = run_hmc(lnprob, warm.final, n_steps=100, n_leapfrog=10,
                        mass_inv=scales ** 2, adapt=True, store_chain=False)
        res_m = run_hmc(lnprob, warm2.final, n_steps=400, n_leapfrog=10,
                        mass_inv=scales ** 2)

        from mcmc_dynamics_jax.sampler import autocorr_time
        tau_id = autocorr_time(np.asarray(res_id.chain))[1]
        tau_m = autocorr_time(np.asarray(res_m.chain))[1]
        assert tau_m * 3 < tau_id, (tau_m, tau_id)
        # and the matched run recovers the wide dimension's scale
        wide = np.asarray(res_m.chain)[:, 100:, 1].reshape(-1)
        assert abs(np.std(wide) - 100.0) < 15.0

    def test_runner_sample_hmc_uses_estimated_metric(self):
        """Runner.sample_hmc's windowed warmup handles the km/s-vs-arcsec
        scale split of a real model without hand-tuning."""
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(5)
        n = 150
        data = DataReader({
            "ra": u.Quantity(RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n) + 2.0, "km/s"),
            "verr": u.Quantity(np.full(n, 0.4), "km/s")})
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
        fit = ConstantFit(data, parameters=params, seed=9)
        res = fit.sample_hmc(n_walkers=16, n_steps=300, n_warmup=200)
        assert np.isfinite(res.lnprobability).all()
        assert float(np.mean(res.acceptance_fraction)) > 0.5
        v = np.median(res.chain[:, 100:, 0])
        assert abs(v - 2.0) < 1.0

    def test_short_warmup_falls_back_to_identity_metric(self):
        """n_warmup=0/1 cannot support a variance estimate; the old code path
        (identity mass, no phase-2 window) must be used instead of a NaN or
        collapsed metric."""
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(6)
        n = 80
        data = DataReader({
            "ra": u.Quantity(RA_C + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(DEC_C + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(np.full(n, 0.4), "km/s")})
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
        fit = ConstantFit(data, parameters=params, seed=9)
        for n_warmup in (0, 1):
            res = fit.sample_hmc(n_walkers=8, n_steps=40, n_warmup=n_warmup)
            assert np.isfinite(res.lnprobability).all(), n_warmup
