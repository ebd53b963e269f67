"""Tensor-Chebyshev ModelFit tier (ops/model_tensor.py): exactness in the star
sum, mask semantics, the prior-box guard and the ModelFit dispatch rules."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from test_ops import _model_inputs, _model_reference_lnlike

A_BOUNDS = (0.05, 10.0)   # arcmin
R_BOUNDS = (0.05, 10.0)


def _box_params(n_walkers, seed=12):
    """Walkers inside the (a, r_peak) table box (internal arcmin units)."""
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
        rng.uniform(-10, 10, n_walkers),
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.06), np.log(9.0), n_walkers)),
    ])


class TestBinnedTierPosteriorCertification:
    """Posterior-level certification of the radially-binned sufficient tier
    (ops/model_sufficient.py) at its production scale — the same importance-
    reweighting protocol that certified the JAM grid tier (round 5): the
    tier's ~1e-4 lnL binning bias is extensive in N while posterior widths
    shrink ~1/sqrt(N), so moment-level gates alone cannot prove posterior
    safety.  Reweighting binned-chain draws by exp(lnL_direct - lnL_binned)
    yields exact direct-posterior draws; the weighted-vs-unweighted median
    shift IS the tier-induced bias, free of chain-divergence noise.  Run at
    the N where auto turns the tier on (16384)."""

    def test_posterior_unbiased_at_auto_threshold(self, monkeypatch):
        import jax

        from mcmc_dynamics_jax.mock import make_mock_cluster
        from mcmc_dynamics_jax.models import ModelFit

        n_stars, n_walkers, n_steps, n_draws = 16384, 16, 200, 192
        data, truth = make_mock_cluster(n_stars=n_stars, sigma_max=9.0,
                                        v_max=4.0, theta_0=0.8, r_peak=60.0,
                                        a=30.0, seed=8)
        params = ModelFit.default_parameters()
        params["ra_center"].set(value=56.345, fixed=True)
        params["dec_center"].set(value=-26.675, fixed=True)
        # UNBOUNDED a/r_peak priors: in auto mode that is exactly the case
        # the binned tier (not the exact tensor tier) serves at N >= 16384
        params["sigma_max"].set(max=50.0,
                                initials="rng.uniform(8.0, 10.0, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["r_peak"].set(initials="rng.uniform(40, 90, size=n)")
        params["a"].set(initials="rng.uniform(20, 45, size=n)")
        fit = ModelFit(data, parameters=params, seed=3)

        monkeypatch.setenv("MCMC_LNPROB", "auto")
        assert fit._sufficient_eligible() and not fit._tensor_eligible()
        binned = fit.build_lnprob_sufficient()
        pos = fit.get_initials(n_walkers)
        sampler = fit(n_walkers=n_walkers, n_steps=n_steps, pos=pos,
                      prefix=None)
        flat = sampler.chain[:, n_steps // 2:, :].reshape(
            -1, sampler.chain.shape[-1])
        rng = np.random.default_rng(5)
        draws = flat[rng.choice(flat.shape[0], size=n_draws, replace=False)]
        th = jnp.asarray(draws, fit.dtype)

        lnp_binned = np.asarray(binned(th))
        monkeypatch.setenv("MCMC_LNPROB", "direct")
        lnp_direct = np.asarray(fit.build_lnprob_batched()(th))
        assert np.isfinite(lnp_binned).all() and np.isfinite(lnp_direct).all()

        delta = lnp_direct - lnp_binned
        w = np.exp(delta - delta.max())
        w /= w.sum()
        ess = 1.0 / np.sum(w ** 2)
        assert ess > 0.5 * n_draws, ess

        def wmedian(x, weights):
            order = np.argsort(x)
            cw = np.cumsum(weights[order])
            return x[order][np.searchsorted(cw, 0.5)]

        for i, name in enumerate(fit.fitted_parameters):
            x = draws[:, i]
            shift = abs(wmedian(x, w) - np.median(x))
            width = float(np.std(x))
            assert shift < 0.2 * width, (
                f"{name}: binned-tier median shift {shift:.4g} vs posterior "
                f"sigma {width:.4g} ({shift / width:.2f})")


class TestModelTensorStats:
    def test_matches_direct_lnlike(self):
        """Exact in the star sum: f64 agreement with the direct likelihood is
        limited only by the Chebyshev truncation (1e-10 target)."""
        from mcmc_dynamics_jax.ops import ModelTensorStats

        dxm, dym, v, verr2, mask = _model_inputs()
        stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                       mask=mask, s_max=1e6)
        params = _box_params(256)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _model_reference_lnlike(params, dxm, dym, v, verr2, mask)
        np.testing.assert_allclose(got, expected, rtol=1e-8)

    def test_respects_mask(self):
        from mcmc_dynamics_jax.ops import ModelTensorStats

        dxm, dym, v, verr2, mask = _model_inputs(n_stars=600, seed=13)
        mask[300:] = 0.0
        stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                       mask=mask)
        params = _box_params(16, seed=14)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _model_reference_lnlike(params, dxm[:300], dym[:300], v[:300],
                                           verr2[:300], np.ones(300))
        np.testing.assert_allclose(got, expected, rtol=1e-8)

    def test_in_box_guard(self):
        """Walkers outside the (sigma_max, a, r_peak) grid are flagged; inside
        ones are not."""
        from mcmc_dynamics_jax.ops import ModelTensorStats

        dxm, dym, v, verr2, _ = _model_inputs(n_stars=400, seed=15)
        stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                       s_max=1e4)
        inside = _box_params(8, seed=16)
        assert np.asarray(stats.in_box(jnp.asarray(inside))).all()
        for col, bad in ((1, 150.0),       # sigma_max: s > s_max
                         (2, A_BOUNDS[1] * 2), (2, A_BOUNDS[0] / 2),
                         (5, R_BOUNDS[1] * 2), (5, R_BOUNDS[0] / 2)):
            out = inside.copy()
            out[:, col] = bad
            assert not np.asarray(stats.in_box(jnp.asarray(out))).any()

    def test_tucker_compression_certified(self):
        """At f32-level truncation the (s, a) modes compress (measured ranks
        well under the degrees) and the compressed evaluation still matches
        the direct likelihood to the truncation target."""
        from mcmc_dynamics_jax.ops import ModelTensorStats

        dxm, dym, v, verr2, mask = _model_inputs()
        stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                       mask=mask, s_max=1e6, trunc=1e-6)
        assert stats.u_s.shape[1] < stats.n_s   # compression actually engaged
        assert stats.table.shape[0] == stats.u_s.shape[1] * stats.u_a.shape[1]
        params = _box_params(128, seed=21)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _model_reference_lnlike(params, dxm, dym, v, verr2, mask)
        np.testing.assert_allclose(got, expected, rtol=3e-5)

    def test_requires_finite_bounds(self):
        from mcmc_dynamics_jax.ops import ModelTensorStats

        dxm, dym, v, verr2, _ = _model_inputs(n_stars=100, seed=17)
        with pytest.raises(ValueError, match="finite positive"):
            ModelTensorStats.build(dxm, dym, v, verr2, (0.0, np.inf), R_BOUNDS)


class TestModelFitTensorDispatch:
    def _fit(self, n=400, a_max=600.0, r_max=600.0, seed=15):
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ModelFit
        from mcmc_dynamics_jax.utils import DataReader

        ra_c, dec_c = 56.345, -26.675
        rng = np.random.default_rng(seed)
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.03 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.03 * rng.normal(size=n), "deg"),
            "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ModelFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        params["r_peak"].set(min=1.0, max=r_max)   # arcsec
        params["a"].set(min=1.0, max=a_max)
        return ModelFit(data, parameters=params), rng

    def test_forced_tier_matches_direct(self):
        fit, rng = self._fit()
        # auto: below the catalog-size threshold, and bounded priors alone
        # must not flip the tier on
        assert not fit._tensor_eligible()

        thetas = jnp.asarray(np.column_stack([
            rng.normal(0, 2, 32),
            np.exp(rng.uniform(np.log(1.0), np.log(60.0), 32)),
            rng.uniform(30, 500, 32),    # a (arcsec, declared unit)
            rng.normal(0, 3, 32),
            rng.normal(0, 3, 32),
            rng.uniform(30, 500, 32),    # r_peak (arcsec)
        ]), fit.dtype)

        try:
            os.environ["MCMC_LNPROB"] = "tensor"
            assert fit._tensor_eligible()
            fast = fit.build_lnprob_batched()
            os.environ["MCMC_LNPROB"] = "direct"
            direct = fit.build_lnprob_batched()
        finally:
            del os.environ["MCMC_LNPROB"]
        np.testing.assert_allclose(np.asarray(fast(thetas)),
                                   np.asarray(direct(thetas)),
                                   rtol=1e-7, atol=1e-6)

    def test_out_of_box_walkers_get_neg_inf(self):
        fit, rng = self._fit(a_max=300.0, r_max=300.0)
        thetas = np.column_stack([
            rng.normal(0, 2, 8), np.full(8, 10.0), np.full(8, 100.0),
            rng.normal(0, 3, 8), rng.normal(0, 3, 8), np.full(8, 100.0)])
        thetas[:4, 2] = 400.0   # a beyond its 300 arcsec prior bound
        try:
            os.environ["MCMC_LNPROB"] = "tensor"
            lnp = np.asarray(fit.build_lnprob_batched()(
                jnp.asarray(thetas, fit.dtype)))
        finally:
            del os.environ["MCMC_LNPROB"]
        assert np.isneginf(lnp[:4]).all()
        assert np.isfinite(lnp[4:]).all()

    def test_unbounded_priors_are_ineligible(self):
        """auto mode quietly skips the tier without a prior box; forcing it
        is a hard error."""
        fit, _ = self._fit(a_max=np.inf)
        assert fit._tensor_bounds() is None
        assert not fit._tensor_eligible()
        try:
            os.environ["MCMC_LNPROB"] = "tensor"
            with pytest.raises(ValueError, match="finite positive"):
                fit._tensor_eligible()
        finally:
            del os.environ["MCMC_LNPROB"]

    def test_gb_variants_opt_out(self):
        from mcmc_dynamics_jax.models import ModelFitGB

        fit, _ = self._fit()
        data = fit.data
        data.data["density"] = 10.0 ** np.random.default_rng(3).uniform(
            -1, 2, len(data.data["v"]))
        gparams = ModelFitGB.default_parameters()
        gparams["ra_center"].set(value=fit.parameters["ra_center"].value,
                                 fixed=True)
        gparams["dec_center"].set(value=fit.parameters["dec_center"].value,
                                  fixed=True)
        gfit = ModelFitGB(data, parameters=gparams)
        try:
            os.environ["MCMC_LNPROB"] = "tensor"
            assert not gfit._tensor_eligible()
        finally:
            del os.environ["MCMC_LNPROB"]
