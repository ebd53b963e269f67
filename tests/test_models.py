"""Model-likelihood correctness vs independent NumPy implementations, plus
end-to-end mock-data recovery (automated version of the reference's bin/run_tests.py).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.background import Gaussian, SingleStars
from mcmc_dynamics_jax.models import (ConstantFit, ConstantFitGB, DoubleModelFit,
                                      DoubleModelFitGB, ModelFit,
                                      ModelFitConstantBackground, ModelFitGB)
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


# --------------------------------------------------------------------------- helpers
def _np_xy_offset(ra, dec, ra_c, dec_c):
    """Independent NumPy implementation of the van de Ven+06 projection (arcmin)."""
    r0 = 10800.0 / np.pi
    ra, dec, ra_c, dec_c = map(np.radians, (ra, dec, ra_c, dec_c))
    dx = -r0 * np.cos(dec) * np.sin(ra - ra_c)
    dy = r0 * (np.sin(dec) * np.cos(dec_c) - np.cos(dec) * np.sin(dec_c) * np.cos(ra - ra_c))
    return dx, dy


def _np_gauss_lnlike(v, verr, v_los, sigma_los):
    norm = verr ** 2 + sigma_los ** 2
    return -0.5 * np.log(2 * np.pi * norm) - 0.5 * (v - v_los) ** 2 / norm


def _make_catalog(n=300, seed=0, with_density=False):
    rng = np.random.default_rng(seed)
    ra = RA_C + 0.03 * rng.normal(size=n)
    dec = DEC_C + 0.03 * rng.normal(size=n)
    v = 5.0 * rng.normal(size=n)
    verr = 0.5 + 0.5 * rng.random(n)
    cols = {"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
            "v": u.Quantity(v, "km/s"), "verr": u.Quantity(verr, "km/s")}
    if with_density:
        cols["density"] = np.exp(-0.5 * (rng.random(n)))
    return DataReader(cols)


def _fix_centers(params):
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    return params


# --------------------------------------------------------------------------- lnlike values
class TestConstantFitLnlike:
    def test_matches_numpy_reference_formula(self):
        data = _make_catalog()
        params = _fix_centers(ConstantFit.default_parameters())
        fit = ConstantFit(data, parameters=params)

        theta = np.array([1.3, 6.0, 2.0, -3.0])  # v_sys, sigma_max, v_maxx, v_maxy
        got = float(fit.lnlike(theta))

        ra = data.data.value("ra")
        dec = data.data.value("dec")
        dx, dy = _np_xy_offset(ra, dec, RA_C, DEC_C)
        theta_pos = np.arctan2(dy, dx)
        v_max = math.hypot(2.0, -3.0)
        theta_0 = math.atan2(-3.0, 2.0)
        v_los = 1.3 + v_max * np.sin(theta_pos - theta_0)
        expected = _np_gauss_lnlike(data.data.value("v"), data.data.value("verr"),
                                    v_los, 6.0).sum()
        assert math.isclose(got, expected, rel_tol=1e-10)

    def test_lnprob_adds_prior_and_bounds(self):
        data = _make_catalog()
        params = _fix_centers(ConstantFit.default_parameters())
        fit = ConstantFit(data, parameters=params)
        theta_bad = np.array([0.0, -1.0, 0.0, 0.0])  # sigma < 0
        assert float(fit.lnprob(theta_bad)) == -np.inf
        theta_ok = np.array([0.0, 5.0, 0.0, 0.0])
        assert math.isclose(float(fit.lnprob(theta_ok)), float(fit.lnlike(theta_ok)),
                            rel_tol=1e-12)

    def test_free_center_changes_likelihood(self):
        data = _make_catalog()
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=RA_C, min=RA_C - 0.1, max=RA_C + 0.1)
        params["dec_center"].set(value=DEC_C, min=DEC_C - 0.1, max=DEC_C + 0.1)
        fit = ConstantFit(data, parameters=params)
        t1 = np.array([0.0, 5.0, 2.0, 1.0, RA_C, DEC_C])
        t2 = np.array([0.0, 5.0, 2.0, 1.0, RA_C + 0.01, DEC_C])
        assert not math.isclose(float(fit.lnlike(t1)), float(fit.lnlike(t2)))


class TestModelFitLnlike:
    def test_matches_numpy_reference_formula(self):
        data = _make_catalog()
        params = _fix_centers(ModelFit.default_parameters())
        fit = ModelFit(data, parameters=params)

        # v_sys, sigma_max, a[arcsec], v_maxx, v_maxy, r_peak[arcsec]
        theta = np.array([0.7, 8.0, 30.0, 3.0, -1.0, 60.0])
        got = float(fit.lnlike(theta))

        ra, dec = data.data.value("ra"), data.data.value("dec")
        dx, dy = _np_xy_offset(ra, dec, RA_C, DEC_C)
        r = np.hypot(dx, dy)
        r_peak, a = 60.0 / 60.0, 30.0 / 60.0  # arcsec -> arcmin
        v_max, theta_0 = math.hypot(3.0, -1.0), math.atan2(-1.0, 3.0)
        x_pa = r * np.sin(np.arctan2(dy, dx) - theta_0)
        v_los = 0.7 + 2.0 * (v_max / r_peak) * x_pa / (1.0 + (r / r_peak) ** 2)
        sigma_los = 8.0 / (1.0 + r ** 2 / a ** 2) ** 0.25
        expected = _np_gauss_lnlike(data.data.value("v"), data.data.value("verr"),
                                    v_los, sigma_los).sum()
        assert math.isclose(got, expected, rel_tol=1e-10)


class TestBackgroundModels:
    def test_gaussian_background_values(self):
        bg = Gaussian(u.Quantity(10.0, "km/s"), u.Quantity(4.0, "km/s"))
        v = np.array([8.0, 12.0])
        verr = np.array([1.0, 2.0])
        got = bg(v, verr)
        expected = _np_gauss_lnlike(v, verr, 10.0, 4.0)
        np.testing.assert_allclose(got, expected, rtol=1e-12)

    def test_single_stars_matches_bruteforce(self):
        rng = np.random.default_rng(0)
        vcat = rng.normal(20.0, 15.0, size=50)
        bg = SingleStars(u.Quantity(vcat, "km/s"))
        v = rng.normal(0.0, 10.0, size=20)
        verr = 0.5 + rng.random(20)
        got = bg(v, verr, sigma_int=u.Quantity(2.0, "km/s"))
        norm = 2.0 ** 2 + verr ** 2
        brute = np.log(np.mean(
            np.exp(-np.subtract.outer(vcat, v) ** 2 / (2 * norm))
            / np.sqrt(2 * np.pi * norm), axis=0))
        np.testing.assert_allclose(got, brute, rtol=1e-10)

    def test_mixture_lnlike_with_fixed_background(self):
        data = _make_catalog(with_density=False)
        rng = np.random.default_rng(5)
        data.data["pmember"] = 0.2 + 0.6 * rng.random(data.sample_size)
        bg = Gaussian(u.Quantity(30.0, "km/s"), u.Quantity(50.0, "km/s"))

        params = _fix_centers(ConstantFit.default_parameters())
        fit = ConstantFit(data, parameters=params, background=bg)
        theta = np.array([1.0, 5.0, 1.0, 0.5])
        got = float(fit.lnlike(theta))

        ra, dec = data.data.value("ra"), data.data.value("dec")
        dx, dy = _np_xy_offset(ra, dec, RA_C, DEC_C)
        v_max, theta_0 = math.hypot(1.0, 0.5), math.atan2(0.5, 1.0)
        v_los = 1.0 + v_max * np.sin(np.arctan2(dy, dx) - theta_0)
        v, verr = data.data.value("v"), data.data.value("verr")
        lnl_m = _np_gauss_lnlike(v, verr, v_los, 5.0)
        lnl_b = _np_gauss_lnlike(v, verr, 30.0, 50.0)
        pm = data.data.value("pmember")
        expected = np.logaddexp(np.log(pm) + lnl_m, np.log(1 - pm) + lnl_b).sum()
        assert math.isclose(got, expected, rel_tol=1e-10)


class TestGBModels:
    def test_constant_gb_matches_numpy(self):
        data = _make_catalog(with_density=True)
        params = _fix_centers(ConstantFitGB.default_parameters())
        fit = ConstantFitGB(data, parameters=params)
        # v_sys, sigma_max, v_maxx, v_maxy, v_back, sigma_back, f_back
        theta = np.array([0.5, 5.0, 1.0, -1.0, 20.0, 40.0, 0.3])
        got = float(fit.lnlike(theta))

        ra, dec = data.data.value("ra"), data.data.value("dec")
        dx, dy = _np_xy_offset(ra, dec, RA_C, DEC_C)
        v_max, theta_0 = math.hypot(1.0, -1.0), math.atan2(-1.0, 1.0)
        v_los = 0.5 + v_max * np.sin(np.arctan2(dy, dx) - theta_0)
        v, verr = data.data.value("v"), data.data.value("verr")
        lnl_c = _np_gauss_lnlike(v, verr, v_los, 5.0)
        lnl_b = _np_gauss_lnlike(v, verr, 20.0, 40.0)
        density = data.data.value("density")
        m = density / (density + 0.3)
        expected = np.logaddexp(np.log(m) + lnl_c, np.log(1 - m) + lnl_b).sum()
        assert math.isclose(got, expected, rel_tol=1e-10)

    def test_membership_probabilities_in_unit_interval(self):
        data = _make_catalog(with_density=True, n=150)
        params = _fix_centers(ConstantFitGB.default_parameters())
        fit = ConstantFitGB(data, parameters=params)
        pos = fit.get_initials(16)
        sampler = fit(n_walkers=16, n_steps=30, pos=pos, prefix=None)
        p = fit.calculate_membership_probabilities(sampler.chain, n_burn=10)
        assert p.shape == (150,)
        assert np.all(p >= 0) and np.all(p <= 1)

    def test_model_constant_background(self):
        data = _make_catalog(with_density=True)
        bg = Gaussian(u.Quantity(25.0, "km/s"), u.Quantity(60.0, "km/s"))
        params = _fix_centers(ModelFitConstantBackground.default_parameters())
        fit = ModelFitConstantBackground(data, background=bg, parameters=params)
        theta = np.array([0.0, 6.0, 30.0, 1.0, 1.0, 60.0, 0.2])
        val = float(fit.lnlike(theta))
        assert np.isfinite(val)
        # mixing weight changes the likelihood
        theta2 = theta.copy()
        theta2[-1] = 0.8
        assert not math.isclose(val, float(fit.lnlike(theta2)))


class TestDoubleModel:
    def test_reduces_to_single_when_secondary_zero(self):
        data = _make_catalog()
        dparams = _fix_centers(DoubleModelFit.default_parameters())
        dfit = DoubleModelFit(data, parameters=dparams)
        mparams = _fix_centers(ModelFit.default_parameters())
        mfit = ModelFit(data, parameters=mparams)

        # secondary amplitude ~0 -> same lnlike as single model
        # model order: v_sys, sigma_max, a, v_maxx, v_maxy, r_peak (+_c's)
        base = np.array([0.5, 7.0, 25.0, 2.0, 1.0, 50.0])
        dtheta = np.concatenate([base, [1e-12, 1e-12, 10.0]])
        got_d = float(dfit.lnlike(dtheta))
        got_m = float(mfit.lnlike(base))
        # NOTE: double model uses x_pa/r_peak in the denominator, single uses r/r_peak,
        # so they agree only at small amplitude... they differ in v_rot shape; compare
        # with an independent numpy evaluation of the double formula instead.
        ra, dec = data.data.value("ra"), data.data.value("dec")
        dx, dy = _np_xy_offset(ra, dec, RA_C, DEC_C)
        r = np.hypot(dx, dy)
        theta_pos = np.arctan2(dy, dx)
        v_max, th0 = math.hypot(2.0, 1.0), math.atan2(1.0, 2.0)
        x_pa = r * np.sin(theta_pos - th0)
        rp = 50.0 / 60.0
        v_los = 0.5 + 2.0 * (v_max / rp) * x_pa / (1.0 + (x_pa / rp) ** 2)
        a = 25.0 / 60.0
        sigma = 7.0 / (1.0 + r ** 2 / a ** 2) ** 0.25
        expected = _np_gauss_lnlike(data.data.value("v"), data.data.value("verr"),
                                    v_los, sigma).sum()
        assert math.isclose(got_d, expected, rel_tol=1e-8)

    def test_joint_prior_enforced(self):
        data = _make_catalog()
        params = _fix_centers(DoubleModelFit.default_parameters())
        fit = DoubleModelFit(data, parameters=params)
        # r_peak_c > r_peak -> -inf
        theta = np.array([0.0, 5.0, 30.0, 1.0, 1.0, 40.0, 1.0, 1.0, 80.0])
        assert float(fit.lnprob(theta)) == -np.inf
        theta_ok = np.array([0.0, 5.0, 30.0, 1.0, 1.0, 40.0, 1.0, 1.0, 20.0])
        assert np.isfinite(float(fit.lnprob(theta_ok)))


# --------------------------------------------------------------------------- end-to-end
class TestMockRecovery:
    """Automated analog of the reference verification harness bin/run_tests.py:
    synthesize a cluster with known parameters and check the fit recovers them."""

    def _mock_data(self, n=400, seed=42):
        rng = np.random.default_rng(seed)
        truth = dict(v_sys=0.0, sigma_max=8.0, v_max=5.0, theta_0=0.8,
                     r_peak=60.0, a=30.0)  # radii in arcsec

        r = np.abs(rng.normal(0.0, 90.0, size=n))  # arcsec
        phi = rng.uniform(-np.pi, np.pi, size=n)
        # place stars on sky around the centre
        dx_deg = -(r / 3600.0) * np.cos(phi) / math.cos(math.radians(DEC_C))
        ra = RA_C + dx_deg  # note: dx increases westward = -RA direction
        dec = DEC_C + (r / 3600.0) * np.sin(phi)

        x_pa = r * np.sin(phi - truth["theta_0"])
        v_los = truth["v_sys"] + 2 * (truth["v_max"] / truth["r_peak"]) * x_pa / (
            1 + (r / truth["r_peak"]) ** 2)
        sigma_los = truth["sigma_max"] / (1 + r ** 2 / truth["a"] ** 2) ** 0.25
        v = v_los + sigma_los * rng.normal(size=n)
        verr = 0.3 + 0.2 * rng.random(n)
        v = v + verr * rng.normal(size=n)

        data = DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                           "v": u.Quantity(v, "km/s"),
                           "verr": u.Quantity(verr, "km/s")})
        return data, truth

    def test_constant_fit_recovers_dispersion_and_rotation(self):
        data, truth = self._mock_data()
        params = _fix_centers(ConstantFit.default_parameters())
        params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.5, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=3, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=3, size=n)")
        fit = ConstantFit(data, parameters=params, seed=1)
        sampler = fit(n_walkers=64, n_steps=400, prefix=None)

        best = fit.compute_bestfit_values(sampler.chain, n_burn=200)
        sigma_med = best.value("sigma_max")[0]
        # single-bin constant fit sees the density-weighted mean dispersion
        assert 5.0 < sigma_med < 9.0

        tv = fit.compute_theta_vmax(sampler.chain, n_burn=200)
        theta_med = tv.value("theta_0")[0]
        d_theta = abs(((theta_med - truth["theta_0"]) + np.pi) % (2 * np.pi) - np.pi)
        assert d_theta < 0.6

    def test_model_fit_recovers_global_profile(self):
        data, truth = self._mock_data(n=600, seed=3)
        params = _fix_centers(ModelFit.default_parameters())
        params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.3, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=3, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=3, size=n)")
        params["r_peak"].set(min=5.0, max=300.0,
                             initials="rng.uniform(20, 150, size=n)")
        params["a"].set(min=5.0, max=300.0, initials="rng.uniform(10, 100, size=n)")
        fit = ModelFit(data, parameters=params, seed=2)
        sampler = fit(n_walkers=64, n_steps=600, prefix=None)

        best = fit.compute_bestfit_values(sampler.chain, n_burn=300)
        assert abs(best.value("sigma_max")[0] - truth["sigma_max"]) < 1.5
        assert abs(best.value("v_sys")[0] - truth["v_sys"]) < 1.0

        profile = fit.create_profiles(sampler.chain, n_burn=300)
        assert "v_rot" in profile and "sigma_upper_3s" in profile
        # dispersion profile must decline outward
        s = profile.value("sigma")
        assert s[0] > s[-1]

    def test_fit_raises_on_invalid_initials(self):
        data, _ = self._mock_data(n=100)
        params = _fix_centers(ConstantFit.default_parameters())
        fit = ConstantFit(data, parameters=params)
        bad = np.zeros((8, 4))
        bad[:, 1] = -1.0  # sigma_max < 0 violates prior
        with pytest.raises(ValueError):
            fit(n_walkers=8, n_steps=10, pos=bad, prefix=None)


class TestParameterMutationInvalidation:
    def test_lnprob_recompiles_after_parameter_set(self):
        """Mutating parameters after the first likelihood call must take effect
        (the compiled closures are cached on a parameter fingerprint)."""
        data = _make_catalog(n=100)
        params = _fix_centers(ConstantFit.default_parameters())
        fit = ConstantFit(data, parameters=params)
        theta = np.array([0.0, 5.0, 0.0, 0.0])
        before = float(fit.lnprob(theta))
        assert np.isfinite(before)
        # tighten the sigma bound to exclude the current value
        fit.parameters["sigma_max"].set(min=6.0, max=50.0)
        assert float(fit.lnprob(theta)) == -np.inf
        # free parameter count changes are picked up too
        fit.parameters["v_maxy"].set(fixed=True, value=0.0)
        assert fit.n_fitted_parameters == 3
        assert np.isfinite(float(fit.lnprob(np.array([0.0, 7.0, 0.0]))))


class TestSampleToConvergence:
    def test_tau_driven_autostop(self):
        """The chain stops itself once longer than tau_factor autocorrelation
        times with a stabilised tau estimate, and reports both."""
        data = _make_catalog(n=120)
        params = _fix_centers(ConstantFit.default_parameters())
        params["sigma_max"].set(max=100.0)
        fit = ConstantFit(data, parameters=params, seed=2)
        res = fit.sample_to_convergence(n_walkers=32, max_steps=8000,
                                        check_every=1000, tau_factor=50.0,
                                        rel_change=0.1, prefix=None)
        assert res.converged
        assert res.tau.shape == (4,)
        assert res.chain.shape[1] > 50.0 * res.tau.max()
        # the certified chain passes its own accessor-level guard
        tau2 = res.get_autocorr_time()
        np.testing.assert_allclose(tau2, res.tau, rtol=1e-12)

    def test_max_steps_gives_up_cleanly(self):
        data = _make_catalog(n=120)
        params = _fix_centers(ConstantFit.default_parameters())
        params["sigma_max"].set(max=100.0)
        fit = ConstantFit(data, parameters=params, seed=2)
        res = fit.sample_to_convergence(n_walkers=32, max_steps=300,
                                        check_every=150, prefix=None)
        assert not res.converged
        assert res.chain.shape[1] == 300


class TestPredictFields:
    def test_posterior_predictive_fields_on_user_grid(self):
        """predict_fields serves (v_los, sigma_los) with uncertainties at
        arbitrary sky positions from the posterior — the rotation signal must
        flip sign across the rotation axis and sigma must stay near truth."""
        rng = np.random.default_rng(3)
        n = 400
        # inject a strong rotation: v = 20 * sin(theta) (v_maxx = 20)
        dx = 0.02 * rng.normal(size=n)   # deg offsets
        dy = 0.02 * rng.normal(size=n)
        r = np.hypot(dx, dy)
        v = 20.0 * (dy / np.maximum(r, 1e-9)) + 5.0 * rng.normal(size=n)
        data = DataReader({
            "ra": u.Quantity(RA_C - dx / np.cos(np.radians(DEC_C)), "deg"),
            "dec": u.Quantity(DEC_C + dy, "deg"),
            "v": u.Quantity(v, "km/s"),
            "verr": u.Quantity(np.full(n, 0.5), "km/s")})
        params = _fix_centers(ConstantFit.default_parameters())
        params["sigma_max"].set(max=50.0)
        fit = ConstantFit(data, parameters=params, seed=4)
        res = fit(n_walkers=32, n_steps=400, prefix=None)

        pred = fit.predict_fields(res.chain, n_burn=200,
                                  ra=u.Quantity([RA_C, RA_C], "deg"),
                                  dec=u.Quantity([DEC_C + 0.02,
                                                  DEC_C - 0.02], "deg"),
                                  n_samples=100)
        v_n = float(pred.value("v_los")[0])   # north of centre: +v_maxx side
        v_s = float(pred.value("v_los")[1])
        assert v_n > 10.0 and v_s < -10.0, (v_n, v_s)
        sig = np.asarray(pred.value("sigma_los"))
        assert np.all(np.abs(sig - 5.0) < 1.5)
        # uncertainty bounds bracket the medians
        assert np.all(pred.value("v_los_lower_1s") <= pred.value("v_los"))
        assert np.all(pred.value("v_los") <= pred.value("v_los_upper_1s"))
