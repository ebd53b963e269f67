"""ChemoProfiles: multi-population chemo-dynamical likelihood."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ChemoProfiles
from mcmc_dynamics_jax.utils import DataReader, MgeReader, Table

RA_C, DEC_C = 56.345, -26.675


def _tagged_mges():
    lum = MgeReader(Table({"i": u.Quantity([5000.0, 800.0], "solLum/pc2"),
                           "s": u.Quantity([10.0, 40.0], "arcsec"),
                           "q": [0.9, 0.9], "pop": [0, 1]}), lum=True)
    mass = MgeReader(Table({"i": u.Quantity([5000.0, 800.0], "solMass/pc2"),
                            "s": u.Quantity([10.0, 40.0], "arcsec"),
                            "q": [0.9, 0.9]}), lum=False)
    return lum, mass


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0, 40, n)) + 1.0
    phi = rng.uniform(-np.pi, np.pi, n)
    x, y = r * np.cos(phi), r * np.sin(phi)
    ra = RA_C - (x / 3600.0) / math.cos(math.radians(DEC_C))
    dec = DEC_C + y / 3600.0
    # two populations in [Fe/H]
    pop = rng.random(n) < 0.6
    feh = np.where(pop, -0.5, 0.2) + 0.1 * rng.normal(size=n)
    return DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                       "v": u.Quantity(3.0 * rng.normal(size=n), "km/s"),
                       "verr": u.Quantity(np.full(n, 0.3), "km/s"),
                       "feh": feh, "feherr": np.full(n, 0.05)})


def _fixed_params(**free):
    params = ChemoProfiles.default_parameters(2)
    fixed = dict(d=5.0, mlr_0=2.0, mlr_t=2.0, mlr_inf=2.0, r_mlr=20.0, barq=0.5,
                 beta=0.0, ra_center=RA_C, dec_center=DEC_C,
                 mu_feh_a=-0.5, sigma_feh_a=0.12, kappa_max_a=0.4,
                 logr_kappa_a=math.log10(20.0 / 60.0),
                 mu_feh_b=0.2, sigma_feh_b=0.1, kappa_max_b=-0.2,
                 logr_kappa_b=math.log10(30.0 / 60.0),
                 h_aa=0.9, h_ab=0.2)
    for name, val in fixed.items():
        params[name].set(value=val, fixed=True)
    for name, spec in free.items():
        params[name].set(fixed=False, **spec)
    return params


class TestChemoProfiles:
    def test_parameter_set_and_mixing_constraints(self):
        params = ChemoProfiles.default_parameters(3)
        # derived last-row entries exist and are fixed
        assert params["h_cc"].fixed and params["h_cb"].expr is not None
        cp = params.compile()
        theta = cp.sample_initials(4)
        vals = cp.expand(jnp.asarray(theta[0]))
        for q in "abc":
            total = sum(float(np.asarray(vals[f"h_{p}{q}"])) for p in "abc")
            assert math.isclose(total, 1.0, rel_tol=1e-12)

    def test_lnlike_finite_and_responsive(self):
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mu_feh_a=dict(min=-1.0, max=1.0))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2)
        fit.n_u, fit.n_zeta = 12, 16
        v_good = float(fit.lnprob(np.array([-0.5])))
        v_bad = float(fit.lnprob(np.array([-0.9])))  # wrong population metallicity
        assert np.isfinite(v_good)
        assert v_good > v_bad

    def test_feh_ordering_prior(self):
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mu_feh_a=dict(min=-1.0, max=1.0))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2)
        fit.n_u, fit.n_zeta = 12, 16
        # mu_feh_a above mu_feh_b (= 0.2) crosses the ordering prior
        assert float(fit.lnprob(np.array([0.5]))) == -np.inf

    def test_mixing_recovery(self):
        """Sampling h_aa should prefer values matching the generated populations."""
        data = _data(n=200, seed=3)
        lum, mass = _tagged_mges()
        params = _fixed_params(h_aa=dict(min=0.0, max=1.0,
                                         initials="rng.uniform(0.2, 0.95, size=n)"))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=4)
        fit.n_u, fit.n_zeta = 8, 12
        sampler = fit(n_walkers=8, n_steps=60, prefix=None)
        assert np.isfinite(sampler.lnprobability[:, -1]).all()

    def test_missing_pop_tags_rejected(self):
        data = _data()
        lum, mass = _tagged_mges()
        del lum.data.columns["pop"]
        with pytest.raises(IOError):
            ChemoProfiles(data, mge_mass=mass, mge_lum=lum, n_pops=2)

    def test_mge_grid_mode_rejected_with_clear_error(self):
        """The AnalyticalProfiles centre-offset MGE grid is unsupported here and
        must fail at construction with an explanation, not an opaque crash."""
        data = _data()
        lum, mass = _tagged_mges()
        with pytest.raises(ValueError, match="mge_files"):
            ChemoProfiles(data, mge_mass=mass, mge_lum=lum, n_pops=2,
                          mge_files={"fake": "grid"})
        with pytest.raises(ValueError, match="explicit mge_mass and mge_lum"):
            ChemoProfiles(data, mge_mass=None, mge_lum=None, n_pops=2)

    def test_create_profiles_per_population(self):
        data = _data(n=80)
        lum, mass = _tagged_mges()
        params = _fixed_params(h_aa=dict(min=0.0, max=1.0,
                                         initials="rng.uniform(0.5, 0.95, size=n)"))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2)
        fit.n_u, fit.n_zeta = 8, 12
        sampler = fit(n_walkers=8, n_steps=16, prefix=None)
        profiles = fit.create_profiles(sampler.chain, n_burn=8, n_samples=6,
                                       radii=u.Quantity(np.logspace(0, 2, 10),
                                                        "arcsec"), n_theta=4)
        assert set(profiles) == {0, 1}
        for tab in profiles.values():
            assert np.all(np.isfinite(tab.value("sigma")))


class TestChemoRecovery:
    def test_mu_feh_recovery(self):
        """Sampling one population's metallicity centre recovers the generated
        value (the rest of the model held at truth)."""
        data = _data(n=250, seed=11)
        lum, mass = _tagged_mges()
        params = _fixed_params(
            mu_feh_a=dict(min=-1.0, max=0.1,
                          initials="rng.uniform(-0.9, 0.0, size=n)"))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=12)
        fit.n_u, fit.n_zeta = 8, 12
        sampler = fit(n_walkers=16, n_steps=120, prefix=None)
        best = fit.compute_bestfit_values(sampler.chain, n_burn=60)
        # generated population A sits at [Fe/H] = -0.5 with sigma 0.1-0.12
        assert abs(best.value("mu_feh_a")[0] - (-0.5)) < 0.06


class TestChemoRegressions:
    """Review-pass fixes: default initials must start inside the prior, and
    the mass posterior must work for the chemo parameter set."""

    def test_three_population_default_initials_respect_simplex(self):
        """n_pops >= 3 used to draw free h rows i.i.d. U(0,1), making the
        derived last row negative for ~half the walkers and bricking the
        startup prior check."""
        params = ChemoProfiles.default_parameters(3)
        cp = params.compile()
        theta = cp.sample_initials(200)
        lnp = np.array([float(np.asarray(cp.lnprior(jnp.asarray(t))))
                        for t in theta[:50]])
        # the h-part of the prior can never be -inf from the simplex
        for t in theta[:50]:
            vals = cp.expand(jnp.asarray(t))
            for q in "abc":
                last = float(np.asarray(vals[f"h_c{q}"]))
                assert last >= 0.0, (q, last)

    def test_r_mlr_initials_rederived_from_mge_bounds(self):
        """AnalyticalProfiles tightens r_mlr bounds to the MGE sigma range
        after construction; the stock lognormal initials (median 1 arcsec)
        must be replaced so sampling can start."""
        from mcmc_dynamics_jax.models import AnalyticalProfiles

        data = _data()
        lum, mass = _tagged_mges()    # sigmas 10-40 arcsec: lognormal fails
        params = AnalyticalProfiles.default_parameters()
        for name, val in dict(d=5.0, barq=0.5, beta=0.0, ra_center=RA_C,
                              dec_center=DEC_C, kappa_x=0.3, kappa_y=0.0,
                              r_kappa=20.0).items():
            params[name].set(value=val, fixed=True)
        fit = AnalyticalProfiles(data, mge_mass=mass, mge_lum=lum,
                                 parameters=params)
        draws = fit.compiled.sample_initials(100)
        i = fit.compiled.free_names.index("r_mlr")
        assert (draws[:, i] >= 10.0).all() and (draws[:, i] <= 40.0).all()

    def test_compute_mass_posterior_for_chemo(self):
        """Inherited compute_mass_posterior used to crash with KeyError
        ('kappa_x') on the chemo parameter set."""
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mlr_0=dict(min=0.5, max=6.0,
                                          initials="rng.uniform(1.0, 4.0, size=n)"))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=7)
        res = fit(n_walkers=8, n_steps=20, prefix=None)
        masses = fit.compute_mass_posterior(res.chain, n_burn=5, n_samples=40)
        assert masses.shape == (40,)
        assert np.isfinite(masses).all() and (masses > 0).all()

    def test_create_profiles_accepts_filename(self, tmp_path):
        """The driver calls create_profiles(filename=...) polymorphically."""
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mu_feh_a=dict(min=-1.0, max=1.0))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=8)
        res = fit(n_walkers=8, n_steps=16, prefix=None)
        profiles = fit.create_profiles(res.chain, n_burn=8, n_samples=5,
                                       n_theta=4,
                                       filename=str(tmp_path / "prof.ecsv"))
        assert set(profiles) == {0, 1}
        assert (tmp_path / "prof_pop0.ecsv").exists()
        assert (tmp_path / "prof_pop1.ecsv").exists()

    def test_predict_fields_per_population(self):
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mu_feh_a=dict(min=-1.0, max=1.0))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=9)
        res = fit(n_walkers=8, n_steps=16, prefix=None)
        pred = fit.predict_fields(res.chain, n_burn=8,
                                  ra=u.Quantity([RA_C], "deg"),
                                  dec=u.Quantity([DEC_C + 0.005], "deg"),
                                  n_samples=4)
        assert set(pred) == {0, 1}
        for t in pred.values():
            assert np.isfinite(np.asarray(t.value("v_los"))).all()
            assert np.isfinite(np.asarray(t.value("sigma_los"))).all()

    def test_single_component_population_rotates(self):
        """Regression: a population owning ONE MGE component got a kappa
        anchor of 0 (innermost/outermost rules colliding), silently zeroing
        its rotation for any kappa_max.  Counter-rotating single-component
        populations must now produce opposite-signed predictive v_los."""
        data = _data()
        lum, mass = _tagged_mges()
        params = _fixed_params(mu_feh_a=dict(min=-1.0, max=0.1))
        params["kappa_max_a"].set(value=0.6)
        params["kappa_max_b"].set(value=-0.6)
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum, parameters=params,
                            n_pops=2, seed=3)
        fit.n_u, fit.n_zeta = 8, 12
        assert np.all(np.asarray(fit._x_kappa) > 0)
        res = fit(n_walkers=8, n_steps=16, prefix=None)
        ra_p = u.Quantity(
            [RA_C - (20.0 / 3600.0) / math.cos(math.radians(DEC_C))], "deg")
        pred = fit.predict_fields(res.chain, n_burn=8, ra=ra_p,
                                  dec=u.Quantity([DEC_C], "deg"), n_samples=4)
        va = float(pred[0].value("v_los")[0])
        vb = float(pred[1].value("v_los")[0])
        assert va > 0.05 and vb < -0.05, (va, vb)
