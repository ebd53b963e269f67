"""Centre-offset fitting (the capability behind the reference's 5139_center
workflow): ra_center/dec_center sampled as free parameters and recovered."""

import math

import numpy as np

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.mock import make_mock_cluster
from mcmc_dynamics_jax.models import ModelFit

RA_C, DEC_C = 56.345, -26.675


class TestFreeCenterFit:
    def test_center_recovered_from_offset_start(self):
        # strong central concentration + dispersion gradient localise the centre
        data, truth = make_mock_cluster(n_stars=600, ra_center=RA_C,
                                        dec_center=DEC_C, sigma_max=10.0,
                                        v_max=4.0, theta_0=0.7, r_peak=60.0,
                                        a=30.0, seed=11)
        params = ModelFit.default_parameters()
        params["sigma_max"].set(initials="rng.lognormal(mean=2.3, sigma=0.3, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["r_peak"].set(min=5.0, max=300.0,
                             initials="rng.uniform(30, 120, size=n)")
        params["a"].set(min=5.0, max=300.0, initials="rng.uniform(15, 60, size=n)")
        # centre free, initialised OFF-centre by ~0.5 arcmin
        span = 0.02
        params["ra_center"].set(value=RA_C, min=RA_C - span, max=RA_C + span,
                                initials=f"rng.normal(loc={RA_C + 0.008}, "
                                         "scale=0.003, size=n)")
        params["dec_center"].set(value=DEC_C, min=DEC_C - span, max=DEC_C + span,
                                 initials=f"rng.normal(loc={DEC_C - 0.008}, "
                                          "scale=0.003, size=n)")

        fit = ModelFit(data, parameters=params, seed=4)
        sampler = fit(n_walkers=64, n_steps=600, prefix=None)
        best = fit.compute_bestfit_values(sampler.chain, n_burn=300)

        # recovered centre within ~10 arcsec of truth
        d_ra = abs(best.value("ra_center")[0] - RA_C) \
            * math.cos(math.radians(DEC_C)) * 3600
        d_dec = abs(best.value("dec_center")[0] - DEC_C) * 3600
        assert d_ra < 12.0, d_ra
        assert d_dec < 12.0, d_dec

    def _freecenter_fit(self, n=140, seed=2):
        data, _ = make_mock_cluster(n_stars=n, ra_center=RA_C,
                                    dec_center=DEC_C, sigma_max=8.0,
                                    v_max=3.0, theta_0=0.4, r_peak=50.0,
                                    a=40.0, seed=seed)
        params = ModelFit.default_parameters()
        params["r_peak"].set(min=5.0, max=300.0)
        params["a"].set(min=5.0, max=300.0)
        span = 0.02
        params["ra_center"].set(value=RA_C, min=RA_C - span, max=RA_C + span)
        params["dec_center"].set(value=DEC_C, min=DEC_C - span,
                                 max=DEC_C + span)
        return ModelFit(data, parameters=params, seed=5)

    def _walker_draws(self, W, rng):
        return np.column_stack([
            rng.normal(0, 1, W), np.exp(rng.normal(2.0, 0.2, W)),
            rng.uniform(20, 60, W), rng.normal(0, 3, W), rng.normal(0, 3, W),
            rng.uniform(30, 90, W),
            RA_C + 3e-3 * rng.normal(size=W),
            DEC_C + 3e-3 * rng.normal(size=W)])

    def test_identity_offsets_constant_fit(self):
        """ConstantFit free-centre lnprob rides the same exact trig-identity
        star constants; must equal the raw spherical-trig evaluation."""
        import jax.numpy as jnp

        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils.coordinates import xy_offset_rad

        data, _ = make_mock_cluster(n_stars=120, ra_center=RA_C,
                                    dec_center=DEC_C, sigma_max=8.0,
                                    v_max=3.0, theta_0=0.4, seed=6)
        params = ConstantFit.default_parameters()
        span = 0.02
        params["ra_center"].set(value=RA_C, min=RA_C - span, max=RA_C + span)
        params["dec_center"].set(value=DEC_C, min=DEC_C - span,
                                 max=DEC_C + span)
        fit = ConstantFit(data, parameters=params, seed=2)
        assert not fit.center_is_fixed()
        prepped = fit.prepare_data(dict(fit._data_arrays))
        assert "fc_dx0" in prepped

        rng = np.random.default_rng(4)
        theta = jnp.asarray([0.5, 7.5, 2.0, -1.0,
                             RA_C + 2e-3, DEC_C - 2e-3], fit.dtype)
        got = float(fit.lnprob(theta))
        # independent numpy: raw trig projection
        p = fit.scaled_values(theta)
        ra = np.asarray(fit._data_arrays["ra"])
        dec = np.asarray(fit._data_arrays["dec"])
        dx, dy = xy_offset_rad(ra, dec, float(p["ra_center"]),
                               float(p["dec_center"]), xp=np)
        r = np.hypot(dx, dy)
        v_los = 0.5 + (dy * 2.0 - dx * (-1.0)) / np.where(r > 0, r, 1.0)
        v = np.asarray(fit._data_arrays["v"])
        verr = np.asarray(fit._data_arrays["verr"])
        norm = verr ** 2 + 7.5 ** 2
        expected = float(np.sum(-0.5 * np.log(2 * np.pi * norm)
                                - 0.5 * (v - v_los) ** 2 / norm))
        assert math.isclose(got, expected, rel_tol=1e-11)

    def test_identity_offsets_jam(self):
        """Axisymmetric's free-centre rotated coordinates through the identity
        constants must equal the raw trig branch to float64 precision."""
        import jax.numpy as jnp

        from mcmc_dynamics_jax.models import Axisymmetric
        from test_axisymmetric import _base_params, _mock_jam_data

        data, lum, mass = _mock_jam_data(n=80, seed=1)
        params = _base_params()
        span = 0.02
        params["ra_center"].set(value=RA_C, fixed=False,
                                min=RA_C - span, max=RA_C + span)
        params["dec_center"].set(value=DEC_C, fixed=False,
                                 min=DEC_C - span, max=DEC_C + span)
        fit = Axisymmetric(data, parameters=params, mge_mass=mass,
                           mge_lum=lum, seed=3)
        assert not fit.center_is_fixed()
        prepped = fit.prepare_data(dict(fit._data_arrays))
        assert "fc_dx0" in prepped and "dxr" not in prepped

        p = {"ra_center": jnp.asarray(math.radians(RA_C + 1.5e-3)),
             "dec_center": jnp.asarray(math.radians(DEC_C - 1.5e-3)),
             "kappa_x": jnp.asarray(0.5), "kappa_y": jnp.asarray(0.1)}
        x_id, y_id = fit._rotated_coords_arcsec(p, prepped)
        raw = {k: v for k, v in prepped.items()
               if not k.startswith("fc_")}
        x_tr, y_tr = fit._rotated_coords_arcsec(p, raw)
        np.testing.assert_allclose(np.asarray(x_id), np.asarray(x_tr),
                                   rtol=1e-11, atol=1e-9)
        np.testing.assert_allclose(np.asarray(y_id), np.asarray(y_tr),
                                   rtol=1e-11, atol=1e-9)

    def test_freecenter_star_sharded_lnprob(self):
        """A free-centre fit star-shards exactly like a fixed-centre one (the
        generic per-star path; the fc_* data columns slice over sp)."""
        import jax
        import jax.numpy as jnp

        from mcmc_dynamics_jax.parallel import make_mesh, star_sharded_lnprob

        fit = self._freecenter_fit(n=141)       # 141 % 4 != 0 -> sp padding
        mesh = make_mesh(("dp", "sp"), (2, 4))
        sharded = star_sharded_lnprob(fit, mesh, sp_axis="sp")
        rng = np.random.default_rng(21)
        theta = jnp.asarray(self._walker_draws(1, rng)[0], fit.dtype)
        assert math.isclose(float(sharded(theta)), float(fit.lnprob(theta)),
                            rel_tol=1e-10)
