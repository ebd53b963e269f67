"""JAM moment engine validation.

The strongest check is fully independent physics: for a spherical isotropic model the
axisymmetric machinery must reproduce the classical spherical Jeans + Abel projection
solution, computed here from scratch with scipy quadrature.  Further tests cover
symmetry, rotation behaviour, validity flags, and black-hole response.
"""

import math

import numpy as np
import pytest
from scipy import integrate

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax.models.jam.moments import (G_PC, PC_PER_ARCSEC_PER_KPC,
                                                  jam_los_moments)


def _spherical_los_dispersion(radii_pc, nu0, s_lum, rho0, s_mass):
    """Independent spherical isotropic Jeans solution for Gaussian nu and rho.

    nu(r) = nu0 exp(-r^2/(2 s_lum^2)), rho(r) = rho0 exp(-r^2/(2 s_mass^2)).
    M(<r) = 4 pi rho0 s_mass^3 [ sqrt(pi/2) erf(t/sqrt 2) - t exp(-t^2/2) ], t=r/s_mass
    nu sigma_r^2 (r) = int_r^inf nu(s) G M(<s)/s^2 ds
    Sigma sigma_los^2 (R) = 2 int_R^inf nu sigma_r^2 r / sqrt(r^2-R^2) dr
    Sigma(R) = nu0 s_lum sqrt(2 pi) exp(-R^2/(2 s_lum^2))
    """
    def mass(r):
        t = r / s_mass
        return 4 * np.pi * rho0 * s_mass ** 3 * (
            math.sqrt(math.pi / 2) * math.erf(t / math.sqrt(2))
            - t * math.exp(-t ** 2 / 2))

    def nu(r):
        return nu0 * np.exp(-r ** 2 / (2 * s_lum ** 2))

    def nu_sigr2(r):
        val, _ = integrate.quad(lambda s: nu(s) * G_PC * mass(s) / s ** 2,
                                r, np.inf, limit=200)
        return val

    out = []
    for R in radii_pc:
        val, _ = integrate.quad(
            lambda r: 2 * nu_sigr2(r) * r / np.sqrt(r ** 2 - R ** 2),
            R, np.inf, limit=200)
        sigma_R = nu0 * s_lum * math.sqrt(2 * math.pi) * math.exp(
            -R ** 2 / (2 * s_lum ** 2))
        out.append(val / sigma_R)
    return np.array(out)


class TestSphericalLimit:
    def test_matches_independent_spherical_jeans(self):
        """q=1, beta=0, kappa=0: LOS second moment == spherical Jeans solution."""
        d = 5.0                        # kpc
        pc = d * PC_PER_ARCSEC_PER_KPC
        s_lum_arc, s_mass_arc = 30.0, 45.0
        i_lum, i_mass = 1000.0, 50.0   # surface densities

        x = np.array([5.0, 15.0, 30.0, 60.0, 100.0])  # arcsec, along x
        y = np.zeros_like(x)

        res = jam_los_moments(x, y, [i_lum], [s_lum_arc], [1.0],
                              [i_mass], [s_mass_arc], [1.0],
                              d=d, beta=0.0, kappa=0.0, mscale=1.0,
                              incl=math.radians(60.0), mbh=0.0, rbh=1.0,
                              n_u=32, n_zeta=64)
        assert bool(res.valid)
        got = np.sqrt(np.asarray(res.v2zz))

        # independent spherical solution (physical units)
        s_lum, s_mass = s_lum_arc * pc, s_mass_arc * pc
        nu0 = i_lum / (s_lum * math.sqrt(2 * math.pi))
        rho0 = i_mass / (s_mass * math.sqrt(2 * math.pi))
        expected = np.sqrt(_spherical_los_dispersion(x * pc, nu0, s_lum, rho0, s_mass))

        np.testing.assert_allclose(got, expected, rtol=2e-3)

    def test_inclination_invariance_for_sphere(self):
        kwargs = dict(d=5.0, beta=0.0, kappa=0.0, mscale=1.0, mbh=0.0, rbh=1.0)
        x = np.array([10.0, 40.0])
        y = np.array([20.0, -10.0])
        r1 = jam_los_moments(x, y, [100.0], [30.0], [1.0], [10.0], [30.0], [1.0],
                             incl=math.radians(30.0), **kwargs)
        r2 = jam_los_moments(x, y, [100.0], [30.0], [1.0], [10.0], [30.0], [1.0],
                             incl=math.radians(85.0), **kwargs)
        np.testing.assert_allclose(np.asarray(r1.v2zz), np.asarray(r2.v2zz),
                                   rtol=1e-3)


class TestRotationAndSymmetry:
    # realistic globular-cluster scale: ~1e4 Msun/pc^2 central surface density
    _mge = dict(lum_i=[5000.0, 1000.0], lum_s=[10.0, 40.0], lum_q=[0.9, 0.85],
                mass_i=[12500.0, 2500.0], mass_s=[10.0, 40.0], mass_q=[0.9, 0.85])

    def test_kappa_zero_no_rotation(self):
        res = jam_los_moments(np.array([10.0, -10.0]), np.array([0.0, 5.0]),
                              **self._mge, d=5.0, beta=0.1, kappa=0.0, mscale=2.0,
                              incl=math.radians(70.0))
        np.testing.assert_allclose(np.asarray(res.vz), 0.0, atol=1e-10)

    def test_rotation_odd_in_x(self):
        x = np.array([20.0, -20.0])
        y = np.array([5.0, 5.0])
        res = jam_los_moments(x, y, **self._mge, d=5.0, beta=0.0, kappa=0.6,
                              mscale=2.0, incl=math.radians(70.0))
        vz = np.asarray(res.vz)
        assert vz[0] > 0.1  # positive kappa rotates positive-x side toward us
        np.testing.assert_allclose(vz[0], -vz[1], rtol=1e-6)

    def test_second_moment_even_in_x(self):
        x = np.array([20.0, -20.0])
        y = np.array([5.0, 5.0])
        res = jam_los_moments(x, y, **self._mge, d=5.0, beta=0.2, kappa=0.6,
                              mscale=2.0, incl=math.radians(70.0))
        v2 = np.asarray(res.v2zz)
        np.testing.assert_allclose(v2[0], v2[1], rtol=1e-6)

    def test_rotation_bounded_by_second_moment(self):
        res = jam_los_moments(np.array([15.0]), np.array([0.0]), **self._mge,
                              d=5.0, beta=0.0, kappa=1.0, mscale=2.0,
                              incl=math.radians(80.0))
        assert float(res.v2zz[0]) > float(res.vz[0]) ** 2

    def test_kappa_scales_rotation_linearly_when_small(self):
        out = []
        for k in (0.2, 0.4):
            res = jam_los_moments(np.array([25.0]), np.array([0.0]), **self._mge,
                                  d=5.0, beta=0.0, kappa=k, mscale=2.0,
                                  incl=math.radians(70.0))
            out.append(float(res.vz[0]))
        np.testing.assert_allclose(out[1] / out[0], 2.0, rtol=1e-6)


class TestPhysicsResponses:
    _mge = dict(lum_i=[5000.0], lum_s=[20.0], lum_q=[0.95],
                mass_i=[10000.0], mass_s=[20.0], mass_q=[0.95])

    def test_mass_scale_raises_dispersion(self):
        r1 = jam_los_moments(np.array([10.0]), np.array([0.0]), **self._mge,
                             d=5.0, beta=0.0, kappa=0.0, mscale=1.0,
                             incl=math.radians(60.0))
        r2 = jam_los_moments(np.array([10.0]), np.array([0.0]), **self._mge,
                             d=5.0, beta=0.0, kappa=0.0, mscale=4.0,
                             incl=math.radians(60.0))
        # sigma^2 scales linearly with mass
        np.testing.assert_allclose(float(r2.v2zz[0]) / float(r1.v2zz[0]), 4.0,
                                   rtol=1e-3)

    def test_black_hole_raises_central_dispersion(self):
        base = jam_los_moments(np.array([2.0, 80.0]), np.array([0.0, 0.0]),
                               **self._mge, d=5.0, beta=0.0, kappa=0.0, mscale=1.0,
                               incl=math.radians(60.0), mbh=0.0)
        with_bh = jam_los_moments(np.array([2.0, 80.0]), np.array([0.0, 0.0]),
                                  **self._mge, d=5.0, beta=0.0, kappa=0.0,
                                  mscale=1.0, incl=math.radians(60.0),
                                  mbh=5e5, rbh=0.5)
        boost_center = float(with_bh.v2zz[0]) / float(base.v2zz[0])
        boost_outer = float(with_bh.v2zz[1]) / float(base.v2zz[1])
        assert boost_center > 1.5
        assert boost_outer < boost_center  # BH dominates only centrally

    def test_deprojection_validity_flag(self):
        res = jam_los_moments(np.array([10.0]), np.array([0.0]),
                              lum_i=[100.0], lum_s=[20.0], lum_q=[0.6],
                              mass_i=[10.0], mass_s=[20.0], mass_q=[0.6],
                              d=5.0, beta=0.0, kappa=0.0, mscale=1.0,
                              incl=math.radians(20.0))  # cos i > q' -> invalid
        assert not bool(res.valid)

    def test_anisotropy_changes_moments(self):
        r0 = jam_los_moments(np.array([30.0]), np.array([0.0]), **self._mge,
                             d=5.0, beta=0.0, kappa=0.0, mscale=1.0,
                             incl=math.radians(60.0))
        r1 = jam_los_moments(np.array([30.0]), np.array([0.0]), **self._mge,
                             d=5.0, beta=0.5, kappa=0.0, mscale=1.0,
                             incl=math.radians(60.0))
        assert abs(float(r0.v2zz[0]) - float(r1.v2zz[0])) > 1e-3

    def test_jit_and_grad_compatible(self):
        def loss(mscale):
            res = jam_los_moments(jnp.asarray([10.0]), jnp.asarray([0.0]),
                                  **{k: jnp.asarray(v) for k, v in self._mge.items()},
                                  d=5.0, beta=0.0, kappa=0.0, mscale=mscale,
                                  incl=math.radians(60.0), n_u=12, n_zeta=16)
            return res.v2zz[0]

        g = jax.grad(loss)(2.0)
        assert np.isfinite(float(g)) and float(g) > 0


class TestQuadratureConvergence:
    def test_flattened_rotating_model_converged(self):
        """Default quadrature orders vs a much finer grid on a flattened, inclined,
        rotating model (the spherical test only validates q=1)."""
        mge = dict(lum_i=[8000.0, 1500.0], lum_s=[8.0, 35.0], lum_q=[0.75, 0.7],
                   mass_i=[16000.0, 3000.0], mass_s=[8.0, 35.0], mass_q=[0.75, 0.7])
        x = np.array([3.0, 12.0, 30.0, 70.0, 3.0, 12.0])
        y = np.array([0.0, 4.0, -10.0, 20.0, 8.0, -12.0])
        kwargs = dict(d=5.0, beta=0.3, kappa=0.8, mscale=2.0,
                      incl=math.radians(75.0), mbh=1e4, rbh=0.5)
        coarse = jam_los_moments(x, y, **mge, **kwargs, n_u=24, n_zeta=40)
        fine = jam_los_moments(x, y, **mge, **kwargs, n_u=64, n_zeta=128)
        # second moment: smooth integrand, converges fast
        np.testing.assert_allclose(np.asarray(coarse.v2zz), np.asarray(fine.v2zz),
                                   rtol=1e-5)
        # first moment: the kappa prescription's sqrt-clip is only C^0, limiting
        # LOS-quadrature convergence; errors stay below 5e-3 km/s absolutely
        np.testing.assert_allclose(np.asarray(coarse.vz), np.asarray(fine.vz),
                                   rtol=3e-2, atol=5e-3)

    def test_default_orders_converged_with_and_without_bh(self):
        """The CLASS DEFAULTS (n_u=24, n_zeta=32) are converged to the levels
        the round-3 certification rests on: sigma_los relative error <= 1e-4
        without a BH and <= 1e-3 with one (the BH-aware geometric-mean LOS
        scale in moments.py; the old clip rule left ~1e-2 at small radii)."""
        mge = dict(lum_i=[5000.0, 1000.0], lum_s=[10.0, 40.0],
                   lum_q=[0.9, 0.85], mass_i=[12500.0, 2500.0],
                   mass_s=[10.0, 40.0], mass_q=[0.85, 0.9])
        r = np.geomspace(0.3, 300.0, 16)
        x = np.concatenate([r * math.cos(0.3), r * math.cos(1.2)])
        y = np.concatenate([r * math.sin(0.3), r * math.sin(1.2)])

        for mbh, tol in ((0.0, 1e-4), (1e5, 1e-3)):
            kwargs = dict(d=5.0, beta=0.1, kappa=0.5, mscale=2.0,
                          incl=math.radians(70.0), mbh=mbh, rbh=1.0)
            got = jam_los_moments(x, y, **mge, **kwargs)   # class defaults
            ref = jam_los_moments(x, y, **mge, **kwargs, n_u=48, n_zeta=192)
            sig = np.sqrt(np.asarray(got.v2zz) - np.asarray(got.vz) ** 2)
            sig_ref = np.sqrt(np.asarray(ref.v2zz) - np.asarray(ref.vz) ** 2)
            np.testing.assert_allclose(sig, sig_ref, rtol=tol)


class TestBlackHoleSpherical:
    def test_bh_dominated_sphere_matches_independent_solution(self):
        """Pure point-mass potential + spherical isotropic Gaussian tracer: the
        engine must match the independent spherical Jeans solution."""
        d = 5.0
        pc = d * PC_PER_ARCSEC_PER_KPC
        s_arc = 20.0
        mbh = 1.0e5

        x = np.array([2.0, 5.0, 15.0, 40.0])
        y = np.zeros_like(x)
        res = jam_los_moments(x, y, [1000.0], [s_arc], [1.0],
                              [1e-12], [s_arc], [1.0],  # negligible MGE mass
                              d=d, beta=0.0, kappa=0.0, mscale=1.0,
                              incl=math.radians(60.0), mbh=mbh, rbh=1e-4,
                              n_u=16, n_zeta=96)
        got = np.sqrt(np.asarray(res.v2zz))

        # independent: nu sigma_r^2 = G M int_r^inf nu/s^2 ds, Abel-projected
        s_pc = s_arc * pc
        nu0 = 1.0

        def nu(r):
            return nu0 * np.exp(-r ** 2 / (2 * s_pc ** 2))

        def nu_sigr2(r):
            val, _ = integrate.quad(lambda s: nu(s) * G_PC * mbh / s ** 2,
                                    r, np.inf, limit=200)
            return val

        expected = []
        for R in x * pc:
            val, _ = integrate.quad(
                lambda r: 2 * nu_sigr2(r) * r / np.sqrt(r ** 2 - R ** 2),
                R, np.inf, limit=200)
            surf = nu0 * s_pc * math.sqrt(2 * math.pi) * math.exp(
                -R ** 2 / (2 * s_pc ** 2))
            expected.append(math.sqrt(val / surf))
        np.testing.assert_allclose(got, np.asarray(expected), rtol=3e-3)
