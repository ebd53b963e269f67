"""Tests for the table, data reader, coordinates and binning utilities."""

import io
import math

import numpy as np
import pytest

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.utils import (DataReader, RadialProfile, Table,
                                     calc_cartesian_pm, calc_xy_offset,
                                     get_amplitude_and_angle,
                                     get_perspective_rotation, radial_bin_numbers)


class TestTable:
    def test_build_and_index(self):
        t = Table({"v": u.Quantity([1.0, 2.0, 3.0], "km/s"), "w": [4, 5, 6]})
        assert t.colnames == ["v", "w"]
        assert len(t) == 3
        sel = t[t.columns["w"] > 4]
        assert len(sel) == 2
        np.testing.assert_allclose(sel.value("v"), [2.0, 3.0])

    def test_ecsv_roundtrip(self):
        t = Table({"r": u.Quantity([0.1, 1.0], "arcsec"),
                   "i": u.Quantity([100.0, 10.0], "solLum/pc2"),
                   "q": [0.9, 0.8]})
        buf = io.StringIO()
        t.write(buf)
        restored = Table.read(io.StringIO(buf.getvalue()))
        assert restored.colnames == ["r", "i", "q"]
        np.testing.assert_allclose(restored.value("r"), [0.1, 1.0])
        assert restored.units["r"] == u.arcsec

    def test_value_with_conversion(self):
        t = Table({"r": u.Quantity([60.0], "arcsec")})
        np.testing.assert_allclose(t.value("r", "arcmin"), [1.0])


class TestCoordinates:
    def test_xy_offset_small_angle(self):
        """Near the centre the projection reduces to plain offsets (x flipped)."""
        ra_c, dec_c = 56.0, -26.0
        ddeg = 0.01
        dx, dy = calc_xy_offset(ra_c + ddeg, dec_c, ra_c, dec_c)
        np.testing.assert_allclose(dx.to(u.deg).value,
                                   -ddeg * math.cos(math.radians(dec_c)), rtol=1e-4)
        dx2, dy2 = calc_xy_offset(ra_c, dec_c + ddeg, ra_c, dec_c)
        np.testing.assert_allclose(dy2.to(u.deg).value, ddeg, rtol=1e-4)
        assert abs(dx2.value) < 1e-10

    def test_xy_offset_formula(self):
        """Exact van de Ven+06 projection, checked against independent spherical
        trig (the reference formula, calc_xy_offset.py:30-31)."""
        ra, dec = np.array([57.1]), np.array([-25.3])
        ra_c, dec_c = 56.345, -26.675
        dx, dy = calc_xy_offset(ra, dec, ra_c, dec_c)
        r0 = 10800.0 / math.pi
        rr, dd, rc, dc = map(math.radians, (ra[0], dec[0], ra_c, dec_c))
        exp_dx = -r0 * math.cos(dd) * math.sin(rr - rc)
        exp_dy = r0 * (math.sin(dd) * math.cos(dc) - math.cos(dd) * math.sin(dc) * math.cos(rr - rc))
        np.testing.assert_allclose(dx.value, exp_dx, rtol=1e-12)
        np.testing.assert_allclose(dy.value, exp_dy, rtol=1e-12)

    def test_perspective_rotation(self):
        v = get_perspective_rotation(u.Quantity(10.0, "arcmin"), u.Quantity(0.0, "arcmin"),
                                     u.Quantity(5.0, "mas/yr"), u.Quantity(0.0, "mas/yr"),
                                     u.Quantity(5.0, "kpc"))
        np.testing.assert_allclose(v.value, 1.3790e-3 * 5.0 * 50.0, rtol=1e-12)

    def test_cartesian_pm_at_center(self):
        pmx, pmy = calc_cartesian_pm(u.Quantity(1.0, "mas/yr"), u.Quantity(2.0, "mas/yr"),
                                     10.0 * u.deg, 20.0 * u.deg, 10.0 * u.deg, 20.0 * u.deg)
        np.testing.assert_allclose(pmx.value, -1.0)
        np.testing.assert_allclose(pmy.value, 2.0)

    def test_amplitude_and_angle_wraparound(self):
        """theta near the ±pi boundary must not split into two lobes."""
        rng = np.random.default_rng(0)
        theta_true = math.pi - 0.05  # close to wrap
        v_true = 10.0
        vx = v_true * np.cos(theta_true) + 0.3 * rng.normal(size=4000)
        vy = v_true * np.sin(theta_true) + 0.3 * rng.normal(size=4000)
        res, _, _ = get_amplitude_and_angle({"v_maxx": vx, "v_maxy": vy})
        v_med = res.value("v_max")[0]
        th_med = res.value("theta_0")[0]
        assert abs(v_med - v_true) < 0.1
        assert abs(((th_med - theta_true) + np.pi) % (2 * np.pi) - np.pi) < 0.02
        # errors must be small (no wrap inflation)
        assert res.value("theta_0")[1] < 0.1


class TestBinning:
    def test_greedy_binning_counts_and_span(self):
        rng = np.random.default_rng(0)
        r = rng.lognormal(0.0, 1.0, size=500)
        bins = radial_bin_numbers(r, nstars=50, dlogr=0.2)
        assert bins.min() >= 0
        for b in range(bins.max() + 1):
            sel = r[bins == b]
            assert len(sel) >= 25  # tail rule allows smaller last bin
        # all but the last bin satisfy both criteria
        for b in range(bins.max()):
            sel = np.sort(r[bins == b])
            assert len(sel) >= 50

    def test_bins_are_radial_contiguous(self):
        r = np.linspace(0.1, 10.0, 200)
        bins = radial_bin_numbers(r, nstars=20, dlogr=0.01)
        assert np.all(np.diff(bins) >= 0)  # sorted input -> monotone bins

    def test_radial_profile_class(self):
        r = np.logspace(-1, 1, 300)
        rp = RadialProfile(r)
        bins = rp(nstars=30, dlogr=0.1)
        assert bins.shape == (300,)


class TestDataReader:
    def _reader(self, n=200, seed=0):
        rng = np.random.default_rng(seed)
        ra = 56.0 + 0.05 * rng.normal(size=n)
        dec = -26.0 + 0.05 * rng.normal(size=n)
        return DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                           "v": u.Quantity(rng.normal(size=n), "km/s"),
                           "verr": u.Quantity(0.1 + 0 * ra, "km/s")})

    def test_distances_and_polar(self):
        d = self._reader()
        r = d.compute_distances(56.0 * u.deg, -26.0 * u.deg)
        assert r.unit == u.arcmin
        assert np.all(r.value >= 0)
        r2, theta = d.compute_polar(56.0 * u.deg, -26.0 * u.deg)
        np.testing.assert_allclose(r2.value, r.value)
        assert np.all(np.abs(theta.value) <= np.pi)

    def test_bins_and_fetch(self):
        d = self._reader(500)
        d.make_radial_bins(56.0 * u.deg, -26.0 * u.deg, nstars=50, dlogr=0.05)
        assert d.n_bins >= 2
        sub = d.fetch_radial_bin(0)
        assert sub.sample_size >= 25
        assert "v" in sub.data

    def test_padded_bins_mask(self):
        d = self._reader(300)
        d.make_radial_bins(56.0 * u.deg, -26.0 * u.deg, nstars=40, dlogr=0.05)
        arrays, mask = d.padded_bins(["v", "verr"])
        assert arrays["v"].shape == mask.shape
        counts = mask.sum(axis=1).astype(int)
        for b in range(d.n_bins):
            assert counts[b] == d.fetch_radial_bin(b).sample_size

    def test_apply_offset(self):
        d = self._reader(50)
        shifted = d.apply_offset(u.Quantity(36.0, "arcsec"), u.Quantity(0.0, "arcsec"))
        dx, _ = calc_xy_offset(shifted.data["ra"], shifted.data["dec"],
                               56.0 * u.deg, -26.0 * u.deg)
        dx0, _ = calc_xy_offset(d.data["ra"], d.data["dec"], 56.0 * u.deg, -26.0 * u.deg)
        np.testing.assert_allclose(dx.value - dx0.value, 0.6, atol=1e-3)


class TestPlots:
    def test_chain_and_corner_smoke(self, tmp_path):
        from mcmc_dynamics_jax.utils.plots import corner_plot, plot_chain

        rng = np.random.default_rng(0)
        chain = rng.normal(size=(8, 60, 3)).cumsum(axis=1) * 0.05 \
            + rng.normal(size=(8, 1, 3))
        lnp = -0.5 * (chain ** 2).sum(axis=2)
        f1 = tmp_path / "chains.png"
        plot_chain(chain, labels=["a", "b", "c"], filename=str(f1), lnprob=lnp,
                   plot_median=True)
        assert f1.stat().st_size > 5000

        f2 = tmp_path / "corner.png"
        corner_plot(chain.reshape(-1, 3), labels=["a", "b", "c"],
                    filename=str(f2), truths=[0.0, 0.0, 0.0])
        assert f2.stat().st_size > 5000

    def test_profile_plot_smoke(self, tmp_path):
        from mcmc_dynamics_jax.utils.plots import ProfilePlot

        r = np.logspace(0, 2, 20)
        pp = ProfilePlot()
        pp.add_rotation_profile(r, 4 * r / (1 + (r / 30) ** 2) / 30,
                                yerr=[np.full(20, 0.3), np.full(20, 0.3)],
                                fill_between=True, c="g", marker="None")
        pp.add_dispersion_profile(r, 8 / (1 + r ** 2 / 900) ** 0.25)
        pp.add_theta_profile(r, np.full(20, 0.5), yerr=np.full(20, 0.1))
        pp.add_scale_radius(30.0)
        out = tmp_path / "profile.png"
        pp.savefig(str(out))
        assert out.stat().st_size > 5000

    def test_kde_contours_and_significance(self):
        from scipy import stats
        from mcmc_dynamics_jax.utils.plots import (get_kde_contours,
                                                   get_mapping_significance)

        rng = np.random.default_rng(0)
        x, y = rng.normal(size=(2, 2000))
        X, Y, Z, levels = get_kde_contours(x, y, n_mc=4000)
        assert Z.shape == X.shape and len(levels) >= 2

        kernel = stats.gaussian_kde(np.vstack([x, y]))
        iso = get_mapping_significance(kernel, [0.5, 0.9], n_mc=4000)
        assert iso[0] > iso[1]  # tighter mass -> higher iso-density


class TestAmplitudeFillIn:
    def test_missing_component_reconstruction_formulas(self):
        """tan(theta_0) = v_maxy/v_maxx, so v_maxx = v_maxy / tan (the
        reference has the two fill-ins inverted; corrected here)."""
        import numpy as np
        from mcmc_dynamics_jax.utils import get_amplitude_and_angle

        rng = np.random.default_rng(0)
        vx = 3.0 + 0.01 * rng.normal(size=4000)
        vy = 1.5 + 0.01 * rng.normal(size=4000)
        full, _, _ = get_amplitude_and_angle({"v_maxx": vx, "v_maxy": vy})
        theta = np.arctan2(vy, vx)
        from_y, _, _ = get_amplitude_and_angle({"theta_0": theta, "v_maxy": vy})
        from_x, _, _ = get_amplitude_and_angle({"theta_0": theta, "v_maxx": vx})
        for res in (from_y, from_x):
            assert abs(res.value("v_max")[0] - full.value("v_max")[0]) < 0.01


class TestUnitsTableRegressions:
    """Review-pass fixes in the units/table foundation."""

    def test_spaced_column_names_round_trip(self):
        """BinnedFitResult.summary's 'r mean'-style columns used to corrupt
        the whitespace-split ECSV round-trip."""
        import io
        import numpy as np
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.utils import Table

        t = Table({"r mean": np.array([1.0, 2.0]),
                   "v_max median": np.array([3.0, 4.0])})
        t.units["r mean"] = u.arcmin
        buf = io.StringIO(); t.write(buf)
        t2 = Table.read(io.StringIO(buf.getvalue()))
        assert t2.colnames == ["r mean", "v_max median"]
        np.testing.assert_array_equal(t2.value("v_max median"), [3.0, 4.0])
        assert t2.units["r mean"] == u.arcmin

    def test_ecsv_delimiter_directive_and_overwrite(self, tmp_path):
        import io
        import numpy as np
        import pytest
        from mcmc_dynamics_jax.utils import Table

        text = ("# %ECSV 1.0\n# ---\n# datatype:\n"
                "# - {name: a, datatype: float64}\n"
                "# - {name: b, datatype: float64}\n"
                "# delimiter: ','\n# schema: astropy-2.0\na,b\n1.5,2.5\n")
        t = Table.read(io.StringIO(text))
        np.testing.assert_array_equal(t.value("b"), [2.5])
        p = tmp_path / "x.ecsv"
        t.write(p)
        with pytest.raises(FileExistsError):
            t.write(p, overwrite=False)

    def test_scaled_dimensionless_and_dex_units(self):
        import numpy as np
        import pytest
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.utils import Table

        q = u.Quantity(1.0, u.arcmin) / u.Quantity(1.0, u.deg)
        assert abs(float(np.asarray(q)) - 1.0 / 60.0) < 1e-12

        t = Table({"lg": u.Quantity(np.array([0.3]), u.dex("arcmin"))})
        col = t["lg"]
        assert isinstance(col.unit, u.DexUnit)
        with pytest.raises(u.UnitConversionError):
            t.value("lg", "arcmin")   # log10 values must not convert linearly

    def test_unit_algebra_and_parse_edge_cases(self):
        from mcmc_dynamics_jax import units as u

        a = u.deg * u.Quantity(2.0, u.arcmin)       # used to CONVERT
        b = u.Quantity(2.0, u.arcmin) * u.deg
        assert a.unit.dims == b.unit.dims and float(a.value) == 2.0
        c = u.km * u.Quantity(2.0, u.s)             # used to raise
        assert c.unit.dims == (u.km * u.s).dims
        assert u.parse_unit("1").is_unity()
        assert u.parse_unit("pc**2").dims == (u.pc ** 2).dims
        u1 = u.Unit(1.0, (1, 0, 0, 0, 0))
        u2 = u.Unit(1.0 + 1e-14, (1, 0, 0, 0, 0))
        assert u1 == u2 and hash(u1) == hash(u2)
