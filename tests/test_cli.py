"""CLI driver smoke tests (fast paths only; the full pipelines are driven in the
verification harness)."""

import json
import math
import pathlib

import numpy as np
import pytest


class TestClusterElongation:
    def test_end_to_end(self, tmp_path, monkeypatch):
        from mcmc_dynamics_jax.cli.cluster_elongation import main

        rng = np.random.default_rng(0)
        n = 800
        # elongated distribution: axis ratio 0.6, PA 30 deg east of north
        a, b = 1.0, 0.6
        x0 = a * rng.normal(size=n)
        y0 = b * rng.normal(size=n)
        pa = math.radians(30.0)
        # rotate semi-major axis to position angle measured from +y axis
        x = x0 * math.cos(pa + math.pi / 2) - y0 * math.sin(pa + math.pi / 2)
        y = x0 * math.sin(pa + math.pi / 2) + y0 * math.cos(pa + math.pi / 2)

        catalog = tmp_path / "phot.csv"
        with open(catalog, "w") as f:
            f.write("x,y\n")
            for xi, yi in zip(x, y):
                f.write(f"{xi},{yi}\n")

        out = tmp_path / "elong.png"
        monkeypatch.chdir(tmp_path)
        assert main([str(catalog), "-o", str(out), "--radii", "0", "3"]) == 0
        assert out.exists() and out.stat().st_size > 5000

    def test_eccentricity_recovered(self):
        from mcmc_dynamics_jax.utils import get_eccentricity_and_pa

        rng = np.random.default_rng(1)
        n = 4000
        x = 1.0 * rng.normal(size=n)
        y = 0.6 * rng.normal(size=n)
        res = get_eccentricity_and_pa(x, y, radii=[0.0, 5.0])
        e = res.value("e")[0]
        expected_e = math.sqrt(1 - 0.6 ** 4)  # eigenvalues are variances
        assert abs(e - expected_e) < 0.05


class TestRunConfigLoading:
    def test_catalog_loader_subtracts_vsys(self, tmp_path):
        from mcmc_dynamics_jax.cli.run import load_catalog

        catalog = tmp_path / "cat.csv"
        with open(catalog, "w") as f:
            f.write("ra,dec,v,verr\n")
            f.write("201.0,-47.0,232.0,1.0\n201.1,-47.1,235.0,1.5\n")
        data = load_catalog({"file": str(catalog), "format": "csv", "v_sys": 232.7})
        np.testing.assert_allclose(data.data.value("v"), [-0.7, 2.3], rtol=1e-12)

    def test_background_builder(self, tmp_path):
        from mcmc_dynamics_jax.cli.run import build_background

        field = tmp_path / "field.csv"
        with open(field, "w") as f:
            f.write("v\n10.0\n20.0\n30.0\n")
        bg = build_background({"type": "single_stars", "file": str(field)})
        out = bg(np.array([15.0]), np.array([1.0]))
        assert np.isfinite(out).all()

        g = build_background({"type": "gaussian", "mean": 0.0, "sigma": 50.0})
        assert np.isfinite(g(np.array([10.0]), np.array([1.0]))).all()

    def test_move_spec_with_hyperparameters(self):
        """Config move entries may carry a hyperparameter mapping as the
        third JSON leg; it must reach the sampler's normalised spec."""
        from mcmc_dynamics_jax.cli.run import _normalize_move
        from mcmc_dynamics_jax.sampler.stretch import normalize_move

        cfg = [["de", 0.8, {"gamma0": 0.6}], ["snooker", 0.2]]
        norm = normalize_move(_normalize_move(cfg))
        assert norm == (("de", 0.8, (("gamma0", 0.6),)),
                        ("snooker", 0.2, ()))
        assert _normalize_move(None) == "stretch"
        assert _normalize_move("de") == "de"
        with pytest.raises(ValueError, match="hyperparameter"):
            normalize_move(_normalize_move([["de", 1.0, {"bogus": 1}]]))


class TestRunTestsCli:
    def test_mock_verification_harness(self, tmp_path, monkeypatch):
        """The end-to-end mock-recovery CLI (the reference's bin/run_tests.py
        as an assert-based harness) passes on a small configuration."""
        from mcmc_dynamics_jax.cli.run_tests import main

        monkeypatch.chdir(tmp_path)
        rc = main(["-n", "250", "--seed", "3", "-o", str(tmp_path),
                   "--n-walkers", "32", "--n-steps", "200"])
        assert rc == 0
        assert (tmp_path / "recovery.png").exists()
        assert (tmp_path / "model_profile.ecsv").exists()


class TestBackgroundFrame:
    def test_background_shares_the_science_velocity_frame(self, tmp_path):
        """data.v_sys shifts the science catalog; the field-star background
        must be shifted identically (reference bin/run.py:441-442) or the
        mixture evaluates member and background in different frames."""
        import numpy as np
        from mcmc_dynamics_jax.cli.run import build_background

        field = tmp_path / "field.csv"
        v_raw = 232.7 + 40.0 * np.random.default_rng(0).normal(size=50)
        field.write_text("v\n" + "\n".join(f"{v:.4f}" for v in v_raw))

        bg = build_background({"type": "single_stars", "file": str(field)},
                              v_sys=232.7)
        # the KDE must now be centred near 0, not near 232.7
        probe = np.linspace(-50, 50, 7)
        ln_near = np.asarray(bg(probe, np.full(7, 1.0)))
        ln_far = np.asarray(bg(probe + 232.7, np.full(7, 1.0)))
        assert ln_near.mean() > ln_far.mean()

        g = build_background({"type": "gaussian", "mean": 232.7, "sigma": 50.0},
                             v_sys=232.7)
        assert float(np.asarray(g(np.zeros(1), np.ones(1)))) > \
            float(np.asarray(g(np.full(1, 232.7), np.ones(1))))
        # per-block override wins
        g0 = build_background({"type": "gaussian", "mean": 0.0, "sigma": 50.0,
                               "v_sys": 0.0}, v_sys=232.7)
        assert float(np.asarray(g0(np.zeros(1), np.ones(1)))) > \
            float(np.asarray(g0(np.full(1, 100.0), np.ones(1))))

    def test_rename_preserves_units(self, tmp_path):
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.cli.run import load_catalog
        from mcmc_dynamics_jax.utils import Table

        t = Table({"ra": u.Quantity([10.0], "deg"),
                   "dec": u.Quantity([-5.0], "deg"),
                   "vel": u.Quantity([1000.0], "m/s"),
                   "verr": u.Quantity([0.5], "km/s")})
        f = tmp_path / "cat.ecsv"
        t.write(f)
        data = load_catalog({"file": str(f), "format": "ascii.ecsv",
                             "rename": {"vel": "v"}, "units": {}})
        # 1000 m/s must read back as 1 km/s, not 1000 km/s
        assert abs(float(data.data.value("v", "km/s")[0]) - 1.0) < 1e-9
