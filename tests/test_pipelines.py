"""Batched radial-bin pipeline: all per-bin ensembles in one jitted program."""

import math

import numpy as np

import jax

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.parallel import make_mesh
from mcmc_dynamics_jax.pipelines import fit_radial_bins
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def _mock_cluster(n=800, seed=7):
    """Rotating cluster with radius-dependent dispersion (as bin/run_tests.py)."""
    rng = np.random.default_rng(seed)
    truth = dict(sigma_max=8.0, v_max=4.0, theta_0=0.9, r_peak=60.0, a=40.0)
    r = np.abs(rng.normal(0, 80, n))
    phi = rng.uniform(-np.pi, np.pi, n)
    ra = RA_C - (r / 3600) * np.cos(phi) / math.cos(math.radians(DEC_C))
    dec = DEC_C + (r / 3600) * np.sin(phi)
    x_pa = r * np.sin(phi - truth["theta_0"])
    v_los = 2 * (truth["v_max"] / truth["r_peak"]) * x_pa / (1 + (r / truth["r_peak"]) ** 2)
    sig = truth["sigma_max"] / (1 + r ** 2 / truth["a"] ** 2) ** 0.25
    verr = 0.3 + 0.2 * rng.random(n)
    v = v_los + sig * rng.normal(size=n) + verr * rng.normal(size=n)
    data = DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                       "v": u.Quantity(v, "km/s"), "verr": u.Quantity(verr, "km/s")})
    return data, truth


class TestFitRadialBins:
    def test_batched_bins_recover_profile(self):
        data, truth = _mock_cluster()
        from mcmc_dynamics_jax.models import ConstantFit
        params = ConstantFit.default_parameters()
        params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.4, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")

        result = fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg,
                                 parameters=params, nstars=150, dlogr=0.05,
                                 n_walkers=48, n_steps=300, seed=1)
        assert result.n_bins >= 3
        assert result.chains.shape[:2] == (result.n_bins, 48)

        table = result.summary(n_burn=150)
        sig = table.value("sigma_max median")
        # dispersion declines outward (Plummer truth)
        assert sig[0] > sig[-1]
        assert abs(sig[0] - truth["sigma_max"]) < 2.5
        # all bins produced finite stats
        assert np.all(np.isfinite(table.value("v_max median")))
        # radii ordered
        r = table.value("r mean")
        assert np.all(np.diff(r) > 0)

    def test_bins_sharded_over_mesh(self):
        data, _ = _mock_cluster(n=400, seed=3)
        mesh = make_mesh(("dp",), (8,))
        res = fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg,
                              nstars=50, dlogr=0.01, n_walkers=16, n_steps=50,
                              seed=0, mesh=mesh)
        assert res.chains.shape[1] == 16
        assert np.all(np.isfinite(res.log_probs[:, :, -1]))


class TestModelFitBins:
    def test_model_fit_as_bin_model(self):
        """fit_radial_bins accepts any centre-fixed model class (here ModelFit):
        the packed bins carry both geometry representations."""
        from mcmc_dynamics_jax.models import ModelFit

        data, _ = _mock_cluster(n=500, seed=9)
        params = ModelFit.default_parameters()
        params["sigma_max"].set(initials="rng.lognormal(mean=2.0, sigma=0.3, size=n)")
        params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")
        params["r_peak"].set(min=5.0, max=400.0,
                             initials="rng.uniform(30, 120, size=n)")
        params["a"].set(min=5.0, max=400.0, initials="rng.uniform(20, 80, size=n)")

        res = fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg, parameters=params,
                              model_cls=ModelFit, nstars=200, dlogr=0.05,
                              n_walkers=32, n_steps=80, seed=2)
        assert res.n_bins >= 2
        assert np.isfinite(res.log_probs[:, :, -1]).all()

        # the recorded per-bin log-probs must equal the TRUE ModelFit lnprob of
        # that bin's data (regression guard: a tier-dispatch bug once routed
        # ModelFit thetas through the ConstantFit sufficient statistics)
        import math
        cmp_params = params.copy()
        cmp_params["ra_center"].set(value=RA_C, fixed=True)
        cmp_params["dec_center"].set(value=DEC_C, fixed=True)
        for b in range(res.n_bins):
            bin_data = data.fetch_radial_bin(b)
            bin_fit = ModelFit(bin_data, parameters=cmp_params.copy())
            theta = np.asarray(res.chains[b, 0, -1, :])
            want = float(bin_fit.lnprob(theta))
            got = float(res.log_probs[b, 0, -1])
            assert math.isclose(got, want, rel_tol=1e-8), (b, got, want)


class TestProgramCache:
    def test_identical_calls_hit_cache_and_match(self):
        """A second identical binned fit reuses the jitted program (no recompile)
        and reproduces the same chains bitwise."""
        from mcmc_dynamics_jax import pipelines

        data, _ = _mock_cluster(n=300, seed=9)
        pipelines._PROGRAM_CACHE.clear()
        kw = dict(nstars=80, dlogr=0.01, n_walkers=16, n_steps=40, seed=5)
        a = fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg, **kw)
        assert len(pipelines._PROGRAM_CACHE) == 1
        data2, _ = _mock_cluster(n=300, seed=9)
        b = fit_radial_bins(data2, RA_C * u.deg, DEC_C * u.deg, **kw)
        assert len(pipelines._PROGRAM_CACHE) == 1
        np.testing.assert_array_equal(np.asarray(a.chains), np.asarray(b.chains))

    def test_different_parameters_do_not_share_programs(self):
        from mcmc_dynamics_jax import pipelines
        from mcmc_dynamics_jax.models import ConstantFit

        data, _ = _mock_cluster(n=300, seed=9)
        pipelines._PROGRAM_CACHE.clear()
        kw = dict(nstars=80, dlogr=0.01, n_walkers=16, n_steps=40, seed=5)
        fit_radial_bins(data, RA_C * u.deg, DEC_C * u.deg, **kw)
        params = ConstantFit.default_parameters()
        params["sigma_max"].set(max=50.0)   # different prior -> different program
        data2, _ = _mock_cluster(n=300, seed=9)
        fit_radial_bins(data2, RA_C * u.deg, DEC_C * u.deg, parameters=params, **kw)
        assert len(pipelines._PROGRAM_CACHE) == 2


class TestDispersionOnlySummary:
    def test_summary_without_rotation_columns(self):
        """v_maxx/v_maxy fixed (dispersion-only binned fit) used to crash
        summary() with AttributeError; the rotation rows are now omitted."""
        import numpy as np
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.pipelines import fit_radial_bins
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(0)
        n = 400
        ra_c, dec_c = 56.345, -26.675
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s")})
        params = ConstantFit.default_parameters()
        params["v_maxx"].set(value=0.0, fixed=True)
        params["v_maxy"].set(value=0.0, fixed=True)
        res = fit_radial_bins(data, ra_c * u.deg, dec_c * u.deg,
                              parameters=params, nstars=100, dlogr=0.1,
                              n_walkers=16, n_steps=60, seed=1)
        table = res.summary(n_burn=30)
        assert "sigma_max median" in table.columns
        assert "v_max median" not in table.columns


class TestBucketedPacking:
    def test_size_buckets_partition(self):
        from mcmc_dynamics_jax.pipelines import _size_buckets

        # one giant outer bin: must split off so 15 small bins stop paying 4096
        counts = np.array([1024] * 15 + [16384])
        buckets = _size_buckets(counts)
        assert len(buckets) == 2
        padded = sum(len(b) * counts[b].max() for b in buckets)
        assert padded * 2 <= 16 * 16384  # >= 2x less padded work
        # even bins: a second compile is not worth it
        assert len(_size_buckets(np.array([3000, 3100, 3050, 2980]))) == 1
        # small workloads are latency-bound: never split below min_cells
        assert len(_size_buckets(counts // 16)) == 1
        # reassembly covers every bin exactly once
        got = np.sort(np.concatenate(buckets))
        np.testing.assert_array_equal(got, np.arange(16))

    def test_bucketed_results_match_monolithic(self, monkeypatch):
        """Bucketing is a pure packing change: per-bin chains are bitwise
        identical to the single-block layout (padded lanes are masked out of
        every likelihood sum)."""
        import mcmc_dynamics_jax.pipelines as pl

        # skewed catalog: inner bins ~120 stars, outer bin ~1200
        rng = np.random.default_rng(3)
        n_in, n_out = 600, 1200
        r_in = 0.02 + 0.1 * rng.random(n_in)
        r_out = 0.5 + 0.5 * rng.random(n_out)
        r = np.concatenate([r_in, r_out])
        phi = rng.uniform(-np.pi, np.pi, r.size)
        ra = RA_C + r * np.cos(phi) / np.cos(np.radians(DEC_C))
        dec = DEC_C + r * np.sin(phi)
        data = {
            "ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
            "v": u.Quantity(5 * rng.normal(size=r.size), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(r.size), "km/s"),
        }

        orig = pl._size_buckets

        def run(force_single):
            reader = DataReader({k: u.Quantity(np.array(v.value), v.unit)
                                 for k, v in data.items()})
            if force_single:
                monkeypatch.setattr(pl, "_size_buckets",
                                    lambda counts, **kw:
                                    [np.arange(len(counts))])
            else:
                # drop the latency-bound floor so this small test case buckets
                monkeypatch.setattr(pl, "_size_buckets",
                                    lambda counts, **kw:
                                    orig(counts, min_cells=0))
            return pl.fit_radial_bins(
                reader, RA_C * u.deg, DEC_C * u.deg, nstars=120, dlogr=0.01,
                n_walkers=16, n_steps=40, seed=5)

        mono = run(force_single=True)
        buck = run(force_single=False)
        assert buck.n_bins == mono.n_bins
        np.testing.assert_array_equal(buck.chains, mono.chains)
        np.testing.assert_array_equal(buck.log_probs, mono.log_probs)

    def test_bucketed_bins_on_mesh(self, monkeypatch):
        """Bucketing composes with a device mesh even when a bucket needs
        padding to the mesh extent (regression: the padded-slot PRNG keys were
        legacy uint32 arrays and could not be concatenated with the typed key
        arrays the multi-bucket path carries)."""
        import mcmc_dynamics_jax.pipelines as pl

        rng = np.random.default_rng(3)
        # inner stars spread over ~0.8 dex (-> ~120-star bins); outer stars in
        # a shell narrower than dlogr (-> one 1200-star bin): strong skew
        n_in, n_out = 600, 1200
        r = np.concatenate([0.02 + 0.1 * rng.random(n_in),
                            0.5 * (1.0 + 0.01 * rng.random(n_out))])
        phi = rng.uniform(-np.pi, np.pi, r.size)
        data = {
            "ra": u.Quantity(RA_C + r * np.cos(phi)
                             / np.cos(np.radians(DEC_C)), "deg"),
            "dec": u.Quantity(DEC_C + r * np.sin(phi), "deg"),
            "v": u.Quantity(5 * rng.normal(size=r.size), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(r.size), "km/s"),
        }

        orig = pl._size_buckets
        bucket_sizes = []

        def patched(counts, **kw):
            buckets = orig(counts, min_saving=0.0, min_cells=0)
            bucket_sizes.append([len(b) for b in buckets])
            return buckets

        monkeypatch.setattr(pl, "_size_buckets", patched)

        def run(mesh):
            reader = DataReader({k: u.Quantity(np.array(v.value), v.unit)
                                 for k, v in data.items()})
            return pl.fit_radial_bins(
                reader, RA_C * u.deg, DEC_C * u.deg, nstars=120, dlogr=0.01,
                n_walkers=16, n_steps=40, seed=5, mesh=mesh)

        plain = run(mesh=None)
        # the regression needs >1 bucket AND a bucket not divisible by the
        # mesh extent (so the typed-key padding branch runs)
        assert len(bucket_sizes[-1]) > 1
        assert any(sz % 8 for sz in bucket_sizes[-1])
        meshed = run(mesh=make_mesh(("dp",), (8,)))
        assert meshed.n_bins == plain.n_bins
        # sharding reassociates the per-bin reductions, so lnp can differ in
        # the last ulps; the sampled coordinates must still agree to fp noise
        np.testing.assert_allclose(meshed.chains, plain.chains,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(meshed.log_probs, plain.log_probs,
                                   rtol=1e-10)
