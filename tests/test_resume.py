"""Checkpoint/resume and telemetry: bitwise continuation through the Runner API."""

import numpy as np

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ConstantFit
from mcmc_dynamics_jax.profiling import SamplerTelemetry, benchmark_lnprob
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def _fit(seed=0):
    rng = np.random.default_rng(seed)
    n = 120
    data = DataReader({
        "ra": u.Quantity(RA_C + 0.02 * rng.normal(size=n), "deg"),
        "dec": u.Quantity(DEC_C + 0.02 * rng.normal(size=n), "deg"),
        "v": u.Quantity(5 * rng.normal(size=n), "km/s"),
        "verr": u.Quantity(np.full(n, 0.4), "km/s")})
    params = ConstantFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    return ConstantFit(data, parameters=params, seed=seed)


class TestExactResume:
    def test_bitwise_resume_through_runner(self, tmp_path):
        fit = _fit()
        prefix = str(tmp_path / "run")
        pos = fit.get_initials(16)

        full = fit(n_walkers=16, n_steps=80, seed=5, pos=pos, prefix=None)

        part1 = fit(n_walkers=16, n_steps=30, seed=5, pos=pos, n_out=30,
                    prefix=prefix)
        state = fit.load_state(prefix + "_chain")
        part2 = fit(n_steps=50, state=state, prefix=None)

        resumed = np.concatenate([part1.chain, part2.chain], axis=1)
        np.testing.assert_array_equal(full.chain, resumed)

    def test_legacy_pos_restart(self, tmp_path):
        """Reference-style restart (positions only, new RNG): runs and is valid."""
        fit = _fit(seed=1)
        prefix = str(tmp_path / "legacy")
        fit(n_walkers=16, n_steps=30, n_out=30, prefix=prefix)
        pos = fit.read_final_chain(prefix + "_chain.npz")
        result = fit(n_walkers=16, n_steps=20, pos=pos, prefix=None)
        assert np.isfinite(result.lnprobability).all()


class TestTelemetry:
    def test_counters(self):
        fit = _fit(seed=2)
        tel = SamplerTelemetry()
        fit(n_walkers=16, n_steps=40, n_out=20, prefix=None, telemetry=tel)
        assert tel.total_steps == 40
        assert tel.evals_per_sec > 0
        assert len(tel.records) == 2

    def test_benchmark_helper(self):
        fit = _fit(seed=3)
        stats = benchmark_lnprob(fit, n_walkers=16, n_steps=10, n_repeats=1)
        assert stats["evals_per_sec"] > 0
        assert stats["backend"] == "cpu"


class TestAlternativeSamplers:
    def test_sample_hmc_through_model_api(self):
        fit = _fit(seed=5)
        res = fit.sample_hmc(n_walkers=8, n_steps=150, n_warmup=100,
                             n_leapfrog=8, step_size=0.05)
        assert res.chain.shape == (8, 150, 4)
        assert np.isfinite(res.lnprobability).all()
        # sigma concentrates near the data scale (5 km/s draws + 0.4 errors)
        assert abs(np.median(res.chain[:, 75:, 1]) - 5.0) < 1.0

    def test_sample_tempered_through_model_api(self):
        fit = _fit(seed=6)
        res, lnz = fit.sample_tempered(n_walkers=16, n_steps=150, n_temps=4)
        assert res.chain.shape == (16, 150, 4)
        assert np.isfinite(lnz)
