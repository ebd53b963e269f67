"""Cross-sampler posterior consistency: three independent sampling algorithms
(stretch ensemble, HMC, tempered cold chain) must agree on the same model posterior —
a strong mutual-correctness check none of them can pass with a biased implementation.
"""

import numpy as np

import jax

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ConstantFit
from mcmc_dynamics_jax.sampler import autocorr_time
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def _fit(seed=0, n=300):
    rng = np.random.default_rng(seed)
    r = np.abs(rng.normal(0, 60, n)) + 1.0
    phi = rng.uniform(-np.pi, np.pi, n)
    v = 3.0 * np.sin(phi - 0.8) + 7.0 * rng.normal(size=n)
    verr = 0.3 + 0.2 * rng.random(n)
    v = v + verr * rng.normal(size=n)
    ra = RA_C - (r / 3600) * np.cos(phi) / np.cos(np.radians(DEC_C))
    dec = DEC_C + (r / 3600) * np.sin(phi)
    data = DataReader({"ra": u.Quantity(ra, "deg"), "dec": u.Quantity(dec, "deg"),
                       "v": u.Quantity(v, "km/s"), "verr": u.Quantity(verr, "km/s")})
    params = ConstantFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    params["sigma_max"].set(initials="rng.lognormal(mean=1.9, sigma=0.2, size=n)")
    params["v_maxx"].set(initials="rng.normal(loc=0, scale=2, size=n)")
    params["v_maxy"].set(initials="rng.normal(loc=0, scale=2, size=n)")
    return ConstantFit(data, parameters=params, seed=seed)


class TestCrossSamplerConsistency:
    def test_three_samplers_same_posterior(self):
        fit = _fit()

        stretch = fit(n_walkers=64, n_steps=800, prefix=None, seed=1)
        s_flat = stretch.chain[:, 400:, :].reshape(-1, 4)

        hmc = fit.sample_hmc(n_walkers=32, n_steps=600, n_warmup=300,
                             n_leapfrog=10, step_size=0.05, seed=2)
        h_flat = hmc.chain[:, 200:, :].reshape(-1, 4)

        tempered, _ = fit.sample_tempered(n_walkers=64, n_steps=800, n_temps=4,
                                          seed=3)
        t_flat = tempered.chain[:, 400:, :].reshape(-1, 4)

        # Monte-Carlo error scale from the stretch run
        tau = np.maximum(autocorr_time(stretch.chain[:, 400:, :]), 1.0)
        n_eff = s_flat.shape[0] / tau
        mc_err = s_flat.std(axis=0) / np.sqrt(n_eff)

        for other, label in ((h_flat, "hmc"), (t_flat, "tempered")):
            d_mean = np.abs(s_flat.mean(axis=0) - other.mean(axis=0))
            assert np.all(d_mean < 6 * mc_err + 0.02), (label, d_mean, mc_err)
            ratio = other.std(axis=0) / s_flat.std(axis=0)
            assert np.all(np.abs(ratio - 1) < 0.2), (label, ratio)
