"""Sampler correctness: posterior recovery on analytic targets, resume, diagnostics."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcmc_dynamics_jax.sampler import (autocorr_time, effective_sample_size,
                                       gelman_rubin, init_state, run_ensemble,
                                       stretch_step)


def _gaussian_lnprob(mean, cov_inv):
    mean = jnp.asarray(mean)
    cov_inv = jnp.asarray(cov_inv)

    def lnprob(theta):
        d = theta - mean
        return -0.5 * d @ cov_inv @ d

    return lnprob


class TestStretchSampler:
    def test_recovers_gaussian_moments(self):
        mean = np.array([1.0, -2.0])
        cov = np.array([[2.0, 0.8], [0.8, 1.0]])
        lnprob = _gaussian_lnprob(mean, np.linalg.inv(cov))

        key = jax.random.PRNGKey(0)
        coords = mean + np.random.default_rng(1).normal(size=(64, 2))
        state = init_state(lnprob, jnp.asarray(coords), key)
        result = run_ensemble(lnprob, state, n_steps=2000)

        samples = np.asarray(result.chain[:, 500:, :]).reshape(-1, 2)
        np.testing.assert_allclose(samples.mean(axis=0), mean, atol=0.1)
        np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.25)

    def test_acceptance_fraction_reasonable(self):
        lnprob = _gaussian_lnprob([0.0], [[1.0]])
        state = init_state(lnprob, jnp.asarray(np.random.default_rng(0).normal(size=(32, 1))),
                           jax.random.PRNGKey(1))
        result = run_ensemble(lnprob, state, n_steps=500)
        acc = np.asarray(result.acceptance_fraction)
        assert np.all(acc > 0.2) and np.all(acc < 0.9)

    def test_bitwise_resume(self):
        """Checkpoint/restart must reproduce the uninterrupted run exactly (the
        reference cannot: it restarts positions without the emcee RNG state)."""
        lnprob = _gaussian_lnprob([0.0, 0.0], np.eye(2))
        coords = jnp.asarray(np.random.default_rng(3).normal(size=(16, 2)))
        state = init_state(lnprob, coords, jax.random.PRNGKey(7))

        full = run_ensemble(lnprob, state, n_steps=100)

        part1 = run_ensemble(lnprob, state, n_steps=40)
        part2 = run_ensemble(lnprob, part1.final, n_steps=60)
        resumed = np.concatenate([np.asarray(part1.chain), np.asarray(part2.chain)],
                                 axis=1)
        np.testing.assert_array_equal(np.asarray(full.chain), resumed)

    def test_minus_inf_regions_never_entered(self):
        def lnprob(theta):
            x = theta[0]
            return jnp.where(x > 0, -0.5 * (x - 1.0) ** 2, -jnp.inf)

        coords = jnp.asarray(np.abs(np.random.default_rng(0).normal(size=(32, 1))) + 0.1)
        state = init_state(lnprob, coords, jax.random.PRNGKey(2))
        result = run_ensemble(lnprob, state, n_steps=300)
        assert np.all(np.asarray(result.chain)[..., 0] > 0)
        assert np.all(np.isfinite(np.asarray(result.log_prob)))

    def test_nan_lnprob_rejected(self):
        def lnprob(theta):
            x = theta[0]
            return jnp.where(x > 0, -0.5 * x ** 2, jnp.nan)

        coords = jnp.asarray(np.abs(np.random.default_rng(0).normal(size=(16, 1))) + 0.1)
        state = init_state(lnprob, coords, jax.random.PRNGKey(2))
        result = run_ensemble(lnprob, state, n_steps=200)
        assert np.all(np.isfinite(np.asarray(result.log_prob)))

    def test_thinning(self):
        lnprob = _gaussian_lnprob([0.0], [[1.0]])
        coords = jnp.asarray(np.random.default_rng(0).normal(size=(16, 1)))
        state = init_state(lnprob, coords, jax.random.PRNGKey(4))
        result = run_ensemble(lnprob, state, n_steps=100, thin=10)
        assert result.chain.shape == (16, 10, 1)
        assert int(result.final.step) == 100

    def test_odd_walkers_rejected(self):
        lnprob = _gaussian_lnprob([0.0], [[1.0]])
        coords = jnp.asarray(np.random.default_rng(0).normal(size=(15, 1)))
        state = init_state(lnprob, coords, jax.random.PRNGKey(4))
        with pytest.raises(ValueError):
            run_ensemble(lnprob, state, n_steps=10)

    def test_batched_ensembles_via_vmap(self):
        """Independent fits (radial bins) advance as one jitted program."""
        means = jnp.asarray([[0.0], [5.0], [-3.0]])

        def make_state(mean, key):
            lnprob = lambda t, m=mean: -0.5 * jnp.sum((t - m) ** 2)
            coords = mean + jax.random.normal(key, (32, 1))
            return init_state(lnprob, coords, key)

        def lnprob_batched(theta, mean):
            return -0.5 * jnp.sum((theta - mean) ** 2)

        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        states = jax.vmap(make_state)(means, keys)

        def run_one(state, mean):
            return run_ensemble(lambda t: lnprob_batched(t, mean), state, n_steps=500)

        # note: lnprob closes over the vmapped mean -> rebuild inside vmap
        def run(mean, state):
            lnprob = lambda t: -0.5 * jnp.sum((t - mean) ** 2)
            return run_ensemble(lnprob, state, n_steps=500)

        results = jax.vmap(run)(means, states)
        chains = np.asarray(results.chain)  # (3, 32, 500, 1)
        for b in range(3):
            assert abs(chains[b, :, 200:, 0].mean() - float(means[b, 0])) < 0.15


class TestDiagnostics:
    def test_autocorr_and_ess(self):
        lnprob = _gaussian_lnprob([0.0], [[1.0]])
        coords = jnp.asarray(np.random.default_rng(0).normal(size=(32, 1)))
        state = init_state(lnprob, coords, jax.random.PRNGKey(5))
        result = run_ensemble(lnprob, state, n_steps=2000)
        tau = autocorr_time(np.asarray(result.chain))
        assert 1.0 < tau[0] < 60.0
        ess = effective_sample_size(np.asarray(result.chain))
        assert ess[0] > 500

    def test_sampler_result_emcee_accessors(self):
        """SamplerResult mirrors the emcee surface scripts actually use:
        v2 attributes (.chain/.flatchain, walker-major) and v3 accessors
        (get_chain/get_log_prob, step-major, with discard/thin/flat) plus
        get_autocorr_time with the 50-tau short-chain guard."""
        import pytest
        from mcmc_dynamics_jax.models.base import SamplerResult
        from mcmc_dynamics_jax.sampler import AutocorrError

        rng = np.random.default_rng(3)
        W, S, K = 6, 40, 3
        chain = rng.normal(size=(W, S, K))
        lnp = rng.normal(size=(W, S))
        res = SamplerResult(chain=chain, lnprobability=lnp, final_state=None,
                            acceptance_fraction=np.full(W, 0.5))

        assert res.flatchain.shape == (W * S, K)
        assert res.flatlnprobability.shape == (W * S,)
        v3 = res.get_chain()
        assert v3.shape == (S, W, K)
        np.testing.assert_array_equal(v3[7, 2], chain[2, 7])
        # emcee v3 thin rule: the LAST step of each window ([discard+thin-1::thin])
        sub = res.get_chain(discard=10, thin=2)
        assert sub.shape == ((S - 10) // 2, W, K)
        np.testing.assert_array_equal(sub[0, 1], chain[1, 11])
        flat = res.get_chain(discard=10, thin=2, flat=True)
        assert flat.shape == (sub.shape[0] * W, K)
        assert res.get_log_prob(discard=5).shape == (S - 5, W)
        np.testing.assert_array_equal(res.get_log_prob(flat=True),
                                      np.swapaxes(lnp, 0, 1).reshape(-1))

        # a 40-step white-noise chain is far shorter than 50 tau would need
        # to certify; quiet=True returns the estimate instead of raising
        with pytest.raises(AutocorrError):
            res.get_autocorr_time()
        tau = res.get_autocorr_time(quiet=True)
        assert tau.shape == (K,) and np.all(tau > 0)

    def test_gelman_rubin_converged(self):
        lnprob = _gaussian_lnprob([0.0], [[1.0]])
        coords = jnp.asarray(np.random.default_rng(0).normal(size=(32, 1)))
        state = init_state(lnprob, coords, jax.random.PRNGKey(6))
        result = run_ensemble(lnprob, state, n_steps=1500)
        rhat = gelman_rubin(np.asarray(result.chain[:, 300:, :]))
        assert rhat[0] < 1.1


class TestDifferentialEvolutionMove:
    """The emcee-v3-style DE move (ter Braak 2006) as an alternative ensemble
    move — plain-Metropolis acceptance, red-blue halves, gamma = 2.38/sqrt(2K)
    with 10% mode-jumping gamma = 1 proposals."""

    def test_de_matches_analytic_gaussian_posterior(self):
        import jax
        import jax.numpy as jnp
        from scipy import stats as sps

        mean = jnp.asarray([1.0, -2.0, 0.5])
        prec = jnp.asarray(np.linalg.inv(np.array([[2.0, 0.9, 0.0],
                                                   [0.9, 1.0, -0.3],
                                                   [0.0, -0.3, 0.5]])))

        def lnprob(theta):
            d = theta - mean
            return -0.5 * d @ prec @ d

        rng = np.random.default_rng(0)
        pos = rng.normal(0, 1, (96, 3))
        state = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(2))
        res = run_ensemble(lnprob, state, n_steps=2500, move="de")
        flat = np.asarray(res.chain)[:, 800:, :].reshape(-1, 3)

        cov_true = np.linalg.inv(np.asarray(prec))
        sd_true = np.sqrt(np.diag(cov_true))
        assert np.all(np.abs(flat.mean(axis=0) - np.asarray(mean)) < 0.08 * sd_true)
        assert np.all(np.abs(flat.std(axis=0) - sd_true) / sd_true < 0.08)
        cov_got = np.cov(flat.T)
        scale = np.sqrt(np.outer(np.diag(cov_true), np.diag(cov_true)))
        assert np.all(np.abs(cov_got - cov_true) / scale < 0.12)
        acc = np.asarray(res.acceptance_fraction)
        assert acc.mean() > 0.2

    def test_de_runner_integration_and_unknown_move_rejected(self):
        import jax.numpy as jnp
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(3)
        n = 150
        ra_c, dec_c = 56.345, -26.675
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        fit = ConstantFit(data, parameters=params, seed=5)
        sampler = fit(n_walkers=32, n_steps=150, move="de", prefix=None)
        assert np.isfinite(sampler.lnprobability[:, -1]).all()
        sig = np.median(sampler.chain[:, 75:, 1])
        assert 4.0 < sig < 9.0  # recovers the injected ~6 km/s dispersion

        with pytest.raises(ValueError, match="Unknown move"):
            fit(n_walkers=8, n_steps=4, move="nope", prefix=None)


class TestSnookerMove:
    """Snooker DE move (ter Braak & Vrugt 2008; emcee v3 DESnookerMove):
    projection-based proposals with the |y-z|^(K-1)/|x-z|^(K-1) Metropolis
    correction, shared between the single-device and shard_map samplers."""

    def test_snooker_matches_analytic_gaussian_posterior(self):
        import jax
        import jax.numpy as jnp

        mean = jnp.asarray([1.0, -2.0, 0.5])
        prec = jnp.asarray(np.linalg.inv(np.array([[2.0, 0.9, 0.0],
                                                   [0.9, 1.0, -0.3],
                                                   [0.0, -0.3, 0.5]])))

        def lnprob(theta):
            d = theta - mean
            return -0.5 * d @ prec @ d

        rng = np.random.default_rng(0)
        pos = rng.normal(0, 1, (96, 3))
        state = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(7))
        res = run_ensemble(lnprob, state, n_steps=3000, move="snooker")
        flat = np.asarray(res.chain)[:, 1000:, :].reshape(-1, 3)

        cov_true = np.linalg.inv(np.asarray(prec))
        sd_true = np.sqrt(np.diag(cov_true))
        assert np.all(np.abs(flat.mean(axis=0) - np.asarray(mean)) < 0.1 * sd_true)
        assert np.all(np.abs(flat.std(axis=0) - sd_true) / sd_true < 0.1)
        cov_got = np.cov(flat.T)
        scale = np.sqrt(np.outer(np.diag(cov_true), np.diag(cov_true)))
        assert np.all(np.abs(cov_got - cov_true) / scale < 0.15)
        acc = np.asarray(res.acceptance_fraction)
        assert acc.mean() > 0.15

    def test_snooker_partner_indices_distinct(self):
        """The three pool members must be distinct for every draw, else the
        direction or the projected difference degenerates to zero."""
        import jax
        import jax.numpy as jnp
        from mcmc_dynamics_jax.sampler.stretch import propose_snooker

        # pool rows are one-hot * (row index + 1): recover the chosen indices
        # from the proposal algebra by brute force over many keys
        n_pool, ndim = 5, 4
        pool = jnp.eye(n_pool, ndim) * jnp.arange(1.0, n_pool + 1.0)[:, None]
        active = jnp.full((64, ndim), 7.0)
        for s in range(5):
            props, ln_bias, ln_u = propose_snooker(
                active, pool, jax.random.PRNGKey(s))
            assert np.isfinite(np.asarray(props)).all()
            assert np.isfinite(np.asarray(ln_bias)).all()
            assert (np.asarray(ln_u) <= 0).all()

    def test_snooker_sharded_matches_single_device_proposals(self):
        """propose_snooker is the SAME function in both samplers; a sharded
        run with the snooker move must produce finite, advancing chains."""
        import jax
        import jax.numpy as jnp
        from mcmc_dynamics_jax.sampler.stretch import propose_snooker

        rng = np.random.default_rng(1)
        active = jnp.asarray(rng.normal(size=(8, 3)))
        pool = jnp.asarray(rng.normal(size=(8, 3)))
        key = jax.random.PRNGKey(3)
        p1 = propose_snooker(active, pool, key)
        p2 = propose_snooker(active, pool, key)
        for a, b in zip(p1, p2):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestMoveMixtures:
    """Weighted move mixtures (emcee v3 moves=[(DEMove, 0.8), ...] analog):
    per-walker move selection with state-independent probabilities — a valid
    mixture of Metropolis kernels; lnprob still runs once per half-step."""

    def test_mixture_matches_analytic_gaussian_posterior(self):
        import jax
        import jax.numpy as jnp

        mean = jnp.asarray([1.0, -2.0, 0.5])
        prec = jnp.asarray(np.linalg.inv(np.array([[2.0, 0.9, 0.0],
                                                   [0.9, 1.0, -0.3],
                                                   [0.0, -0.3, 0.5]])))

        def lnprob(theta):
            d = theta - mean
            return -0.5 * d @ prec @ d

        rng = np.random.default_rng(0)
        pos = rng.normal(0, 1, (96, 3))
        state = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(11))
        res = run_ensemble(lnprob, state, n_steps=2500,
                           move=(("de", 0.8), ("snooker", 0.2)))
        flat = np.asarray(res.chain)[:, 800:, :].reshape(-1, 3)
        cov_true = np.linalg.inv(np.asarray(prec))
        sd_true = np.sqrt(np.diag(cov_true))
        assert np.all(np.abs(flat.mean(axis=0) - np.asarray(mean)) < 0.1 * sd_true)
        assert np.all(np.abs(flat.std(axis=0) - sd_true) / sd_true < 0.1)

    def test_single_move_stream_unchanged_by_mixture_machinery(self):
        """move='de' must draw the identical proposal stream as a 1-element
        mixture (('de', 1.0),) — the normalisation path may not burn keys."""
        import jax
        import jax.numpy as jnp

        def lnprob(theta):
            return -0.5 * jnp.sum(theta * theta)

        pos = np.random.default_rng(1).normal(size=(16, 2))
        s1 = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(3))
        r1 = run_ensemble(lnprob, s1, n_steps=25, move="de")
        r2 = run_ensemble(lnprob, s1, n_steps=25, move=(("de", 1.0),))
        np.testing.assert_array_equal(np.asarray(r1.final.coords),
                                      np.asarray(r2.final.coords))

    def test_move_hyperparameters_take_effect(self):
        """Per-move params must reach the proposal kernels: a stretch a= in
        the spec equals the a= kwarg bitwise, and a custom DE gamma0 changes
        the stream."""
        import jax
        import jax.numpy as jnp

        def lnprob(theta):
            return -0.5 * jnp.sum(theta * theta)

        pos = np.random.default_rng(2).normal(size=(16, 2))
        s = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(5))
        r_kw = run_ensemble(lnprob, s, n_steps=25, move="stretch", a=1.5)
        r_sp = run_ensemble(lnprob, s, n_steps=25,
                            move=(("stretch", 1.0, {"a": 1.5}),))
        np.testing.assert_array_equal(np.asarray(r_kw.final.coords),
                                      np.asarray(r_sp.final.coords))
        r_d1 = run_ensemble(lnprob, s, n_steps=25, move="de")
        r_d2 = run_ensemble(lnprob, s, n_steps=25,
                            move=(("de", 1.0, {"gamma0": 0.4}),))
        assert not np.array_equal(np.asarray(r_d1.final.coords),
                                  np.asarray(r_d2.final.coords))

    def test_invalid_mixture_specs_rejected(self):
        from mcmc_dynamics_jax.sampler.stretch import normalize_move

        assert normalize_move("de") == (("de", 1.0, ()),)
        norm = normalize_move((("de", 2.0), ("snooker", 2.0)))
        assert norm == (("de", 0.5, ()), ("snooker", 0.5, ()))
        # hyperparameters ride along as a sorted hashable tuple
        norm = normalize_move((("de", 1.0, {"gamma0": 0.8, "jitter": 1e-4}),))
        assert norm == (("de", 1.0, (("gamma0", 0.8), ("jitter", 1e-4))),)
        with pytest.raises(ValueError, match="Unknown move"):
            normalize_move((("nope", 1.0),))
        with pytest.raises(ValueError, match="positive"):
            normalize_move((("de", 0.0),))
        with pytest.raises(ValueError, match="name or a sequence"):
            normalize_move(42)
        with pytest.raises(ValueError, match="hyperparameter"):
            normalize_move((("de", 1.0, {"a": 2.0}),))

    def test_mixture_under_sharding(self):
        import jax.numpy as jnp
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.parallel import make_mesh
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(9)
        n = 60
        ra_c, dec_c = 56.345, -26.675
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        fit = ConstantFit(data, parameters=params, seed=5)
        mesh = make_mesh(("dp", "sp"), (2, 4))
        sampler = fit(n_walkers=16, n_steps=50,
                      move=(("stretch", 0.5), ("de", 0.5)), mesh=mesh,
                      prefix=None)
        assert np.isfinite(sampler.lnprobability[:, -1]).all()


class TestMoveValidationRegressions:
    def test_snooker_rejects_tiny_pool(self):
        import jax
        from mcmc_dynamics_jax.sampler.stretch import propose_snooker

        with pytest.raises(ValueError, match="pool of >= 3"):
            propose_snooker(jnp.zeros((2, 3)), jnp.zeros((2, 3)),
                            jax.random.PRNGKey(0))

    def test_negative_mixture_weight_rejected(self):
        """Negative weights used to pass if the SUM was positive, silently
        routing every walker to the last move."""
        from mcmc_dynamics_jax.sampler.stretch import normalize_move

        with pytest.raises(ValueError, match="positive"):
            normalize_move((("de", -1.0), ("snooker", 2.0)))
