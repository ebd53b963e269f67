"""Parallel-tempered ensemble sampler: multimodal mixing + evidence estimation."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax.sampler import init_state, run_ensemble
from mcmc_dynamics_jax.sampler.tempered import (init_tempered, log_evidence,
                                                make_beta_ladder, run_tempered)


def _bimodal_lnprob(separation=12.0):
    """Two well-separated 1D Gaussians with 30/70 weights."""
    mu = jnp.asarray([0.0, separation])
    w = jnp.asarray([0.3, 0.7])

    def lnprob(theta):
        x = theta[0]
        comp = jnp.log(w) - 0.5 * (x - mu) ** 2 - 0.5 * math.log(2 * math.pi)
        return jax.scipy.special.logsumexp(comp)

    return lnprob


class TestTempered:
    def test_ladder(self):
        betas = make_beta_ladder(5, 1e-2)
        assert betas[0] == 1.0 and abs(betas[-1] - 1e-2) < 1e-12
        assert np.all(np.diff(betas) < 0)

    def test_bimodal_mixing_beats_plain_ensemble(self):
        lnprob = _bimodal_lnprob()
        rng = np.random.default_rng(0)
        # all walkers start in the SMALLER mode at 0
        pos = 0.1 * rng.normal(size=(32, 1))

        # plain ensemble: stuck in the starting mode
        state = init_state(lnprob, jnp.asarray(pos), jax.random.PRNGKey(0))
        plain = run_ensemble(lnprob, state, n_steps=1500)
        plain_frac = float(np.mean(np.asarray(plain.chain[:, 750:, 0]) > 6.0))

        # tempered: hot chains cross, swaps propagate to the cold chain
        tstate, betas = init_tempered(lnprob, jnp.asarray(pos),
                                      jax.random.PRNGKey(0), n_temps=6,
                                      beta_min=1e-2)
        res = run_tempered(lnprob, tstate, betas, n_steps=1500, swap_every=5)
        cold = np.asarray(res.chain[:, 750:, 0])
        frac_right = float(np.mean(cold > 6.0))

        assert plain_frac < 0.05            # plain sampler cannot cross
        assert abs(frac_right - 0.7) < 0.12  # tempered recovers the 70% weight

        sw = np.asarray(res.swap_acceptance)
        assert np.all(sw > 0.05)            # ladder actually exchanges

    def test_evidence_gaussian(self):
        """TI evidence for lnP = -x^2/2 (unnormalised): ln Z = 0.5 ln(2 pi)."""
        lnprob = lambda theta: -0.5 * theta[0] ** 2
        rng = np.random.default_rng(1)
        pos = rng.normal(size=(64, 1))
        tstate, betas = init_tempered(lnprob, jnp.asarray(pos),
                                      jax.random.PRNGKey(2), n_temps=24,
                                      beta_min=1e-4)
        res = run_tempered(lnprob, tstate, betas, n_steps=2500, swap_every=5)
        lnz = log_evidence(betas, res.mean_lnp_by_beta)
        # TI with a finite geometric ladder truncated at beta_min:
        # exact ln Z(beta_min -> 1) = 0.5 ln(2 pi) - 0.5 ln(beta_min) ... the
        # integral from 0 to beta_min is missed; compare against the analytic
        # value of the SAME truncated integral: int_bmin^1 E_beta[lnP] dbeta
        # with E_beta[lnP] = -1/(2 beta):
        expected = -0.5 * (math.log(1.0) - math.log(1e-4))
        assert abs(lnz - expected) < 0.35, (lnz, expected)

    def test_resume_and_acceptance(self):
        lnprob = _bimodal_lnprob(6.0)
        rng = np.random.default_rng(3)
        pos = rng.normal(size=(16, 1))
        tstate, betas = init_tempered(lnprob, jnp.asarray(pos),
                                      jax.random.PRNGKey(4), n_temps=4)
        r1 = run_tempered(lnprob, tstate, betas, n_steps=100)
        r2 = run_tempered(lnprob, r1.final, betas, n_steps=100)
        acc = np.asarray(r2.acceptance_fraction)
        assert acc.shape == (4, 16)
        assert np.all(acc > 0.05) and np.all(acc <= 1.0)
        assert int(r2.final.step) == 200


class TestShardedTempering:
    """Temperature-sharded replica exchange (parallel/tempered.py): one
    temperature per tp-rank, swaps as even-odd ppermute neighbour exchanges."""

    def _fit(self, seed=3):
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.utils import DataReader

        rng = np.random.default_rng(0)
        n = 150
        ra_c, dec_c = 56.345, -26.675
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.02 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.02 * rng.normal(size=n), "deg"),
            "v": u.Quantity(6.0 * rng.normal(size=n) + 2.0, "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        params["sigma_max"].set(max=100.0)
        return ConstantFit(data, parameters=params, seed=seed)

    def test_matches_single_device_tempering(self):
        from mcmc_dynamics_jax.parallel import make_mesh

        fit = self._fit()
        mesh = make_mesh(("tp",), (8,))
        res_s, lnz_s = fit.sample_tempered(n_walkers=32, n_steps=800, mesh=mesh)
        res_1, lnz_1 = fit.sample_tempered(n_walkers=32, n_steps=800, n_temps=8)

        # same posterior from the cold chain (distributional agreement)
        for col in (0, 1):
            m_s = float(np.median(res_s.chain[:, 300:, col]))
            m_1 = float(np.median(res_1.chain[:, 300:, col]))
            sd = float(np.std(res_1.chain[:, 300:, col]))
            assert abs(m_s - m_1) < 0.5 * sd + 0.2, (col, m_s, m_1)
        # thermodynamic-integration evidence agrees within MC noise
        assert abs(lnz_s - lnz_1) < 0.05 * abs(lnz_1)
        assert np.isfinite(res_s.lnprobability).all()

    def test_replica_swaps_ride_the_mesh(self):
        """ppermute exchanges must actually move states between ranks —
        nonzero swap acceptance at every adjacent pair."""
        import jax
        from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded

        fit = self._fit()
        mesh = make_mesh(("tp",), (8,))
        pos = fit.get_initials(32)
        res = run_tempered_sharded(fit, pos, jax.random.PRNGKey(1),
                                   n_steps=600, mesh=mesh)
        swap_acc = np.asarray(res.swap_acceptance)
        assert swap_acc.shape == (7,)
        assert (swap_acc > 0.02).all(), swap_acc
        assert (swap_acc <= 1.0).all()
        # final state carries every temperature level
        assert res.final.coords.shape == (8, 32, 4)

    def test_mesh_without_axis_rejected(self):
        import jax
        from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded

        fit = self._fit()
        mesh = make_mesh(("dp",), (8,))
        with pytest.raises(ValueError, match="tp"):
            run_tempered_sharded(fit, fit.get_initials(8),
                                 jax.random.PRNGKey(0), n_steps=4, mesh=mesh)

    def test_ladder_resume_matches_uninterrupted(self):
        """final.coords (n_temps, W, P) + final.key + step0 resume the ladder
        ON the mesh: a 25+35 chunked run reproduces a 60-step run's cold
        chain bitwise — the ODD split exercises the global-step swap-phase
        alignment (per-level lnP recompute is deterministic)."""
        import jax
        from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded
        from mcmc_dynamics_jax.parallel import tempered as pt

        fit = self._fit(seed=7)
        mesh = make_mesh(("tp",), (8,))
        pos = fit.get_initials(16)
        full = run_tempered_sharded(fit, pos, jax.random.PRNGKey(9),
                                    n_steps=60, mesh=mesh)
        pt._PROGRAM_CACHE.clear()
        r1 = run_tempered_sharded(fit, pos, jax.random.PRNGKey(9),
                                  n_steps=25, mesh=mesh)
        r2 = run_tempered_sharded(fit, r1.final.coords, r1.final.key,
                                  n_steps=35, mesh=mesh,
                                  step0=int(r1.final.step),
                                  log_prob0=r1.final.log_prob)
        assert int(r2.final.step) == 60
        chunked = np.concatenate([np.asarray(r1.chain), np.asarray(r2.chain)],
                                 axis=1)
        np.testing.assert_array_equal(chunked, np.asarray(full.chain))
        np.testing.assert_array_equal(np.asarray(r2.final.coords),
                                      np.asarray(full.final.coords))
        # resuming WITHOUT the carried lnP (recompute fallback) also matches
        # here (f64 CPU recompute is exact); the carried path above is the
        # production rule — see the checkpoint invariant in models/base.py
        r2b = run_tempered_sharded(fit, r1.final.coords, r1.final.key,
                                   n_steps=35, mesh=mesh,
                                   step0=int(r1.final.step))
        np.testing.assert_array_equal(np.asarray(r2b.chain),
                                      np.asarray(r2.chain))
        # a further same-shape resumed chunk reuses the compiled program
        n_programs = len(pt._PROGRAM_CACHE)
        run_tempered_sharded(fit, r2.final.coords, r2.final.key,
                             n_steps=35, mesh=mesh, step0=int(r2.final.step),
                             log_prob0=r2.final.log_prob)
        assert len(pt._PROGRAM_CACHE) == n_programs == 3  # fresh + 2 resumed
        # wrong-shaped carried lnP is rejected
        with pytest.raises(ValueError, match="log_prob0"):
            run_tempered_sharded(fit, r1.final.coords, r1.final.key,
                                 n_steps=4, mesh=mesh,
                                 log_prob0=r1.final.log_prob[:, :4])
        # wrong ladder extent is rejected
        with pytest.raises(ValueError, match="tp extent"):
            run_tempered_sharded(fit, r1.final.coords[:4],
                                 r1.final.key, n_steps=4, mesh=mesh)

    def test_sample_tempered_state_resume_both_paths(self):
        """Runner.sample_tempered(state=...) continues the ladder where a
        prior run stopped, on the mesh and on a single device."""
        from mcmc_dynamics_jax.parallel import make_mesh

        fit = self._fit(seed=9)
        mesh = make_mesh(("tp",), (8,))
        # reuse pos: get_initials advances the host RNG on every call
        pos = fit.get_initials(16)
        r1, _ = fit.sample_tempered(pos=pos, n_steps=21, mesh=mesh, seed=4)
        r2, _ = fit.sample_tempered(n_steps=19, mesh=mesh,
                                    state=r1.final_state)
        full, _ = fit.sample_tempered(pos=pos, n_steps=40, mesh=mesh, seed=4)
        chunked = np.concatenate([r1.chain, r2.chain], axis=1)
        np.testing.assert_array_equal(chunked, full.chain)

        # odd split: the swap schedule is gated on the carried global step,
        # so resume aligns even when the chunk is not a swap_every multiple
        s1, _ = fit.sample_tempered(pos=pos, n_steps=17, n_temps=4, seed=5)
        s2, _ = fit.sample_tempered(n_steps=23, n_temps=4,
                                    state=s1.final_state)
        sfull, _ = fit.sample_tempered(pos=pos, n_steps=40, n_temps=4, seed=5)
        chunked1 = np.concatenate([s1.chain, s2.chain], axis=1)
        np.testing.assert_array_equal(chunked1, sfull.chain)


class TestTemperedMoves:
    def test_de_mixture_move_in_tempered_sampler(self):
        """move= flows through run_tempered: the bimodal ladder (modes at 0
        and 12, weights 0.3/0.7) still mixes between modes with a DE/snooker
        mixture driving the proposals."""
        lnprob = _bimodal_lnprob()
        # all walkers start in the SMALLER mode at 0
        pos = 0.1 * np.random.default_rng(2).normal(size=(32, 1))
        state, betas = init_tempered(lnprob, jnp.asarray(pos),
                                     jax.random.PRNGKey(4), n_temps=8,
                                     beta_min=1e-2)
        res = run_tempered(lnprob, state, betas, n_steps=1500, swap_every=5,
                           move=(("de", 0.7), ("snooker", 0.3)))
        cold = np.asarray(res.chain)[:, 750:, 0].reshape(-1)
        frac_right = float(np.mean(cold > 6.0))
        assert abs(frac_right - 0.7) < 0.15, frac_right
        assert np.asarray(res.swap_acceptance).mean() > 0.05

    def test_stretch_stream_unchanged_by_shared_proposals(self):
        """The refactor onto propose_mixture must preserve the stretch key
        stream bitwise (same uniforms layout as the old inline proposal)."""
        lnprob = _bimodal_lnprob()
        pos = np.random.default_rng(3).normal(6.0, 0.5, (16, 2))
        state, betas = init_tempered(lnprob, jnp.asarray(pos),
                                     jax.random.PRNGKey(5), n_temps=4)
        r1 = run_tempered(lnprob, state, betas, n_steps=30)
        r2 = run_tempered(lnprob, state, betas, n_steps=30, move="stretch")
        np.testing.assert_array_equal(np.asarray(r1.final.coords),
                                      np.asarray(r2.final.coords))


class TestShardedTemperingRegressions:
    """Review-pass regressions: even swap_every phase pinning, resume key,
    cold-chain-only trajectory transfer."""

    def test_even_swap_every_still_exchanges_all_pairs(self):
        """Phase must count swap ROUNDS: with swap_every=2 a raw step-parity
        phase was pinned to 1 and the even pairs (incl. the cold pair) never
        swapped."""
        import jax
        from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded

        fit = TestShardedTempering._fit(TestShardedTempering())
        mesh = make_mesh(("tp",), (8,))
        res = run_tempered_sharded(fit, fit.get_initials(32),
                                   jax.random.PRNGKey(2), n_steps=600,
                                   mesh=mesh, swap_every=2)
        swap_acc = np.asarray(res.swap_acceptance)
        assert (swap_acc > 0.02).all(), swap_acc

    def test_final_state_resumes_with_advanced_key(self):
        """res.final.key must be the post-run key: a resumed segment may not
        replay the first segment's random stream."""
        import jax
        from mcmc_dynamics_jax.parallel import make_mesh, run_tempered_sharded
        from mcmc_dynamics_jax.sampler.stretch import key_to_arrays

        fit = TestShardedTempering._fit(TestShardedTempering())
        mesh = make_mesh(("tp",), (8,))
        key = jax.random.PRNGKey(3)
        r1 = run_tempered_sharded(fit, fit.get_initials(16), key, n_steps=40,
                                  mesh=mesh)
        k_in, _ = key_to_arrays(key)
        k_fin, _ = key_to_arrays(r1.final.key)
        assert not np.array_equal(np.asarray(k_in), np.asarray(k_fin))

        # continuing from the final coords with the final key produces a
        # different stream than re-running from the start
        r2 = run_tempered_sharded(fit, np.asarray(r1.final.coords[0]),
                                  r1.final.key, n_steps=40, mesh=mesh)
        assert not np.allclose(np.asarray(r2.chain[:, :5]),
                               np.asarray(r1.chain[:, :5]))
