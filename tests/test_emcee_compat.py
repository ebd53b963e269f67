"""emcee-compatible EnsembleSampler: both backends against known posteriors."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from mcmc_dynamics_jax.emcee_compat import (EnsembleSampler, backends,
                                             _normalize_moves)


def _jax_lnprob(theta):
    # correlated 2-D Gaussian, jnp math -> traceable
    d0 = theta[0] - 1.0
    d1 = theta[1] + 2.0
    return -0.5 * (d0 * d0 + d1 * d1 + d0 * d1)


def _scipy_lnprob(theta):
    # scipy.stats breaks tracing -> numpy fallback path
    from scipy import stats
    return float(stats.norm.logpdf(theta[0], loc=1.0)
                 + stats.norm.logpdf(theta[1], loc=-2.0))


class TestJaxBackend:
    def test_posterior_and_surface(self):
        nwalkers, ndim = 64, 2
        s = EnsembleSampler(nwalkers, ndim, _jax_lnprob, seed=1)
        assert s.backend_kind == "jax"
        p0 = np.random.default_rng(0).normal(size=(nwalkers, ndim))
        pos, lnp = s.run_mcmc(p0, 600)
        assert pos.shape == (nwalkers, ndim) and lnp.shape == (nwalkers,)

        flat = s.get_chain(discard=200, flat=True)
        # target: cov = inv([[1, .5], [.5, 1]]) -> var = 4/3
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.1
        assert abs(np.mean(flat[:, 1]) + 2.0) < 0.1
        assert abs(np.var(flat[:, 0]) - 4.0 / 3.0) < 0.2

        # emcee v3/v2 accessors
        assert s.get_chain().shape == (600, nwalkers, ndim)
        assert s.get_chain(thin=10, discard=100).shape == (50, nwalkers, ndim)
        assert s.get_log_prob(flat=True).shape == (600 * nwalkers,)
        assert s.chain.shape == (nwalkers, 600, ndim)
        assert s.flatchain.shape == (600 * nwalkers, ndim)
        assert s.lnprobability.shape == (nwalkers, 600)
        acc = s.acceptance_fraction
        assert acc.shape == (nwalkers,)
        assert 0.1 < acc.mean() < 0.95
        assert s.iteration == 600

        # continuation without initial_state
        s.run_mcmc(None, 50)
        assert s.get_chain().shape == (650, nwalkers, ndim)

        # reset keeps the position, drops the history
        last = s.get_last_sample()[0]
        s.reset()
        with pytest.raises(AttributeError):
            s.get_chain()
        s.run_mcmc(None, 10)
        np.testing.assert_allclose(s.chain[:, 0, :].mean(), last.mean(),
                                   atol=1.0)

    def test_vectorized_lnprob(self):
        def batched(thetas):
            d = thetas - jnp.asarray([1.0, -2.0])
            return -0.5 * jnp.sum(d * d, axis=1)

        s = EnsembleSampler(32, 2, batched, vectorize=True, seed=3)
        assert s.backend_kind == "jax"
        s.run_mcmc(np.zeros((32, 2)) + 0.1 * np.random.default_rng(1)
                   .normal(size=(32, 2)), 400)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.15

    def test_thin_by(self):
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=5)
        s.run_mcmc(np.random.default_rng(2).normal(size=(16, 2)), 50, thin_by=4)
        assert s.get_chain().shape == (50, 16, 2)
        assert s.iteration == 50    # stored steps (emcee meaning)
        assert s.proposals == 200   # 50 recorded x 4 actual

    def test_de_moves(self):
        s = EnsembleSampler(32, 2, _jax_lnprob, moves="de", seed=7)
        s.run_mcmc(np.random.default_rng(3).normal(size=(32, 2)), 300)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.2


class TestNumpyFallback:
    def test_scipy_lnprob_recovers_posterior(self):
        s = EnsembleSampler(24, 2, _scipy_lnprob, seed=11)
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.random.default_rng(4).normal(size=(24, 2)), 400)
        flat = s.get_chain(discard=150, flat=True)
        assert abs(np.mean(flat[:, 0]) - 1.0) < 0.15
        assert abs(np.mean(flat[:, 1]) + 2.0) < 0.15
        assert abs(np.std(flat[:, 0]) - 1.0) < 0.2
        assert 0.1 < s.acceptance_fraction.mean() < 0.95

    def test_args_closure(self):
        def lnprob(theta, mu, scale=1.0):
            from scipy import stats
            return float(stats.norm.logpdf(theta[0], loc=mu, scale=scale))

        s = EnsembleSampler(16, 1, lnprob, args=(3.0,),
                            kwargs={"scale": 0.5}, seed=13)
        assert s.backend_kind == "numpy"
        s.run_mcmc(3.0 + 0.1 * np.random.default_rng(5).normal(size=(16, 1)),
                   300)
        flat = s.get_chain(discard=100, flat=True)
        assert abs(np.mean(flat) - 3.0) < 0.1
        assert abs(np.std(flat) - 0.5) < 0.1

    def test_de_moves_rejected_on_fallback(self):
        s = EnsembleSampler(16, 2, _scipy_lnprob, moves="de")
        with pytest.raises(NotImplementedError, match="traceable"):
            s.run_mcmc(np.random.default_rng(6).normal(size=(16, 2)), 5)


class TestMoveNormalization:
    def test_specs(self):
        assert _normalize_moves(None) == "stretch"
        assert _normalize_moves("snooker") == "snooker"
        assert _normalize_moves([("de", 0.8), ("stretch", 0.2)]) == \
            [("de", 0.8, {}), ("stretch", 0.2, {})]

    def test_emcee_instances_by_class_name(self):
        class DEMove:      # stands in for emcee.moves.DEMove
            pass

        class StretchMove:
            pass

        assert _normalize_moves([(DEMove(), 0.7), (StretchMove(), 0.3)]) == \
            [("de", 0.7, {}), ("stretch", 0.3, {})]
        assert _normalize_moves([DEMove()]) == [("de", 1.0, {})]

    def test_emcee_instance_hyperparameters_kept(self):
        """Tuned hyperparameters on emcee move instances must survive
        normalisation (they used to be silently dropped)."""
        class StretchMove:
            def __init__(self, a):
                self.a = a

        class DEMove:
            def __init__(self, sigma, gamma0):
                self.sigma = sigma
                self.g0 = gamma0     # emcee's attribute name for gamma0

        class DESnookerMove:
            def __init__(self, gammas):
                self.gammas = gammas

        assert _normalize_moves(StretchMove(a=1.5)) == \
            [("stretch", 1.0, {"a": 1.5})]
        assert _normalize_moves([(DEMove(1e-4, 0.7), 0.8),
                                 (DESnookerMove(2.1), 0.2)]) == \
            [("de", 0.8, {"jitter": 1e-4, "gamma0": 0.7}),
             ("snooker", 0.2, {"gammas": 2.1})]
        # emcee's DEMove(gamma0=None) default -> our default, not forwarded
        assert _normalize_moves([DEMove(1e-5, None)]) == \
            [("de", 1.0, {"jitter": 1e-5})]

    def test_stretch_instance_runs_on_numpy_fallback(self):
        """moves=[StretchMove()] with a non-traceable log-prob is the exact
        emcee idiom; it must run on the host fallback, honouring a."""
        class StretchMove:
            def __init__(self, a=2.0):
                self.a = a

        def np_lnprob(theta):      # scipy/np only -> numpy backend
            from scipy import stats
            return float(stats.norm.logpdf(theta).sum())

        s = EnsembleSampler(16, 2, np_lnprob, moves=[StretchMove(a=1.5)],
                            seed=3)
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.random.default_rng(0).normal(size=(16, 2)), 20)
        assert s.get_chain().shape == (20, 16, 2)
        assert 0.0 < s.acceptance_fraction.mean() <= 1.0

    def test_unknown_move_rejected(self):
        with pytest.raises(ValueError, match="Unsupported move"):
            _normalize_moves([object()])


class TestValidation:
    def test_odd_walkers_rejected(self):
        with pytest.raises(ValueError, match="even"):
            EnsembleSampler(7, 2, _jax_lnprob)

    def test_all_invalid_start_rejected(self):
        s = EnsembleSampler(8, 2, lambda t: -jnp.inf * jnp.sum(t * 0 + 1.0))
        with pytest.raises(ValueError, match="-inf"):
            s.run_mcmc(np.ones((8, 2)), 5)

    def test_bad_shape_rejected(self):
        s = EnsembleSampler(8, 2, _jax_lnprob)
        with pytest.raises(ValueError, match="shape"):
            s.run_mcmc(np.ones((4, 2)), 5)


def _module_level_lnprob(theta, scale, offset=0.0):
    return float(-0.5 * np.sum((theta - offset) ** 2) / scale ** 2)


class TestStateRoundTrip:
    def test_burn_in_idiom(self):
        """run_mcmc's return value is a State that can be passed straight back
        as initial_state (the canonical emcee burn-in pattern)."""
        from mcmc_dynamics_jax.emcee_compat import State

        s = EnsembleSampler(16, 2, _jax_lnprob, seed=3)
        p0 = np.random.default_rng(0).normal(size=(16, 2))
        state = s.run_mcmc(p0, 10)
        assert isinstance(state, State)
        coords, log_prob = state           # still unpacks as a pair
        assert coords.shape == (16, 2) and log_prob.shape == (16,)
        s.reset()
        s.run_mcmc(state, 20)
        assert s.get_chain().shape == (20, 16, 2)

        # a bare (coords, log_prob) tuple from older code also works
        s.run_mcmc((coords, log_prob), 5)

        # get_last_sample returns the same State type
        last = s.get_last_sample()
        assert isinstance(last, State)
        s.run_mcmc(last, 3)

    def test_numpy_backend_returns_state(self):
        from mcmc_dynamics_jax.emcee_compat import State

        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=4)
        state = s.run_mcmc(np.random.default_rng(1).normal(size=(8, 2)), 5)
        assert isinstance(state, State)
        s.run_mcmc(state, 5)


class TestNoRecompile:
    def test_vmap_closure_is_cached(self):
        """A second run_mcmc with identical shapes must not retrace (the
        sampler scan is jitted keyed on the lnprob function's identity)."""
        traces = {"n": 0}

        def lnp(theta):
            traces["n"] += 1      # incremented once per (re)trace
            return -0.5 * jnp.sum(theta * theta)

        s = EnsembleSampler(16, 2, lnp, seed=5)
        p0 = np.random.default_rng(2).normal(size=(16, 2))
        s.run_mcmc(p0, 5)
        n_first = traces["n"]
        assert n_first > 0
        s.run_mcmc(None, 5)
        assert traces["n"] == n_first


class TestBlobs:
    """emcee blobs: (log_prob, blobs) returns on both execution paths."""

    def test_jax_scalar_blob(self):
        """Traceable (lnp, blob): blobs are recomputed for the stored chain
        and must equal the blob function applied to it elementwise."""
        def lnp_blob(theta):
            return -0.5 * jnp.sum(theta * theta), jnp.sum(theta ** 3)

        s = EnsembleSampler(16, 2, lnp_blob, seed=4)
        assert s.backend_kind == "jax" and s.has_blobs
        p0 = np.random.default_rng(0).normal(size=(16, 2))
        state = s.run_mcmc(p0, 12)
        blobs = s.get_blobs()                       # (S, W)
        chain = s.get_chain()
        assert blobs.shape == (12, 16)
        np.testing.assert_allclose(blobs, np.sum(chain ** 3, axis=-1),
                                   rtol=1e-6)
        # final State carries the blobs at the current position
        np.testing.assert_allclose(np.asarray(state.blobs), blobs[-1],
                                   rtol=1e-6)
        # flat/thin/discard follow get_chain semantics
        assert s.get_blobs(flat=True).shape == (12 * 16,)
        np.testing.assert_array_equal(s.get_blobs(discard=4, thin=2),
                                      blobs[5::2])

    def test_jax_array_and_tuple_blobs(self):
        def lnp_vec_blob(theta):     # array blob -> numeric (S, W, 2)
            return -0.5 * jnp.sum(theta * theta), theta[:2] * 2.0

        s = EnsembleSampler(8, 3, lnp_vec_blob, seed=1)
        s.run_mcmc(np.random.default_rng(1).normal(size=(8, 3)), 5)
        blobs = s.get_blobs()
        assert blobs.shape == (5, 8, 2)
        np.testing.assert_allclose(
            blobs, 2.0 * np.swapaxes(s.get_chain(), 0, 1)[:, :, :2]
            .swapaxes(0, 1), rtol=1e-6)

        def lnp_multi(theta):        # (lnp, b1, b2) -> tuple blob, emcee rule
            return (-0.5 * jnp.sum(theta * theta), theta[0], theta[1] ** 2)

        s2 = EnsembleSampler(8, 3, lnp_multi, seed=2)
        s2.run_mcmc(np.random.default_rng(2).normal(size=(8, 3)), 4)
        blobs2 = s2.get_blobs()
        # regularised object path: tuples of scalars -> (S, W, 2) numeric
        assert blobs2.shape == (4, 8, 2)
        chain2 = s2.get_chain()
        np.testing.assert_allclose(blobs2[..., 0], chain2[..., 0], rtol=1e-6)
        np.testing.assert_allclose(blobs2[..., 1], chain2[..., 1] ** 2,
                                   rtol=1e-6)

    def test_numpy_path_blobs_track_acceptance(self):
        """Host fallback: the blob of a walker must always be the blob of
        its CURRENT position (accepted proposals swap it in, rejections
        keep the old one)."""
        def lnp_blob(theta):
            return _scipy_lnprob(theta), float(np.sum(theta ** 3))

        s = EnsembleSampler(12, 2, lnp_blob, seed=9)
        s.run_mcmc(np.random.default_rng(3).normal(size=(12, 2)), 10)
        assert s.backend_kind == "numpy" and s.has_blobs
        blobs = s.get_blobs()                       # (S, W) via object path
        chain = s.get_chain()
        assert blobs.shape == (10, 12)
        np.testing.assert_allclose(np.asarray(blobs, dtype=float),
                                   np.sum(chain ** 3, axis=-1), rtol=1e-12)

    def test_hdf_blobs_roundtrip(self, tmp_path):
        """Array blobs land in the emcee-v3 'blobs' dataset and read back;
        a resumed-from-file run keeps appending to it."""
        def lnp_blob(theta):
            return -0.5 * jnp.sum(theta * theta), jnp.sum(theta) * 0.5

        fn = str(tmp_path / "blobs.h5")
        be = backends.HDFBackend(fn)
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=5)
        s.run_mcmc(np.random.default_rng(4).normal(size=(8, 2)), 6)
        import h5py
        with h5py.File(fn, "r") as f:
            g = f["mcmc"]
            assert bool(g.attrs["has_blobs"])
            assert g["blobs"].shape == (6, 8)
        reader = backends.HDFBackend(fn, read_only=True)
        assert reader.has_blobs
        np.testing.assert_allclose(
            reader.get_blobs(), 0.5 * np.sum(reader.get_chain(), axis=-1),
            rtol=1e-6)
        s2 = EnsembleSampler(8, 2, lnp_blob,
                             backend=backends.HDFBackend(fn), seed=5)
        s2.run_mcmc(None, 3)
        assert s2.get_blobs().shape == (9, 8)

    def test_backend_get_last_sample_carries_blobs(self, tmp_path):
        """Reading the State straight off the backend (the cross-process
        resume path) keeps blobs, like emcee's backends do — both in-memory
        and HDF5."""
        def lnp_blob(theta):
            return -0.5 * jnp.sum(theta * theta), jnp.sum(theta) * 0.5

        for be in (backends.Backend(),
                   backends.HDFBackend(str(tmp_path / "last.h5"))):
            s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=5)
            s.run_mcmc(np.random.default_rng(4).normal(size=(8, 2)), 6)
            last = be.get_last_sample()
            assert last.blobs is not None
            np.testing.assert_array_equal(np.asarray(last.blobs, dtype=float),
                                          s.get_blobs()[-1])
            np.testing.assert_array_equal(last.coords, s.get_chain()[-1])

    def test_hdf_stores_uniform_tuple_blobs_rejects_irregular(self, tmp_path):
        """Tuple-of-scalar blobs regularise to a numeric (S, W, 2) dataset
        (emcee's dtype-discovery behaviour); genuinely irregular blobs
        (dicts) stay object arrays, which the file backend refuses."""
        def lnp_multi(theta):
            return (-0.5 * jnp.sum(theta * theta), theta[0], theta[1])

        be = backends.HDFBackend(str(tmp_path / "tup.h5"))
        s = EnsembleSampler(8, 2, lnp_multi, backend=be, seed=6)
        s.run_mcmc(np.random.default_rng(6).normal(size=(8, 2)), 3)
        assert s.get_blobs().shape == (3, 8, 2)

        def lnp_dict(theta):
            return -0.5 * jnp.sum(theta * theta), {"x": theta[0]}

        be2 = backends.HDFBackend(str(tmp_path / "obj.h5"))
        s2 = EnsembleSampler(8, 2, lnp_dict, backend=be2, seed=6)
        with pytest.raises(NotImplementedError, match="in-memory"):
            s2.run_mcmc(np.zeros((8, 2)) + 0.1, 2)

    def test_numpy_scalar_blobs_reach_the_hdf_file(self, tmp_path):
        """Host-path scalar blobs are uniform -> numeric -> storable in HDF5
        (they used to stay dtype=object and be rejected)."""
        def lnp_blob(theta):
            return _scipy_lnprob(theta), float(np.sum(theta))

        be = backends.HDFBackend(str(tmp_path / "np.h5"))
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=6)
        s.run_mcmc(np.random.default_rng(7).normal(size=(8, 2)), 4)
        assert s.backend_kind == "numpy"
        blobs = s.get_blobs()
        assert blobs.shape == (4, 8) and blobs.dtype != object
        np.testing.assert_allclose(blobs, s.get_chain().sum(axis=-1),
                                   rtol=1e-12)

    def test_blobless_resume_of_blob_chain_raises(self):
        """Resuming a blob chain with a blob-less log-prob must fail loudly,
        not silently misalign get_blobs (emcee raises the same way)."""
        def lnp_blob(theta):
            return -0.5 * jnp.sum(theta * theta), theta[0]

        be = backends.Backend()
        s = EnsembleSampler(8, 2, lnp_blob, backend=be, seed=8)
        s.run_mcmc(np.random.default_rng(8).normal(size=(8, 2)), 4)
        s2 = EnsembleSampler(8, 2, _jax_lnprob, backend=be, seed=8)
        with pytest.raises(ValueError, match="Inconsistent use of blobs"):
            s2.run_mcmc(None, 3)

    def test_zero_step_run_mcmc_is_a_noop(self):
        """nsteps=0 is explicitly allowed by the validation; it must not
        crash the in-memory backend's buffer bookkeeping."""
        s = EnsembleSampler(8, 2, _jax_lnprob, seed=9)
        p0 = np.random.default_rng(9).normal(size=(8, 2))
        state = s.run_mcmc(p0, 0)
        assert s.iteration == 0 and state.coords.shape == (8, 2)
        s.run_mcmc(None, 5)
        assert s.get_chain().shape == (5, 8, 2)

    def test_numpy_float32_weights_accepted(self):
        """emcee accepts np scalar weights in moves=; so must we."""
        w = np.asarray([0.8, 0.2], dtype=np.float32)
        norm = _normalize_moves([("de", w[0]), ("stretch", w[1])])
        assert [(n, round(float(wt), 5), p) for n, wt, p in norm] == \
            [("de", 0.8, {}), ("stretch", 0.2, {})]

    def test_no_blobs_returns_none(self):
        s = EnsembleSampler(8, 2, _jax_lnprob, seed=7)
        s.run_mcmc(np.random.default_rng(5).normal(size=(8, 2)), 3)
        assert s.get_blobs() is None
        assert s.get_last_sample().blobs is None


class TestSampleGenerator:
    def test_yields_states_and_stores(self):
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=11)
        p0 = np.random.default_rng(7).normal(size=(16, 2))
        states = list(s.sample(p0, iterations=6))
        assert len(states) == 6
        assert all(st.coords.shape == (16, 2) for st in states)
        assert s.get_chain().shape == (6, 16, 2)
        # the last yielded state is the sampler's current state
        np.testing.assert_array_equal(states[-1].coords,
                                      s.get_last_sample().coords)

    def test_thin_by_and_store_false(self):
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=12)
        p0 = np.random.default_rng(8).normal(size=(16, 2))
        for _ in s.sample(p0, iterations=4, thin_by=3):
            pass
        assert s.get_chain().shape == (4, 16, 2)
        assert s.iteration == 4                      # stored (emcee meaning)
        assert s.proposals == 12                     # thin_by x stored
        assert s.backend.iteration == 4
        s2 = EnsembleSampler(16, 2, _jax_lnprob, seed=12)
        for _ in s2.sample(p0, iterations=3, store=False):
            pass
        with pytest.raises(AttributeError):
            s2.get_chain()
        # state still advances without storage
        assert s2.get_last_sample().coords.shape == (16, 2)


class TestHDFBackend:
    def _run(self, backend, seed, chunks, p0):
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=seed, backend=backend)
        first = p0
        for n in chunks:
            s.run_mcmc(first, n)
            first = None
        return s

    def test_bitwise_cross_process_resume(self, tmp_path):
        """An interrupted run resumed from the file by a *fresh* sampler
        equals the uninterrupted run bitwise (the PRNG key rides the file)."""
        from mcmc_dynamics_jax.emcee_compat import backends

        p0 = np.random.default_rng(1).normal(size=(16, 2))
        ref = self._run(backends.HDFBackend(str(tmp_path / "a.h5")), 3,
                        [20, 20], p0)
        full = ref.get_chain()

        self._run(backends.HDFBackend(str(tmp_path / "b.h5")), 3, [20], p0)
        # fresh backend object + fresh sampler with a DIFFERENT seed: the
        # resume must come entirely from the file
        be = backends.HDFBackend(str(tmp_path / "b.h5"))
        assert be.iteration == 20
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=999, backend=be)
        s.run_mcmc(None, 20)
        np.testing.assert_array_equal(full, s.get_chain())
        np.testing.assert_array_equal(np.asarray(ref.backend.accepted),
                                      np.asarray(be.accepted))

    def test_no_file_bloat_on_step_by_step_appends(self, tmp_path):
        """Per-step sample() appends must overwrite the saved state in place:
        HDF5 never reclaims deleted-dataset storage, so a del/create per
        append used to leak (W*K + W + key) * 8 bytes per step."""
        import os
        from mcmc_dynamics_jax.emcee_compat import backends

        fn = str(tmp_path / "bloat.h5")
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=4,
                            backend=backends.HDFBackend(fn))
        p0 = np.random.default_rng(7).normal(size=(16, 2))
        it = s.sample(p0, iterations=10)
        for _ in range(5):
            next(it)
        base = os.path.getsize(fn)
        for _ in range(5):
            next(it)
        grown = os.path.getsize(fn) - base
        # 5 more stored steps of (16, 2) chain + (16,) lnP = 1920 data bytes;
        # allow generous HDF5 chunking overhead, but far below the ~5 x state
        # re-creations (~2 kB apiece) the leak produced
        per_step_data = 16 * (2 + 1) * 8
        assert grown <= 5 * per_step_data + 4096, grown

    def test_numpy_path_resume(self, tmp_path):
        from mcmc_dynamics_jax.emcee_compat import backends

        p0 = np.zeros((8, 2))

        def run(fn, chunks):
            be = backends.HDFBackend(str(tmp_path / fn))
            s = EnsembleSampler(8, 2, _scipy_lnprob, seed=5, backend=be)
            assert s.backend_kind == "numpy"
            first = p0
            for n in chunks:
                s.run_mcmc(first, n)
                first = None
            return s.get_chain()

        full = run("a.h5", [10, 10])
        run("b.h5", [10])
        be = backends.HDFBackend(str(tmp_path / "b.h5"))
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=77, backend=be)
        s.run_mcmc(None, 10)
        np.testing.assert_array_equal(full, s.get_chain())

    def test_reader_surface_and_reset(self, tmp_path):
        from mcmc_dynamics_jax.emcee_compat import State, backends

        be = backends.HDFBackend(str(tmp_path / "c.h5"))
        p0 = np.random.default_rng(2).normal(size=(16, 2))
        self._run(be, 4, [25], p0)

        reader = backends.HDFBackend(str(tmp_path / "c.h5"), read_only=True)
        assert reader.get_chain(discard=5, thin=2).shape == (10, 16, 2)
        assert reader.get_chain(flat=True).shape == (25 * 16, 2)
        assert reader.get_log_prob().shape == (25, 16)
        assert isinstance(reader.get_last_sample(), State)
        with pytest.raises(RuntimeError, match="read-only"):
            reader.reset(16, 2)

        # emcee v3 file layout: group "mcmc" with chain (S, W, K) et al.
        import h5py
        with h5py.File(str(tmp_path / "c.h5"), "r") as f:
            g = f["mcmc"]
            assert g["chain"].shape == (25, 16, 2)
            assert g["log_prob"].shape == (25, 16)
            assert g["accepted"].shape == (16,)
            assert int(g.attrs["iteration"]) == 25
            assert not g.attrs["has_blobs"]

        # sampler.reset() clears the file chain like emcee's backend.reset
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=4, backend=be)
        s.reset()
        assert be.iteration == 0

    def test_shape_mismatch_rejected(self, tmp_path):
        from mcmc_dynamics_jax.emcee_compat import backends

        be = backends.HDFBackend(str(tmp_path / "d.h5"))
        self._run(be, 6, [5], np.random.default_rng(3).normal(size=(16, 2)))
        with pytest.raises(ValueError, match="backend holds"):
            EnsembleSampler(8, 3, _jax_lnprob, backend=be)


class TestPool:
    def test_pool_used_on_numpy_path(self):
        calls = {"n": 0}

        class CountingPool:
            def map(self, f, xs):
                calls["n"] += 1
                return [f(x) for x in xs]

        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=6, pool=CountingPool())
        assert s.backend_kind == "numpy"
        s.run_mcmc(np.zeros((8, 2)), 5)
        assert calls["n"] > 0


class TestReviewRegressions:
    """Fixes from the round-3 code review of the backends feature."""

    def test_fn_picklable_with_args(self):
        """pool= pickles the callable; the args/kwargs closure must survive."""
        import pickle

        s = EnsembleSampler(8, 2, _module_level_lnprob, args=(2.5,),
                            kwargs={"offset": 1.0})
        rt = pickle.loads(pickle.dumps(s._fn))
        np.testing.assert_allclose(rt(np.ones(2)),
                                   _module_level_lnprob(np.ones(2), 2.5,
                                                        offset=1.0))

    def test_thin_matches_emcee_semantics(self):
        """get_chain(thin=) keeps the LAST step of each window like emcee."""
        s = EnsembleSampler(16, 2, _jax_lnprob, seed=21)
        p0 = np.random.default_rng(9).normal(size=(16, 2))
        s.run_mcmc(p0, 24)
        full = s.get_chain()
        np.testing.assert_array_equal(s.get_chain(discard=5, thin=3),
                                      full[5 + 3 - 1::3])

    def test_thin_by_validation(self):
        s = EnsembleSampler(8, 2, _jax_lnprob, seed=22)
        with pytest.raises(ValueError, match="thin_by"):
            s.run_mcmc(np.zeros((8, 2)), 5, thin_by=0)
        with pytest.raises(ValueError, match="nsteps"):
            s.run_mcmc(np.zeros((8, 2)), -1)

    def test_emcee_written_file_with_pregrown_datasets(self, tmp_path):
        """Real emcee pre-grows the HDF5 datasets and advances an iteration
        attr; rows beyond it are zeros and must never be read or resumed."""
        import h5py
        from mcmc_dynamics_jax.emcee_compat import backends

        fn = str(tmp_path / "emcee.h5")
        rng = np.random.default_rng(0)
        real, nw, nd = 12, 8, 2
        with h5py.File(fn, "w") as f:
            g = f.create_group("mcmc")
            g.attrs["version"] = 3
            g.attrs["iteration"] = real
            g.attrs["has_blobs"] = False
            chain = np.zeros((20, nw, nd))           # pre-grown to 20
            chain[:real] = rng.normal(size=(real, nw, nd))
            lnp = np.zeros((20, nw))
            lnp[:real] = -0.5 * (chain[:real] ** 2).sum(-1)
            g.create_dataset("chain", data=chain, maxshape=(None, nw, nd))
            g.create_dataset("log_prob", data=lnp, maxshape=(None, nw))
            g.create_dataset("accepted", data=rng.integers(0, real, nw)
                             .astype(float))
            # note: no nwalkers/ndim/proposals attrs, no last_coords

        be = backends.HDFBackend(fn)
        got = be.get_chain()
        assert got.shape == (real, nw, nd)           # zeros rows excluded
        np.testing.assert_array_equal(got, chain[:real])
        assert be.proposals == real                  # falls back to iteration
        # resume comes from the last REAL step, not a zero row
        payload = be.load_state()
        np.testing.assert_array_equal(payload["coords"], chain[real - 1])

        s = EnsembleSampler(nw, nd, _jax_lnprob, seed=7, backend=be)
        assert s.acceptance_fraction.max() <= 1.0
        s.run_mcmc(None, 5)
        assert be.get_chain().shape == (real + 5, nw, nd)

    def test_restore_does_not_alias_backend_state(self):
        """The numpy path mutates lnp in place; restoring must copy so the
        backend's saved payload stays consistent until the next append."""
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=30)
        s.run_mcmc(np.zeros((8, 2)), 4)
        saved = np.array(s.backend.load_state()["log_prob"])
        s2 = EnsembleSampler(8, 2, _scipy_lnprob, seed=31,
                             backend=s.backend)
        assert s2._restore_from_backend()
        s2._state[1][:] = np.nan                     # simulate in-place churn
        np.testing.assert_array_equal(s.backend.load_state()["log_prob"],
                                      saved)

    def test_path_switch_clears_stale_rng_state(self, tmp_path):
        """numpy-path rng_state must not survive a jax-path append."""
        from mcmc_dynamics_jax.emcee_compat import backends

        fn = str(tmp_path / "switch.h5")
        be = backends.HDFBackend(fn)
        s = EnsembleSampler(8, 2, _scipy_lnprob, seed=40, backend=be)
        s.run_mcmc(np.zeros((8, 2)), 3)
        assert be.load_state()["rng_state"] is not None
        s2 = EnsembleSampler(8, 2, _jax_lnprob, seed=41,
                             backend=backends.HDFBackend(fn))
        s2.run_mcmc(None, 3)
        payload = backends.HDFBackend(fn).load_state()
        assert payload["rng_state"] is None and payload["key_data"] is not None
