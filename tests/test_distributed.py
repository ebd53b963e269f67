"""Multi-host (jax.distributed) layer: helpers + an honest two-process run.

The two-process test launches real subprocesses that rendezvous through
``jax.distributed.initialize`` on localhost (CPU backend, Gloo collectives) —
the closest thing to a pod the sandbox offers (SURVEY §2.6: reference
runner.py:398-401 fork pools -> multi-controller SPMD over DCN).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mcmc_dynamics_jax.parallel import (barrier, fetch, is_distributed,
                                        is_primary, make_mesh, to_global)
from mcmc_dynamics_jax.parallel import distributed as dist

REPO = pathlib.Path(__file__).resolve().parents[1]


class TestSingleProcessDegradation:
    """Every helper must be a clean no-op/thin-wrapper without a cluster."""

    def test_initialize_without_coordinator_is_noop(self):
        assert dist.initialize() is False
        assert not is_distributed()
        assert is_primary()

    def test_initialize_rejects_inconsistent_args(self):
        with pytest.raises(ValueError, match="coordinator_address"):
            dist.initialize(num_processes=2)

    def test_to_global_fetch_roundtrip(self):
        mesh = make_mesh(("dp", "sp"), (4, 2))
        host = np.arange(24.0).reshape(8, 3)
        arr = to_global(mesh, P("dp", None), host)
        assert isinstance(arr, jax.Array)
        assert arr.sharding.spec == P("dp", None)
        np.testing.assert_array_equal(fetch(arr), host)
        # replicated spec too
        rep = to_global(mesh, P(), host)
        np.testing.assert_array_equal(fetch(rep), host)

    def test_fetch_passthrough_plain_arrays(self):
        np.testing.assert_array_equal(fetch(np.arange(3.0)), np.arange(3.0))
        np.testing.assert_array_equal(fetch(jnp.arange(3.0)), np.arange(3.0))

    def test_barrier_noop(self):
        barrier("test")  # must not raise

    def test_mesh_spans_processes_false_locally(self):
        mesh = make_mesh(("dp",), (8,))
        assert dist.mesh_spans_processes(mesh) is False


class TestCheckpointDirHandshake:
    """checkpoint_dir_is_shared's probe logic, with the collectives stubbed
    (the real two-process path is exercised by TestShardedCheckpoint).  The
    contract under test: every process ALWAYS reaches the barrier/all-gather
    — an unwritable directory on one host must yield False (fall back to the
    replicating checkpoint), never an exception that wedges the pod."""

    def _stub(self, monkeypatch, me=0, n=2):
        import jax
        from jax.experimental import multihost_utils
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda: me)
        monkeypatch.setattr(dist, "barrier", lambda name="": None)
        monkeypatch.setattr(multihost_utils, "process_allgather",
                            lambda a: np.concatenate([a, a]))

    def test_single_process_trivially_shared(self, tmp_path):
        assert dist.checkpoint_dir_is_shared(str(tmp_path / "ck")) is True

    def test_all_probes_visible_is_shared(self, monkeypatch, tmp_path):
        self._stub(monkeypatch)
        prefix = str(tmp_path / "ck")
        (tmp_path / "ck.ckptprobe.1").write_text("probe")   # peer's marker
        assert dist.checkpoint_dir_is_shared(prefix) is True
        # own probe cleaned up afterwards
        assert not (tmp_path / "ck.ckptprobe.0").exists()

    def test_missing_peer_probe_not_shared(self, monkeypatch, tmp_path):
        self._stub(monkeypatch)
        assert dist.checkpoint_dir_is_shared(str(tmp_path / "ck")) is False

    def test_unwritable_dir_degrades_not_crashes(self, monkeypatch, tmp_path):
        self._stub(monkeypatch)
        prefix = str(tmp_path / "does-not-exist" / "ck")
        assert dist.checkpoint_dir_is_shared(prefix) is False


_WORKER = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_ENABLE_X64"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])

    from mcmc_dynamics_jax.parallel import distributed as dist
    assert dist.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid) is True
    assert dist.is_distributed()
    assert dist.is_primary() == (pid == 0)
    assert jax.device_count() == 2 * nproc

    import numpy as np
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.models import ConstantFit
    from mcmc_dynamics_jax.parallel import run_ensemble_sharded
    from mcmc_dynamics_jax.utils import DataReader

    RA_C, DEC_C = 56.345, -26.675
    rng = np.random.default_rng(0)
    n = 333
    data = DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
    })
    params = ConstantFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    fit = ConstantFit(data, parameters=params)

    # dp x sp mesh spanning both processes (4 global devices)
    mesh = dist.global_mesh(("dp", "sp"), (2, 2))
    assert dist.mesh_spans_processes(mesh)

    pos = fit.get_initials(8)
    res = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(7), n_steps=6,
                               mesh=mesh)
    chain = dist.fetch(res.chain)
    lnp = dist.fetch(res.log_prob)
    acc = dist.fetch(res.accepted)
    assert chain.shape == (8, 6, 4)
    assert np.isfinite(lnp).all()

    # checkpoint discipline: every process participates in the gather,
    # only the primary writes
    from mcmc_dynamics_jax.models.base import Runner
    from mcmc_dynamics_jax.sampler import EnsembleState
    import jax.numpy as jnp
    state = EnsembleState(coords=res.final_coords, log_prob=res.final_log_prob,
                          key=res.final_key,
                          accepted=jnp.asarray(acc), step=jnp.asarray(6))
    os.chdir(outdir)
    Runner.save_current_status_arrays(chain, lnp, state, prefix="dist")

    # temperature-parallel ladder over the same two hosts (tp x 4)
    from mcmc_dynamics_jax.parallel import run_tempered_sharded
    tp_mesh = dist.global_mesh(("tp",), (4,))
    tres = run_tempered_sharded(fit, fit.get_initials(8), jax.random.PRNGKey(3),
                                n_steps=4, mesh=tp_mesh, swap_every=2)
    tchain = dist.fetch(tres.chain)
    assert tchain.shape == (8, 4, 4)

    # batched per-bin pipeline with the bin axis sharded across both hosts
    from mcmc_dynamics_jax.pipelines import fit_radial_bins
    bin_mesh = dist.global_mesh(("dp",), (4,))
    bres = fit_radial_bins(data, u.Quantity(RA_C, "deg"),
                           u.Quantity(DEC_C, "deg"), nstars=60, dlogr=0.01,
                           n_walkers=8, n_steps=10, seed=4, mesh=bin_mesh)
    assert np.isfinite(bres.log_probs).all()

    np.savez(os.path.join(outdir, f"worker{pid}.npz"),
             chain=chain, lnp=lnp, acc=acc, tchain=tchain,
             bchains=bres.chains)
    dist.barrier("done")
    print(json.dumps({"pid": pid, "ok": True}))
""")


class TestTwoProcessLocalhost:
    def test_two_process_sharded_run_agrees(self, tmp_path):
        """Two real processes, one global dp x sp mesh, identical results on
        both hosts; checkpoint written by the primary only."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

        worker = tmp_path / "worker.py"
        worker.write_text(_WORKER)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(pid), "2", str(port),
                 str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
        for rc, out, err in outs:
            assert rc == 0, f"worker failed:\nstdout:{out}\nstderr:{err}"
            assert json.loads(out.strip().splitlines()[-1])["ok"]

        w0 = np.load(tmp_path / "worker0.npz")
        w1 = np.load(tmp_path / "worker1.npz")
        # both hosts fetched the same global chain
        np.testing.assert_array_equal(w0["chain"], w1["chain"])
        np.testing.assert_array_equal(w0["lnp"], w1["lnp"])
        np.testing.assert_array_equal(w0["acc"], w1["acc"])
        # ... and the same tempered cold chain (tp ladder across both hosts)
        np.testing.assert_array_equal(w0["tchain"], w1["tchain"])
        assert np.isfinite(w0["tchain"]).all()
        # ... and the same bin-sharded pipeline chains
        np.testing.assert_array_equal(w0["bchains"], w1["bchains"])
        assert np.isfinite(w0["bchains"]).all()
        assert np.isfinite(w0["lnp"]).all()
        # some proposals accepted in 6 steps of 8 walkers
        assert w0["acc"].sum() > 0

        # primary-only checkpoint write
        assert (tmp_path / "dist_chain.npz").exists()
        with np.load(tmp_path / "dist_chain.npz") as ck:
            np.testing.assert_array_equal(ck["chain"], w0["chain"])

        # the distributed run must equal the same mesh shape run inside ONE
        # process (the virtual 8-device mesh): same dp folding, same psum
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ConstantFit
        from mcmc_dynamics_jax.parallel import run_ensemble_sharded
        from mcmc_dynamics_jax.utils import DataReader

        ra_c, dec_c = 56.345, -26.675
        rng = np.random.default_rng(0)
        n = 333
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.03 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.03 * rng.normal(size=n), "deg"),
            "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ConstantFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        fit = ConstantFit(data, parameters=params)
        mesh = make_mesh(("dp", "sp"), (2, 2), devices=jax.devices()[:4])
        pos = fit.get_initials(8)
        ref = run_ensemble_sharded(fit, pos, jax.random.PRNGKey(7), n_steps=6,
                                   mesh=mesh)
        np.testing.assert_allclose(w0["chain"], np.asarray(ref.chain),
                                   rtol=1e-12, atol=0)


_SHARD_CKPT_WORKER = textwrap.dedent("""
    import json, os, pathlib, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_ENABLE_X64"] = "1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])

    from mcmc_dynamics_jax.parallel import distributed as dist
    assert dist.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid) is True

    import numpy as np
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.models import ConstantFit
    from mcmc_dynamics_jax.utils import DataReader

    RA_C, DEC_C = 56.345, -26.675
    rng = np.random.default_rng(0)
    n = 222
    data = DataReader({
        "ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
        "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
        "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
        "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
    })
    params = ConstantFit.default_parameters()
    params["ra_center"].set(value=RA_C, fixed=True)
    params["dec_center"].set(value=DEC_C, fixed=True)
    fit = ConstantFit(data, parameters=params, seed=11)
    mesh = dist.global_mesh(("dp", "sp"), (2, 2))
    assert dist.mesh_spans_processes(mesh)
    pos = fit.get_initials(8)
    os.chdir(outdir)

    # spy on the replicating gather: the shard-checkpoint run must never
    # fetch anything chain-shaped (3-D) — that is the per-chunk DCN traffic
    # VERDICT r4 #10 bans.  (sharded.py binds fetch at module import, but its
    # uses are keys/coords/catalog columns only; the checkpoint path imports
    # per call, so the spy sees it.)
    gathered = []
    orig_fetch = dist.fetch
    def spy_fetch(v):
        if isinstance(v, jax.Array) and not v.is_fully_addressable:
            gathered.append(tuple(v.shape))
        return orig_fetch(v)
    dist.fetch = spy_fetch
    res = fit(n_walkers=8, n_steps=12, n_out=4, n_burn=0, pos=pos,
              prefix="shardckpt", mesh=mesh)
    dist.fetch = orig_fetch
    assert all(len(s) < 3 for s in gathered), gathered
    # ... and nothing step-resolved either: the largest gathered object is a
    # (W, K) coords/acceptance-sized piece, NOT a (W, steps) history
    assert all(s[-1] <= 8 or len(s) == 1 for s in gathered), gathered

    # canonical checkpoint exists, per-process shard files were cleaned up
    assert pathlib.Path("shardckpt_chain.npz").exists()
    leftovers = list(pathlib.Path(".").glob("shardckpt_chain.shard*"))
    assert not leftovers, leftovers
    with np.load("shardckpt_chain.npz") as ck:
        np.testing.assert_array_equal(ck["chain"], res.chain)
        np.testing.assert_array_equal(ck["lnprob"], res.lnprobability)
        assert int(ck["step"]) == 12

    # the shard-checkpoint path must not perturb sampling: identical chain to
    # the replicating (prefix=None) path, same seed/pos/mesh
    res2 = fit(n_walkers=8, n_steps=12, n_out=4, n_burn=0, pos=pos,
               prefix=None, mesh=mesh)
    np.testing.assert_array_equal(res.chain, res2.chain)

    # bitwise resume THROUGH the shard-assembled checkpoint: 12 + 6 more
    state = fit.load_state("shardckpt_chain.npz")
    res3 = fit(n_steps=6, n_out=3, n_burn=0, state=state,
               prefix="shardckpt2", mesh=mesh)
    res_full = fit(n_walkers=8, n_steps=18, n_out=6, n_burn=0, pos=pos,
                   prefix=None, mesh=mesh)
    np.testing.assert_array_equal(res3.chain,
                                  res_full.chain[:, 12:, :])

    np.savez(f"shardw{pid}.npz", chain=res.chain, lnp=res.lnprobability)
    dist.barrier("done")
    print(json.dumps({"pid": pid, "ok": True}))
""")


class TestShardedCheckpoint:
    def test_two_process_shard_checkpoint(self, tmp_path):
        """Multi-host checkpointing writes per-process dp-block shard files
        and assembles the canonical .npz on the primary (VERDICT r4 #10): no
        chain-shaped array ever crosses the replicating gather, sampling is
        bit-identical to the replicating path, and resume through the
        assembled checkpoint is bitwise."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

        worker = tmp_path / "shard_worker.py"
        worker.write_text(_SHARD_CKPT_WORKER)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(pid), "2", str(port),
                 str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
        for rc, out, err in outs:
            assert rc == 0, f"worker failed:\nstdout:{out}\nstderr:{err}"
            assert json.loads(out.strip().splitlines()[-1])["ok"]

        # both hosts ended with the identical full chain (read back from the
        # canonical checkpoint — the filesystem, not DCN, replicates it)
        w0 = np.load(tmp_path / "shardw0.npz")
        w1 = np.load(tmp_path / "shardw1.npz")
        np.testing.assert_array_equal(w0["chain"], w1["chain"])
        np.testing.assert_array_equal(w0["lnp"], w1["lnp"])
        assert np.isfinite(w0["lnp"]).all()


_CLI_WORKER = textwrap.dedent("""
    import json, os, pathlib, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_ENABLE_X64"] = "1"
    os.environ["MPLBACKEND"] = "Agg"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    workdir = pathlib.Path(outdir) / f"proc{pid}"
    workdir.mkdir(exist_ok=True)
    os.chdir(workdir)

    cfg = {
        "prefix": "clidist",
        "data": {"file": os.path.join(outdir, "catalog.csv"),
                  "format": "csv"},
        "model": "constant",
        "parameters": {"ra_center": {"value": 56.345, "fixed": True},
                        "dec_center": {"value": -26.675, "fixed": True}},
        "sampling": {"n_walkers": 8, "n_steps": 20, "n_out": 20,
                      "n_burn": 5, "seed": 1},
        "parallel": {"axes": {"dp": 4},
                      "distributed": {"coordinator": f"localhost:{port}",
                                       "num_processes": nproc,
                                       "process_id": pid}},
    }
    pathlib.Path("cfg.json").write_text(json.dumps(cfg))

    # The regression this guards: cli.run.main must wire the distributed
    # runtime BEFORE any JAX computation (catalog load / model build), or
    # jax.distributed.initialize raises RuntimeError.
    from mcmc_dynamics_jax.cli.run import main
    rc = main(["cfg.json", "--skip-binned", "--skip-profiles"])
    assert rc == 0
    assert jax.process_count() == nproc
    print(json.dumps({"pid": pid, "ok": True}))
""")


class TestDistributedCli:
    def test_cli_distributed_block_two_processes(self, tmp_path):
        """The production driver brings up jax.distributed from the config's
        parallel.distributed block and samples over the global dp mesh."""
        rng = np.random.default_rng(0)
        n = 200
        ra_c, dec_c = 56.345, -26.675
        lines = ["ra,dec,v,verr"]
        for i in range(n):
            lines.append(f"{ra_c + 0.03 * rng.normal()},"
                         f"{dec_c + 0.03 * rng.normal()},"
                         f"{5.0 * rng.normal()},{0.5 + 0.5 * rng.random()}")
        (tmp_path / "catalog.csv").write_text("\n".join(lines) + "\n")

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]

        worker = tmp_path / "cli_worker.py"
        worker.write_text(_CLI_WORKER)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(pid), "2", str(port),
                 str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            for pid in (0, 1)
        ]
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
        for rc, out, err in outs:
            assert rc == 0, f"cli worker failed:\nstdout:{out}\nstderr:{err}"
            assert json.loads(out.strip().splitlines()[-1])["ok"]

        # the sampled chain checkpoint exists where the run happened
        assert (tmp_path / "proc0" / "clidist_chain.npz").exists()
