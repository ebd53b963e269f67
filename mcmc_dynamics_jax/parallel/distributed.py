"""Multi-host execution: one SPMD program per host, the network between hosts.

The reference scales by forking process pools on one machine
(reference runner.py:398-401, axisymmetric.py:391-397); the JAX-native
equivalent (SURVEY §2.6) is multi-controller SPMD: every host runs the same
script, :func:`initialize` wires the processes into one JAX runtime, meshes
span all hosts' devices, collectives ride the device links (NVLink) within a
host and the network between hosts.  This module holds the host-boundary plumbing that makes the existing
single-process code multi-host clean:

* :func:`initialize` — ``jax.distributed.initialize`` wrapper (idempotent,
  env-var driven defaults, no-op for single-process runs);
* :func:`global_mesh` — a mesh over **all** processes' devices;
* :func:`to_global` — turn a host-replicated numpy array into a global
  ``jax.Array`` laid out for a given ``PartitionSpec`` (each process feeds
  only its addressable shards — the per-process data feeding for sp-sharding);
* :func:`fetch` — the inverse: gather any (possibly non-addressable) global
  array back to a host numpy array on every process;
* :func:`is_primary` / :func:`barrier` — leader-only checkpoint discipline.

Everything degrades to a no-op/thin-wrapper in a single-process session, so
library code can call these helpers unconditionally.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh

logger = logging.getLogger(__name__)

__all__ = ["initialize", "shutdown", "is_distributed", "is_primary",
           "global_mesh", "to_global", "fetch", "barrier",
           "mesh_spans_processes", "checkpoint_dir_is_shared"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, auto: bool = False, **kwargs) -> bool:
    """Wire this process into a multi-host JAX runtime.

    Call once at program start on every host, before any other JAX API.  With
    no arguments the values come from the standard JAX environment variables
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``);
    absent those, it is a no-op and the session stays single-process.  On a
    managed cluster JAX can detect, pass ``auto=True`` to let JAX's cluster
    detection supply everything.

    Returns True when a multi-process runtime was (or already is) active,
    False for a plain single-process session.  Idempotent: a second call is a
    no-op.
    """
    if jax.distributed.is_initialized():
        return jax.process_count() > 1

    env_addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_n = os.environ.get("JAX_NUM_PROCESSES")
    env_id = os.environ.get("JAX_PROCESS_ID")
    coordinator_address = coordinator_address or env_addr
    if num_processes is None and env_n is not None:
        num_processes = int(env_n)
    if process_id is None and env_id is not None:
        process_id = int(env_id)

    if coordinator_address is None and not auto:
        if num_processes not in (None, 1):
            raise ValueError(
                "num_processes > 1 requires a coordinator_address "
                "(host:port of process 0).")
        return False  # single-process session; nothing to initialize

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids, **kwargs)
    logger.info("jax.distributed initialized: process %d/%d, %d local / %d "
                "global devices", jax.process_index(), jax.process_count(),
                jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def shutdown() -> None:
    """Tear down the distributed runtime (tests / clean exits)."""
    if jax.distributed.is_initialized():
        jax.distributed.shutdown()


def is_distributed() -> bool:
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that owns checkpoint/log writes (process 0)."""
    return jax.process_index() == 0


def global_mesh(axis_names: Sequence[str] = ("dp", "sp"),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every device of every process.

    ``jax.devices()`` already enumerates all processes' devices in a
    consistent order, so this is :func:`~.mesh.make_mesh` — the point of the
    alias is the contract: the returned mesh is identical on every process
    and its collectives cross the process boundary.
    """
    return make_mesh(axis_names, shape=shape, devices=jax.devices())


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when ``mesh`` contains devices this process cannot address."""
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def to_global(mesh: Mesh, spec: P, host_array) -> jax.Array:
    """Host-replicated numpy -> global ``jax.Array`` sharded per ``spec``.

    Every process passes the SAME full array (the natural fit for star
    catalogs, walker ensembles and moment tables, which are host-resident
    everywhere); each process materialises only the shards its local devices
    own, so device memory per chip stays 1/N for sharded axes.  Works
    unchanged in single-process sessions (where it is just a device_put).
    """
    arr = np.asarray(host_array)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def fetch(value) -> np.ndarray:
    """Any (possibly non-addressable) ``jax.Array`` -> host numpy, everywhere.

    The multi-host-safe replacement for ``np.asarray(device_array)``: arrays
    produced under a process-spanning mesh have shards this host cannot see,
    so they are first all-gathered (one jitted identity with replicated
    output — the collective crosses the process boundary), then read out
    locally.
    """
    if isinstance(value, jax.Array) and not value.is_fully_addressable:
        mesh = getattr(value.sharding, "mesh", None)
        if mesh is None or not isinstance(mesh, Mesh):
            # not a NamedSharding (e.g. a GSPMD sharding from an eager op on
            # global arrays): rebuild a trivial mesh over the array's devices
            devs = sorted(value.sharding.device_set, key=lambda d: d.id)
            mesh = Mesh(np.asarray(devs), ("_fetch",))
        replicated = _replicating_gather(mesh)(value)
        return np.asarray(replicated.addressable_data(0))
    return np.asarray(value)


@functools.lru_cache(maxsize=None)
def _replicating_gather(mesh: Mesh):
    """One jitted identity-gather per mesh, reused across fetch() calls.

    A fresh ``jax.jit(lambda x: x, ...)`` per call would defeat the pjit
    cache (new function identity every time) and re-trace/re-compile the
    all-gather for every array fetched — several times per chunk in the
    sharded sampling loop.  Cached here, only the first fetch per
    (mesh, shape/dtype) compiles."""
    return jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))


def checkpoint_dir_is_shared(prefix: str) -> bool:
    """True when every process sees every process's files under ``prefix``.

    The shard-file checkpoint path (``Runner.save_current_status_shards``)
    requires the checkpoint directory to be shared storage — the standard pod
    setup, but not guaranteed (each host may be chdir'd into its own scratch
    dir).  Probe-file handshake, run ONCE before a checkpointed multi-host
    loop: every process drops a marker, a barrier fences the writes, each
    checks it can see all markers, and a tiny all-gather forms the consensus
    (visibility can be asymmetric).  Single-process sessions are trivially
    shared."""
    if jax.process_count() <= 1:
        return True
    import pathlib

    from jax.experimental import multihost_utils

    me, n = jax.process_index(), jax.process_count()
    probe = pathlib.Path(f"{prefix}.ckptprobe.{me}")
    # the write must NOT raise out of the handshake: every process has to
    # reach the barrier/all-gather below or the rest of the pod wedges in
    # the collective — an unwritable directory on one host just means "not
    # shared", i.e. fall back to the replicating checkpoint path
    try:
        probe.write_text("probe")
        ok = True
    except OSError:
        ok = False
    barrier("ckpt-probe-write")
    ok = ok and all(pathlib.Path(f"{prefix}.ckptprobe.{q}").exists()
                    for q in range(n))
    oks = multihost_utils.process_allgather(np.asarray([ok]))
    # process_allgather returns only after every process contributed, i.e.
    # after every process finished its exists() sweep — safe to unlink
    try:
        probe.unlink()
    except OSError:
        pass
    shared = bool(np.all(oks))
    if not shared:
        logger.warning(
            "checkpoint directory for prefix %r is NOT shared across the %d "
            "processes; falling back to the replicating-gather checkpoint "
            "path (per-chunk DCN traffic scales with the chain — put "
            "checkpoints on shared storage to avoid it).", prefix, n)
    return shared


def barrier(name: str = "mcmc_dynamics_jax") -> None:
    """Block until every process reaches this point (no-op single-process).

    Use around leader-only filesystem work: non-primary processes must not
    race ahead and read a checkpoint the primary is still writing.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
