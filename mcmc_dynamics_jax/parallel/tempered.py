"""Mesh-sharded parallel tempering: one temperature per device, swaps between devices.

Replica exchange is the natural fit for a device mesh: each rank of a ``tp`` axis
holds ONE temperature's full walker ensemble and advances it with the model's
fastest *batched* likelihood tier (sufficient tables / fused kernels —
the same per-device code path as a single-device run, so per-device throughput
is unchanged).  The only communication is the replica swap: adjacent temperatures
exchange (coords, lnP) through a single ``jax.lax.ppermute`` neighbour shift —
a nearest-neighbour pattern without any all-to-all.

Swap scheme: alternating even-odd phases (phase 0 pairs (0,1)(2,3)..., phase 1
pairs (1,2)(3,4)...), the standard parallelisation of the sequential
adjacent-pair sweep used by the single-device sampler
(sampler/tempered.py:118-133).  Both ranks of a pair draw the SAME acceptance
uniforms by folding the (replicated) swap key with the pair id, so the two
sides always agree on the outcome with zero extra communication.

The power-posterior convention matches the single-device sampler: level k
targets ``beta_k * lnP`` and the per-level run-mean of the UNtempered lnP
feeds the same thermodynamic-integration ``log_evidence``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..sampler.stretch import normalize_move, propose_mixture
from ..sampler.tempered import TemperedResult, TemperedState, make_beta_ladder
from .distributed import fetch, mesh_spans_processes, to_global

__all__ = ["run_tempered_sharded"]

# compiled ladder programs keyed by (runner, tier, mesh, shapes, ...); same
# rationale as parallel/sharded.py: shard_map caches on function identity,
# so chunked ladder runs would otherwise recompile the scan per chunk
_PROGRAM_CACHE: dict = {}


def run_tempered_sharded(runner, coords, key, n_steps: int, mesh: Mesh,
                         temp_axis: str = "tp", beta_min: float = 1e-3,
                         a: float = 2.0, swap_every: int = 1,
                         move="stretch", step0: int = 0,
                         log_prob0=None) -> TemperedResult:
    """Advance a temperature-sharded tempered ensemble ``n_steps`` steps.

    ``coords``: (W, P) starting positions (replicated to every temperature, as
    in :func:`sampler.tempered.init_tempered`), or (n_temps, W, P) —
    a prior run's ``result.final.coords`` — to RESUME the ladder: each
    temperature continues from its own walkers, and passing
    ``result.final.key`` continues the PRNG stream, so chunked runs match an
    uninterrupted one.  On resume, pass the state's ``log_prob`` (n_temps, W)
    as ``log_prob0`` so the carried IN-SCAN values continue bitwise — an
    eager recompute of the same coords can differ at the ULP under f32
    fusion and flip post-resume accepts (same rule as the ensemble
    checkpoints); without it the lnP is recomputed.  ``step0`` (a resumed
    state's ``final.step``) keeps the even-odd swap-phase sequence aligned
    when the completed step count is not an even multiple of
    ``swap_every``.  The ladder size
    equals the mesh's ``temp_axis`` extent; the star catalog is replicated
    per rank so each temperature runs the model's fastest batched tier
    locally.
    """
    if temp_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {temp_axis!r} (axes: {mesh.shape})")
    n_temps = mesh.shape[temp_axis]
    if n_temps < 2:
        raise ValueError("Need at least 2 temperatures (mesh axis size >= 2).")

    coords = jnp.asarray(coords, runner.dtype)
    resumed = coords.ndim == 3
    if resumed and coords.shape[0] != n_temps:
        raise ValueError(
            f"Resuming a tempered ladder requires the same tp extent: state "
            f"carries {coords.shape[0]} temperatures, mesh has tp={n_temps}.")
    n_walkers, ndim = coords.shape[-2:]
    if n_walkers % 2:
        raise ValueError("Number of walkers must be even.")
    half = n_walkers // 2
    coords_spec = P(temp_axis) if resumed else P()
    carry_lnp = resumed and log_prob0 is not None
    if carry_lnp:
        log_prob0 = jnp.asarray(log_prob0, coords.dtype)
        if log_prob0.shape != (n_temps, n_walkers):
            raise ValueError(
                f"log_prob0 must be (n_temps, n_walkers) = "
                f"{(n_temps, n_walkers)}, got {log_prob0.shape}.")

    betas = jnp.asarray(make_beta_ladder(n_temps, beta_min), coords.dtype)
    moves = normalize_move(move)
    # identity-stable tier: the shard_map program below is cached on it
    batched_lnprob = runner._batched_lnprob_cached()

    # process-spanning (multi-host) meshes: inputs become global arrays —
    # the ladder sharded over tp, starting ensemble and key replicated
    if mesh_spans_processes(mesh):
        from .sharded import _globalize_key

        betas = to_global(mesh, P(temp_axis), fetch(betas))
        coords = to_global(mesh, coords_spec, fetch(coords))
        if carry_lnp:
            log_prob0 = to_global(mesh, P(temp_axis), fetch(log_prob0))
        key = _globalize_key(key, mesh, P())

    # even-odd phase pairings as static ppermute permutations
    def _phase_perm(phase):
        perm = []
        for k in range(n_temps):
            partner = k + 1 if (k - phase) % 2 == 0 else k - 1
            if 0 <= partner < n_temps:
                perm.append((k, partner))
        return tuple(perm)

    perms = (_phase_perm(0), _phase_perm(1))

    in_specs = (P(temp_axis), coords_spec, P(), P()) \
        + ((P(temp_axis),) if carry_lnp else ())
    # per-level outputs carry the ladder on their leading axis; the cold
    # trajectory and the advanced key are replicated (P()) — the trajectory is
    # masked to rank 0 and psum'd so the host never gathers the 7 unused
    # levels' chains (n_temps x chain memory), and the key is identical on
    # every rank by construction
    out_specs = (P(temp_axis), P(temp_axis), P(temp_axis), P(), P(),
                 P(temp_axis), P(temp_axis), P())

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def sharded_run(betas_local, coords0, key, step_offset, *lnp0_in):
        k_idx = jax.lax.axis_index(temp_axis)
        beta = betas_local[0]
        if resumed:
            coords0 = coords0[0]   # this rank's temperature block (1, W, P)
        if carry_lnp:
            # continue the IN-SCAN lnP carried by the checkpoint: a top-level
            # recompute of the same coords is not guaranteed to fuse
            # identically to the half_update call and can flip post-resume
            # accepts at the ULP level (same rule as the ensemble resume)
            lnp0 = lnp0_in[0][0]
        else:
            lnp0 = batched_lnprob(coords0)

        def half_update(active, active_lnp, other, subkey):
            # shared proposal machinery at inverse temperature beta
            # (sampler/tempered.py _tempered_half): ln_bias + beta dlnP
            proposals, ln_bias, ln_u = propose_mixture(moves, active, other,
                                                       subkey, a)
            new_lnp = batched_lnprob(proposals)
            ln_accept = ln_bias + beta * (new_lnp - active_lnp)
            accept = (ln_u < ln_accept) & jnp.isfinite(new_lnp)
            return (jnp.where(accept[:, None], proposals, active),
                    jnp.where(accept, new_lnp, active_lnp), accept)

        def do_swap(c, lnp, k_swap, phase):
            # neighbour exchange; both pair members draw identical
            # uniforms from the pair-id-folded (replicated) swap key
            partner = k_idx + jnp.where((k_idx - phase) % 2 == 0, 1, -1)
            valid = (partner >= 0) & (partner < n_temps)
            lnp_p, beta_p, c_p = jax.lax.cond(
                phase == 0,
                lambda args: tuple(jax.lax.ppermute(x, temp_axis, perms[0])
                                   for x in args),
                lambda args: tuple(jax.lax.ppermute(x, temp_axis, perms[1])
                                   for x in args),
                (lnp, beta, c))
            pair_id = jnp.minimum(k_idx, partner)
            u = jax.random.uniform(jax.random.fold_in(k_swap, pair_id),
                                   (n_walkers,), dtype=c.dtype)
            ln_alpha = (beta - beta_p) * (lnp_p - lnp)
            sw = (jnp.log(u) < ln_alpha) & valid
            c_new = jnp.where(sw[:, None], c_p, c)
            lnp_new = jnp.where(sw, lnp_p, lnp)
            # count each pair once: on its lower member
            n_sw = jnp.sum(sw & (k_idx < partner), dtype=jnp.int32)
            return c_new, lnp_new, n_sw

        def body(carry, step_idx):
            c, lnp, k_common, acc, swaps = carry
            k_common, k_move, k_swap = jax.random.split(k_common, 3)
            # distinct move streams per temperature, common swap stream
            k0, k1 = jax.random.split(jax.random.fold_in(k_move, k_idx))
            cA, pA, aA = half_update(c[:half], lnp[:half], c[half:], k0)
            cB, pB, aB = half_update(c[half:], lnp[half:], cA, k1)
            c = jnp.concatenate([cA, cB])
            lnp = jnp.concatenate([pA, pB])
            acc = acc + jnp.concatenate([aA, aB]).astype(jnp.int32)

            # phase counts SWAP ROUNDS, not raw steps: with an even swap_every
            # a raw step_idx % 2 phase would be pinned and half the pairs
            # (including the cold pair) would never exchange.  The GLOBAL
            # step (step_offset + step_idx) drives both the swap timing and
            # the phase, so a resumed chunk continues the exact sequence an
            # uninterrupted run would follow.
            g = step_offset + step_idx
            c, lnp, n_sw = jax.lax.cond(
                (g % swap_every) == swap_every - 1,
                lambda args: do_swap(args[0], args[1], k_swap,
                                     (g // swap_every) % 2),
                lambda args: (args[0], args[1], jnp.zeros((), jnp.int32)),
                (c, lnp))
            swaps = swaps + n_sw
            # emit the trajectory pre-masked to the cold rank: the psum below
            # then needs no extra masked temporary of the full chain.
            # select(), not multiply: a -inf lnP on a hot rank times 0 is NaN
            cold = k_idx == 0
            return ((c, lnp, k_common, acc, swaps),
                    (jnp.where(cold, c, 0.0), jnp.where(cold, lnp, 0.0),
                     jnp.mean(lnp)))

        init = (coords0, lnp0, key, jnp.zeros(n_walkers, jnp.int32),
                jnp.zeros((), jnp.int32))
        (c_fin, lnp_fin, k_fin, acc, swaps), (traj_c, traj_lnp, lnp_means) = \
            jax.lax.scan(body, init, jnp.arange(n_steps))
        traj_c = jax.lax.psum(traj_c, temp_axis)
        traj_lnp = jax.lax.psum(traj_lnp, temp_axis)
        k_out = (jax.random.key_data(k_fin)
                 if jnp.issubdtype(k_fin.dtype, jax.dtypes.prng_key)
                 else k_fin)  # legacy uint32 keys pass through unchanged
        return (c_fin[None], lnp_fin[None], jnp.mean(lnp_means)[None],
                traj_c, traj_lnp, acc[None], swaps[None], k_out)

    _ = runner.compiled  # refresh the parameter fingerprint for the cache key
    cache_key = (runner, runner._compiled_fp, batched_lnprob, mesh, temp_axis,
                 n_temps, moves, float(a), int(swap_every), int(n_steps),
                 n_walkers, ndim, bool(resumed), bool(carry_lnp),
                 str(runner.dtype))
    cached = _PROGRAM_CACHE.pop(cache_key, None)
    if cached is not None:
        sharded_run = cached     # reuse the compiled program across chunks
    elif len(_PROGRAM_CACHE) >= 8:
        # LRU-pop one entry (clearing all would recompile every ladder
        # program in a loop alternating 9 configurations)
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    _PROGRAM_CACHE[cache_key] = sharded_run   # (re-)insert at MRU position

    step0 = int(step0)
    step_arr = jnp.asarray(step0, jnp.int32)
    if mesh_spans_processes(mesh):
        step_arr = to_global(mesh, P(), np.asarray(step0, np.int32))
    extra = (log_prob0,) if carry_lnp else ()
    (c_fin, lnp_fin, mean_lnp, traj_c, traj_lnp, acc,
     swaps, key_data) = sharded_run(betas, coords, key, step_arr, *extra)

    # host-side assembly mirrors sampler.tempered.run_tempered; the advanced
    # key (identical on every rank — swaps/moves fold a shared stream) makes
    # res.final a valid resume point
    final_key = jax.random.wrap_key_data(
        key_data, impl=str(jax.random.key_impl(key))) \
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) else key_data
    chain = jnp.swapaxes(traj_c, 0, 1)             # cold chain (W, S, P)
    log_prob = jnp.swapaxes(traj_lnp, 0, 1)
    # pair (k, k+1) is active when the swap-round parity equals k % 2; count
    # the phase-0/phase-1 rounds that actually fell inside this chunk's
    # global step window [step0, step0 + n_steps)
    se = max(swap_every, 1)
    first_swap = step0 + ((se - 1 - step0) % se)
    n_even = sum(1 for s in range(first_swap, step0 + n_steps, se)
                 if (s // se) % 2 == 0)
    n_rounds = len(range(first_swap, step0 + n_steps, se))
    pair_idx = np.arange(n_temps - 1)
    attempts = np.where(pair_idx % 2 == 0, n_even, n_rounds - n_even)
    attempts = np.maximum(attempts * n_walkers, 1)
    final = TemperedState(
        coords=c_fin, log_prob=lnp_fin, key=final_key,
        accepted=acc, swaps_accepted=swaps[:-1],
        step=jnp.asarray(step0 + n_steps, jnp.int32))
    return TemperedResult(
        chain=chain, log_prob=log_prob,
        mean_lnp_by_beta=mean_lnp,
        final=final,
        acceptance_fraction=acc / max(n_steps, 1),
        swap_acceptance=swaps[:-1] / jnp.asarray(attempts, chain.dtype))
