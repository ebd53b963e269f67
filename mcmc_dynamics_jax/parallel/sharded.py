"""Multi-device SPMD sampling: walkers over ``dp``, stars over ``sp``.

The honest scaling axes of this workload (SURVEY.md §2.6) are:

* **walkers** — the data-parallel analog.  The ensemble is sharded over the ``dp``
  mesh axis; stretch-move partner selection needs the complementary half-ensemble,
  which is ``all_gather``-ed over ``dp`` (W/2 x K floats — tiny);
* **stars** — the context/sequence-parallel analog.  Each device holds a slice of the
  catalog; per-star likelihood terms are reduced locally and ``psum``-ed over ``sp``;
* **radial bins** — independent posteriors batched per chip (handled by vmap +
  sharding annotations in the pipelines module, not here).

Everything runs inside one ``shard_map``-wrapped ``lax.scan``: no host round-trips,
collectives run on the device mesh.  PRNG discipline: the per-device key is folded with the
``dp`` index only, so every ``sp`` rank in a dp-row traces an identical random stream
(they must agree on proposals since they hold the same walkers).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sampler.stretch import normalize_move, propose_mixture
from .distributed import fetch, mesh_spans_processes, to_global

__all__ = ["pad_star_axis", "star_sharded_lnprob", "run_ensemble_sharded",
           "ShardedResult"]

# compiled shard_map programs keyed by (runner, tiers, mesh, shapes, move, ...);
# shard_map/jit cache on FUNCTION IDENTITY, so rebuilding the closure per
# checkpoint chunk would retrace + recompile the whole n-step scan every
# n_out steps (the unsharded loop caches for the same reason —
# models/base.py _batched_lnprob_cached)
_PROGRAM_CACHE: Dict[tuple, Callable] = {}


def _globalize_key(key, mesh, spec):
    """Lay a PRNG key (typed or legacy uint32) out on a process-spanning mesh
    so it can feed a ``shard_map`` in_spec (replicated or per-dp-rank)."""
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        data = fetch(jax.random.key_data(key))
        gdata = to_global(mesh, spec, data)
        return jax.random.wrap_key_data(gdata, impl=jax.random.key_impl(key))
    return to_global(mesh, spec, fetch(key))


def pad_star_axis(data: Dict[str, jnp.ndarray], n_shards: int) -> Dict[str, jnp.ndarray]:
    """Pad all per-star arrays to a multiple of ``n_shards``; masked lanes are zero.

    A ``mask`` entry is created (or extended) so padded lanes contribute nothing to
    likelihood sums.
    """
    sizes = {v.shape[0] for v in data.values()}
    assert len(sizes) == 1, "All per-star arrays must share the star axis length."
    n = sizes.pop()
    n_pad = (-n) % n_shards
    out = {}
    for name, arr in data.items():
        if n_pad:
            pad_widths = [(0, n_pad)] + [(0, 0)] * (arr.ndim - 1)
            # pad with the first entry to keep padded lanes numerically benign
            fill = jnp.broadcast_to(arr[:1], (n_pad,) + arr.shape[1:])
            arr = jnp.concatenate([arr, fill], axis=0)
        out[name] = arr
    if "mask" in data:
        mask = out["mask"]
        if n_pad:
            mask = mask.at[n:].set(0.0)
        out["mask"] = mask
    else:
        mask = jnp.ones(n + n_pad, dtype=next(iter(data.values())).dtype)
        if n_pad:
            mask = mask.at[n:].set(0.0)
        out["mask"] = mask
    return out


def star_sharded_lnprob(runner, mesh: Mesh, sp_axis: str = "sp") -> Callable:
    """Build ``lnprob(theta)`` with the star catalog sharded over ``sp_axis``.

    Exact: equals the single-device lnprob up to float reduction order.
    ``theta`` is replicated; the per-star reduction is a local sum + ``psum``
    over ``sp``.  Works on process-spanning (multi-host) meshes too: the catalog
    is laid out globally once here, and each ``theta`` is globalized per call.
    """
    compiled = runner.compiled
    n_sp = mesh.shape[sp_axis]
    data = pad_star_axis(runner.prepare_data(dict(runner._data_arrays)), n_sp)
    data_names = sorted(data.keys())
    data_arrays = [data[k] for k in data_names]
    spans = mesh_spans_processes(mesh)
    if spans:
        data_arrays = [to_global(mesh, P(sp_axis), fetch(a))
                       for a in data_arrays]

    in_specs = (P(),) + tuple(P(sp_axis) for _ in data_arrays)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=P(),
             check_vma=False)
    def lnprob(theta, *shards):
        local = dict(zip(data_names, shards))
        lp = compiled.lnprior(theta)
        p = runner.scaled_values(theta)
        terms = runner.lnlike_terms(p, local)
        # select(), not multiply: -inf terms on padded lanes x 0 would be NaN
        ll = jax.lax.psum(jnp.sum(jnp.where(local["mask"] > 0, terms, 0.0)),
                          sp_axis)
        total = lp + runner.extra_lnprior_fn(p) + ll
        return jnp.where(jnp.isfinite(lp), total, -jnp.inf)

    if spans:
        return lambda theta: lnprob(
            to_global(mesh, P(), np.asarray(fetch(theta), runner.dtype)),
            *data_arrays)
    return lambda theta: lnprob(theta, *data_arrays)


def _build_sharded_run(runner, compiled, mesh, dp_axis, sp_axis, use_sp,
                       moves, a, n_steps, half_local, w_local, key_prefolded,
                       key_spec, star_spec, data_names, batched_tier,
                       partial_tier):
    """The shard_map SPMD scan program (see :func:`run_ensemble_sharded`).

    Built once per (runner, tiers, mesh, shapes, move) configuration and
    cached in ``_PROGRAM_CACHE``: shard_map caches compiled executables on
    the wrapped function's identity, so a fresh closure per checkpoint chunk
    would recompile the whole n-step scan every ``n_out`` steps.
    """
    in_specs = (P(dp_axis, None), key_spec) + tuple(star_spec
                                                    for _ in data_names)
    out_specs = (P(dp_axis, None), P(dp_axis), P(dp_axis),
                 P(None, dp_axis, None), P(None, dp_axis), P(dp_axis))

    lnprior_batched = jax.vmap(compiled.lnprior)
    extra_batched = jax.vmap(lambda t: runner.extra_lnprior_fn(
        runner.scaled_values(t)))

    def local_lnprob(theta, local):
        lp = compiled.lnprior(theta)
        p = runner.scaled_values(theta)
        terms = runner.lnlike_terms(p, local)
        # select(), not multiply: an invalid model's -inf terms on padded
        # lanes would otherwise produce -inf * 0 = NaN (cf. masked_sum)
        local_sum = jnp.sum(jnp.where(local["mask"] > 0, terms, 0.0))
        ll = jax.lax.psum(local_sum, sp_axis) if use_sp else local_sum
        total = lp + runner.extra_lnprior_fn(p) + ll
        return jnp.where(jnp.isfinite(lp), total, -jnp.inf)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
             check_vma=False)
    def sharded_run(coords_local, key, *shards):
        local = dict(zip(data_names, shards))
        dp_idx = jax.lax.axis_index(dp_axis)
        if key_prefolded:
            key = key[0]        # this rank's block of the stacked key array
        else:
            # identical stream across sp ranks of a dp row; distinct across dp
            key = jax.random.fold_in(key, dp_idx)

        if batched_tier is not None:
            batched_lnprob = batched_tier
        elif partial_tier is not None:
            def batched_lnprob(thetas):
                ll = jax.lax.psum(partial_tier(thetas, local), sp_axis)
                lp = lnprior_batched(thetas)
                total = lp + extra_batched(thetas) + ll
                return jnp.where(jnp.isfinite(lp), total, -jnp.inf)
        else:
            batched_lnprob = jax.vmap(lambda t: local_lnprob(t, local))

        def half_update(active, active_lnp, other_local, subkey):
            # partner pool: the full opposite half across all dp shards; the
            # proposal math is SHARED with the single-device sampler
            # (sampler/stretch.py propose_mixture) so the two can never drift
            # apart — incl. weighted move mixtures (per-walker selection needs
            # no cross-rank agreement)
            pool = jax.lax.all_gather(other_local, dp_axis, tiled=True)
            proposals, ln_bias, ln_u = propose_mixture(moves, active, pool,
                                                       subkey, a)
            new_lnp = batched_lnprob(proposals)
            ln_accept = ln_bias + new_lnp - active_lnp
            accept = (ln_u < ln_accept) & jnp.isfinite(new_lnp)
            return (jnp.where(accept[:, None], proposals, active),
                    jnp.where(accept, new_lnp, active_lnp),
                    accept)

        lnp0 = batched_lnprob(coords_local)

        def body(carry, _):
            c, lnp, acc, k = carry
            k, k0, k1 = jax.random.split(k, 3)
            cA, cB = c[:half_local], c[half_local:]
            pA, pB = lnp[:half_local], lnp[half_local:]
            cA, pA, accA = half_update(cA, pA, cB, k0)
            cB, pB, accB = half_update(cB, pB, cA, k1)
            c = jnp.concatenate([cA, cB], axis=0)
            lnp = jnp.concatenate([pA, pB], axis=0)
            acc = acc + jnp.concatenate([accA, accB]).astype(jnp.int32)
            return (c, lnp, acc, k), (c, lnp)

        (c_fin, lnp_fin, acc, key_fin), (chain, lnp_hist) = jax.lax.scan(
            body, (coords_local, lnp0, jnp.zeros(w_local, jnp.int32), key),
            None, length=n_steps)
        return c_fin, lnp_fin, key_fin[None], chain, lnp_hist, acc

    return sharded_run


class _RawScanOut(NamedTuple):
    """The scan's untouched outputs: interleaved dp-block walker layout."""

    chain: jnp.ndarray          # (S, W_interleaved, K), spec P(None, dp, None)
    lnp: jnp.ndarray            # (S, W_interleaved),    spec P(None, dp)
    acc: jnp.ndarray            # (W_interleaved,),      spec P(dp)
    order: np.ndarray           # interleave permutation (host)
    inverse_order: np.ndarray
    n_steps: int


class ShardedResult:
    """Output of :func:`run_ensemble_sharded`: globally-shaped jax.Arrays (sharded
    across the mesh) plus the resumable pieces.

    On process-spanning (multi-host) meshes the chain/log_prob/accepted stay
    in the scan's RAW interleaved dp-block layout: the eager de-interleave is
    a cross-shard gather whose output XLA lays out fully REPLICATED (measured:
    the spec collapses to ``P()``), i.e. one full copy of the chunk lands on
    every device of every host over DCN.  The emcee-layout views are therefore
    materialised lazily on first attribute access (old API, old semantics),
    while the shard-file checkpoint path (``Runner.save_current_status_shards``)
    reads only this process's own dp blocks via :meth:`local_blocks` — no
    collective, no DCN, and non-primary hosts never hold the full chain.

    .. warning:: on process-spanning meshes the lazy ``chain`` / ``log_prob``
       / ``accepted`` / ``acceptance_fraction`` accesses are cross-host
       COLLECTIVES: every process must access the attribute at the same
       program point, exactly like any jax collective.  Primary-only access
       (``if is_primary(): result.chain``) deadlocks the pod — use
       :meth:`local_blocks` for process-local reads, or the shard-file
       checkpoint, whose canonical ``.npz`` any single host may read."""

    def __init__(self, coords, lnp, key, acceptance_fraction=None, *,
                 chain=None, log_prob=None, accepted=None, raw=None):
        self.final_coords = coords            # (W, K)
        self.final_log_prob = lnp             # (W,)
        self.final_key = key
        self._chain = chain                   # (W, S, K) emcee layout
        self._log_prob = log_prob             # (W, S)
        self._accepted = accepted             # (W,) int: exact per-walker counts
        self._acceptance = acceptance_fraction
        self._raw = raw

    @property
    def chain(self):
        if self._chain is None:
            r = self._raw
            self._chain = jnp.swapaxes(r.chain, 0, 1)[r.inverse_order]
        return self._chain

    @property
    def log_prob(self):
        if self._log_prob is None:
            r = self._raw
            self._log_prob = jnp.swapaxes(r.lnp, 0, 1)[r.inverse_order]
        return self._log_prob

    @property
    def accepted(self):
        if self._accepted is None:
            r = self._raw
            self._accepted = r.acc[r.inverse_order]
        return self._accepted

    @property
    def acceptance_fraction(self):
        if self._acceptance is None:
            self._acceptance = self.accepted / max(self._raw.n_steps, 1)
        return self._acceptance

    def local_blocks(self):
        """This process's OWNED dp chain blocks as host arrays — no collective.

        Returns ``[(walker_ids, chain_block (w, S, K), lnp_block (w, S)), ...]``
        in ORIGINAL walker numbering.  A dp block is replicated across the sp
        ranks of its row, so several processes can address the same block;
        ownership goes to the lowest process index holding it (every process
        computes the same rule from the array's global shard map, so exactly
        one process writes each block)."""
        r = self._raw
        if r is None:
            raise ValueError("local_blocks() requires the raw scan layout "
                             "(process-spanning meshes only).")
        n_wi = r.chain.shape[1]

        def block_range(shard):
            sl = shard.index[1]
            return (sl.start or 0, n_wi if sl.stop is None else sl.stop)

        owners = {}
        for sh in r.chain.global_shards:
            key = block_range(sh)
            p = sh.device.process_index
            owners[key] = min(owners.get(key, p), p)

        lnp_blocks = {block_range(sh): sh for sh in r.lnp.addressable_shards}
        me = jax.process_index()
        out, seen = [], set()
        for sh in r.chain.addressable_shards:
            key = block_range(sh)
            if key in seen or owners[key] != me:
                continue
            seen.add(key)
            chain_block = np.swapaxes(np.asarray(sh.data), 0, 1)    # (w, S, K)
            lnp_block = np.swapaxes(np.asarray(lnp_blocks[key].data), 0, 1)
            out.append((np.asarray(r.order[key[0]:key[1]]),
                        chain_block, lnp_block))
        return out


def run_ensemble_sharded(runner, coords, key, n_steps: int, mesh: Mesh,
                         dp_axis: str = "dp", sp_axis: Optional[str] = "sp",
                         a: float = 2.0, move: str = "stretch") -> ShardedResult:
    """Advance a walker-sharded ensemble ``n_steps`` steps on a device mesh.

    ``coords``: (W, K) with W a multiple of ``2 * mesh.shape[dp_axis]``.  Each device
    block holds the same number of first-half and second-half walkers; the opposite
    half is all-gathered over ``dp`` per half-step.  When ``sp_axis`` is given, the
    star catalog is additionally sharded and likelihoods psum over it.
    """
    compiled = runner.compiled
    moves = normalize_move(move)
    n_dp = mesh.shape[dp_axis]
    use_sp = sp_axis is not None and sp_axis in mesh.shape
    n_sp = mesh.shape[sp_axis] if use_sp else 1

    # The key arrives replicated (fresh run: it is folded by dp rank below) or
    # as a stacked per-dp-rank array (a prior chunk's ``final_key`` or a
    # checkpointed sharded state).  Returning the stacked form and consuming
    # it un-refolded makes a chunked sharded run bitwise-identical to an
    # uninterrupted one — checkpoint resume included.
    key_arr = key if hasattr(key, "ndim") else jnp.asarray(key)
    typed_key = jnp.issubdtype(key_arr.dtype, jax.dtypes.prng_key)
    key_prefolded = key_arr.ndim == (1 if typed_key else 2)
    if key_prefolded and key_arr.shape[0] != n_dp:
        raise ValueError(
            f"Resuming a sharded run requires the same dp extent: state "
            f"carries {key_arr.shape[0]} per-rank keys, mesh has dp={n_dp}.")
    key_spec = P(dp_axis) if key_prefolded else P()

    # process-spanning meshes (multi-host): inputs must become global arrays;
    # bring coords to host first (it may itself be a prior chunk's global output)
    spans = mesh_spans_processes(mesh)
    if spans:
        coords = fetch(coords)
    coords = jnp.asarray(coords, dtype=runner.dtype) if not spans \
        else np.asarray(coords, dtype=runner.dtype)
    n_walkers, ndim = coords.shape
    if n_walkers % (2 * n_dp):
        raise ValueError(
            f"walkers ({n_walkers}) must be a multiple of 2*dp ({2 * n_dp})")

    # Reorder walkers so each contiguous device block holds interleaved half-A and
    # half-B members: block d = [A_d ; B_d]. Global half A = union of A_d.
    w_local = n_walkers // n_dp
    half_local = w_local // 2
    order = np.arange(n_walkers).reshape(2, n_dp, half_local).transpose(1, 0, 2).reshape(-1)
    inverse_order = np.argsort(order)
    coords = coords[order]

    # dp-only meshes replicate the catalog per device, so each shard can run the
    # model's fastest batched tier (sufficient tables / fused Pallas kernels)
    # instead of vmapping the generic per-walker likelihood — multi-chip scaling
    # at full per-chip throughput.  The catalog is baked into the tier's
    # closure, so NO data operands are passed (shipping replicated copies of
    # every column per call would be pure overhead).  Star-sharded meshes psum
    # per-shard partial sums; models with a fused partial path
    # (build_lnlike_partial_batched) keep kernel throughput there too.
    # Both tiers come from the runner's identity-stable caches: the compiled
    # program below is reused across checkpoint chunks.
    batched_tier = None if use_sp else runner._batched_lnprob_cached()
    partial_tier = runner._partial_tier_cached() if use_sp else None

    _ = runner.compiled  # refresh the parameter fingerprint for the caches
    if use_sp:
        # the padded device-resident catalog is reused across checkpoint
        # chunks — rebuilding it would re-transfer every column per chunk
        # the salt matters: prepare_data's output can depend on env-knob
        # state (the JAM grid tier ships its per-star bases as data columns)
        dkey = (runner._compiled_fp, runner.program_cache_salt(), n_sp)
        dcache = getattr(runner, "_sharded_data_cache", None)
        if dcache is None or dcache[0] != dkey:
            data = pad_star_axis(
                runner.prepare_data(dict(runner._data_arrays)), n_sp)
            if "mask" not in data:
                data["mask"] = jnp.ones_like(data["v"])
            names = tuple(sorted(data.keys()))
            dcache = (dkey, names, [data[k] for k in names])
            runner._sharded_data_cache = dcache
        data_names, data_arrays = dcache[1], list(dcache[2])
    else:
        data_names, data_arrays = (), []

    star_spec = P(sp_axis) if use_sp else P()
    if spans:
        # per-process feeding: every host holds the full catalog; each
        # materialises only the shards its local devices own (DCN never
        # carries the catalog — only psum partials and gathered half-ensembles)
        coords = to_global(mesh, P(dp_axis, None), coords)
        key = _globalize_key(key, mesh, key_spec)
        if use_sp:
            # the GLOBAL catalog arrays are cached too (keyed on mesh+spec):
            # without this each checkpoint chunk would re-run fetch()+
            # to_global() and re-transfer every column to the devices
            gkey = (dkey, mesh, sp_axis)
            gcache = getattr(runner, "_sharded_gdata_cache", None)
            if gcache is None or gcache[0] != gkey:
                gcache = (gkey, [to_global(mesh, star_spec, fetch(a))
                                 for a in data_arrays])
                runner._sharded_gdata_cache = gcache
            data_arrays = list(gcache[1])

    cache_key = (runner, runner._compiled_fp, runner.program_cache_salt(),
                 batched_tier, partial_tier,
                 mesh, dp_axis, sp_axis, use_sp, moves, float(a),
                 int(n_steps), n_walkers, ndim, bool(typed_key),
                 bool(key_prefolded), str(runner.dtype),
                 tuple((k, tuple(v.shape), str(v.dtype))
                       for k, v in zip(data_names, data_arrays)))
    sharded_run = _PROGRAM_CACHE.pop(cache_key, None)
    if sharded_run is None:
        if len(_PROGRAM_CACHE) >= 8:
            # LRU: evict ONE oldest program (clearing all would make a loop
            # alternating 9 configurations recompile everything per call)
            _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
        sharded_run = _build_sharded_run(
            runner, compiled, mesh, dp_axis, sp_axis, use_sp, moves, a,
            n_steps, half_local, w_local, key_prefolded, key_spec, star_spec,
            data_names, batched_tier, partial_tier)
    _PROGRAM_CACHE[cache_key] = sharded_run   # (re-)insert at MRU position

    c_fin, lnp_fin, key_fin, chain, lnp_hist, acc = sharded_run(
        coords, key, *data_arrays)

    if spans:
        # keep the raw interleaved layout: the de-interleave below replicates
        # the chunk onto every device over DCN (see ShardedResult docstring);
        # the emcee views materialise lazily, checkpoints read local blocks
        return ShardedResult(coords=c_fin[inverse_order],
                             lnp=lnp_fin[inverse_order], key=key_fin,
                             raw=_RawScanOut(chain, lnp_hist, acc,
                                             order, inverse_order, n_steps))

    # undo the interleaved layout -> original walker order, emcee chain layout
    chain = jnp.swapaxes(chain, 0, 1)[inverse_order]        # (W, S, K)
    log_prob = jnp.swapaxes(lnp_hist, 0, 1)[inverse_order]  # (W, S)
    accepted = acc[inverse_order]
    return ShardedResult(chain=chain, log_prob=log_prob,
                         coords=c_fin[inverse_order], lnp=lnp_fin[inverse_order],
                         key=key_fin,
                         acceptance_fraction=accepted / max(n_steps, 1),
                         accepted=accepted)
