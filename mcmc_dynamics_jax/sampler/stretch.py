"""Native affine-invariant ensemble sampler (stretch moves) in JAX.

Replaces the reference's external ``emcee.EnsembleSampler`` (constructed at
runner.py:403 and driven through a fork-based process pool, one Python lnprob callback
per walker proposal).  Here one *jitted* step advances the whole ensemble:

* the ensemble is split into two halves; each half proposes against the other
  (Goodman & Weare 2010; the parallelisable variant of Foreman-Mackey et al. 2013);
* stretch factors ``z ~ g(z) ∝ 1/sqrt(z)`` on ``[1/a, a]`` are drawn as
  ``z = ((a-1) u + 1)^2 / a``;
* acceptance uses ``ln α = (K-1) ln z + lnP(y) − lnP(x)``;
* the chain loop is a ``lax.scan``, so thousands of walkers × steps execute in a
  single XLA computation with **zero** host round-trips;
* the PRNG is a threaded ``jax.random`` key, making checkpoint/resume bitwise
  reproducible (the reference loses the emcee RNG state across restarts,
  runner.py:415-419).

All functions are pure; a leading batch axis (independent fits, e.g. radial bins) is
supported by ``vmap`` — see :func:`run_ensemble`'s ``batch_axes`` handling.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["EnsembleState", "init_state", "stretch_step", "run_ensemble",
           "EnsembleResult", "as_batched", "propose_stretch", "propose_de",
           "propose_snooker", "propose_mixture", "normalize_move"]


class EnsembleState(NamedTuple):
    """Walker ensemble state. ``coords``: (W, K); ``log_prob``: (W,); ``key``: PRNG key;
    ``accepted``: (W,) cumulative accepted-move counts; ``step``: scalar int."""

    coords: jnp.ndarray
    log_prob: jnp.ndarray
    key: jax.Array
    accepted: jnp.ndarray
    step: jnp.ndarray


def as_batched(lnprob_fn: Callable) -> Callable:
    """Lift a per-walker lnprob f[K] -> f[] to a batched f[W,K] -> f[W]."""
    return jax.vmap(lnprob_fn)


def make_key(seed: int, impl: Optional[str] = None) -> jax.Array:
    """Sampler PRNG key; ``threefry2x32`` on every backend unless ``impl``
    names another generator.  Checkpoints record the generator's name
    (:func:`key_to_arrays`), so a key of any implementation resumes."""
    return jax.random.key(seed, impl=impl or "threefry2x32")


def key_to_arrays(key, to_host=None):
    """(data, impl-name) pair for checkpointing; accepts typed and legacy keys.

    ``to_host`` converts the raw key data to numpy; defaults to ``np.asarray``
    (single-process). Multi-host checkpointing passes ``distributed.fetch``
    so keys living on process-spanning meshes are gathered collectively.
    """
    import numpy as np
    to_host = np.asarray if to_host is None else to_host
    key = jnp.asarray(key)
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        impl = str(jax.random.key_impl(key))
        return to_host(jax.random.key_data(key)), impl
    return to_host(key), "legacy"


def key_from_arrays(data, impl: str):
    """Inverse of :func:`key_to_arrays`."""
    if impl == "legacy":
        return jnp.asarray(data, dtype=jnp.uint32)
    return jax.random.wrap_key_data(jnp.asarray(data, dtype=jnp.uint32), impl=impl)


def init_state(lnprob_fn: Callable, coords, key,
               batched: bool = False) -> EnsembleState:
    """Evaluate lnprob for the initial walker positions and build the state.

    ``batched=True`` declares that ``lnprob_fn`` already maps (W, K) -> (W,)
    (e.g. a fused Pallas kernel); otherwise it is vmapped.
    """
    fn = lnprob_fn if batched else as_batched(lnprob_fn)
    coords = jnp.asarray(coords)
    log_prob = fn(coords)
    return EnsembleState(
        coords=coords,
        log_prob=log_prob,
        key=key,
        accepted=jnp.zeros(coords.shape[0], dtype=jnp.int32),
        step=jnp.zeros((), dtype=jnp.int32),
    )


def propose_stretch(active_coords, pool, key, a: float):
    """Stretch-move proposals for one half against a partner pool.

    Returns (proposals, ln_bias, ln_u): the asymmetry correction
    ln_bias = (K-1) ln z and the pre-drawn acceptance uniforms.  Shared by the
    single-device and shard_map samplers so the proposal distribution can
    never drift between them.
    """
    n_active, ndim = active_coords.shape
    # single fused PRNG invocation per half-step (three tiny draws would each pay
    # the fixed cost of a generator call)
    un = jax.random.uniform(key, (3, n_active), dtype=active_coords.dtype)
    z = ((a - 1.0) * un[0] + 1.0) ** 2 / a
    n_pool = pool.shape[0]
    partner_idx = jnp.minimum((un[1] * n_pool).astype(jnp.int32), n_pool - 1)
    partners = pool[partner_idx]
    proposals = partners + z[:, None] * (active_coords - partners)
    return proposals, (ndim - 1.0) * jnp.log(z), jnp.log(un[2])


def propose_de(active_coords, pool, key, gamma0: float = None,
               jitter: float = 1e-5, jump_prob: float = 0.1):
    """Differential-evolution proposals (ter Braak 2006; emcee v3 DEMove).

    y = x + gamma (a - b) + eps with a != b drawn from the pool; a fraction
    ``jump_prob`` of proposals uses gamma = 1 ("mode-jumping") so long-range
    moves between modes stay possible.  Symmetric proposal -> ln_bias = 0.
    Returns (proposals, ln_bias, ln_u).  Shared by both samplers.
    """
    n_active, ndim = active_coords.shape
    if gamma0 is None:
        gamma0 = 2.38 / math.sqrt(2.0 * ndim)
    n_pool = pool.shape[0]
    un = jax.random.uniform(key, (4, n_active), dtype=active_coords.dtype)
    eps = jax.random.normal(jax.random.fold_in(key, 1),
                            (n_active, ndim), dtype=active_coords.dtype)
    idx1 = jnp.minimum((un[0] * n_pool).astype(jnp.int32), n_pool - 1)
    # distinct second partner: shift by 1 + u*(n-1) modulo n
    off = 1 + jnp.minimum((un[1] * (n_pool - 1)).astype(jnp.int32), n_pool - 2)
    idx2 = (idx1 + off) % n_pool
    gamma = jnp.where(un[2] < jump_prob, 1.0, gamma0).astype(active_coords.dtype)
    diff = pool[idx1] - pool[idx2]
    proposals = active_coords + gamma[:, None] * diff + jitter * eps
    return proposals, jnp.zeros(n_active, dtype=active_coords.dtype), jnp.log(un[3])


def propose_snooker(active_coords, pool, key, gammas: float = 1.7):
    """Snooker differential-evolution proposals (ter Braak & Vrugt 2008;
    emcee v3 DESnookerMove).

    Each walker x draws three distinct pool members (z, z1, z2) and moves
    along the unit direction u = (x - z)/|x - z| by ``gammas`` times the
    difference of the projections of z1 and z2 onto u.  The proposal density
    is not symmetric in |y - z|, giving the Metropolis correction
    ln_bias = (K-1)(ln|y - z| - ln|x - z|).  Needs a pool of >= 3 walkers.
    Returns (proposals, ln_bias, ln_u); shared by the single-device and
    shard_map samplers so the proposal distribution can never drift.
    """
    n_active, ndim = active_coords.shape
    n_pool = pool.shape[0]
    if n_pool < 3:
        raise ValueError(
            f"Snooker proposals need a partner pool of >= 3 walkers (got "
            f"{n_pool}; use >= 6 walkers) — with 2 the z2 draw would wrap "
            "back onto z and break the Metropolis correction.")
    tiny = jnp.finfo(active_coords.dtype).tiny
    un = jax.random.uniform(key, (4, n_active), dtype=active_coords.dtype)
    i0 = jnp.minimum((un[0] * n_pool).astype(jnp.int32), n_pool - 1)
    # distinct offsets: off1 in [1, n-1]; off2 drawn from [1, n-2] then bumped
    # past off1 -> off2 in [1, n-1] \ {off1}; all three indices distinct
    off1 = 1 + jnp.minimum((un[1] * (n_pool - 1)).astype(jnp.int32), n_pool - 2)
    off2 = 1 + jnp.minimum((un[2] * (n_pool - 2)).astype(jnp.int32),
                           n_pool - 3)
    off2 = jnp.where(off2 >= off1, off2 + 1, off2)
    z = pool[i0]
    z1 = pool[(i0 + off1) % n_pool]
    z2 = pool[(i0 + off2) % n_pool]
    delta = active_coords - z
    norm2 = jnp.maximum(jnp.sum(delta * delta, axis=1), tiny)
    u_dir = delta * jax.lax.rsqrt(norm2)[:, None]
    step = jnp.sum(u_dir * (z1 - z2), axis=1)
    proposals = active_coords + gammas * step[:, None] * u_dir
    d_new = proposals - z
    norm2_new = jnp.maximum(jnp.sum(d_new * d_new, axis=1), tiny)
    ln_bias = 0.5 * (ndim - 1.0) * (jnp.log(norm2_new) - jnp.log(norm2))
    return proposals, ln_bias, jnp.log(un[3])


_MOVE_NAMES = ("stretch", "de", "snooker")
# tunable hyperparameters per move; anything else in a spec is a typo
_MOVE_PARAMS = {
    "stretch": ("a",),
    "de": ("gamma0", "jitter", "jump_prob"),
    "snooker": ("gammas",),
}


def _normalize_params(name: str, params) -> tuple:
    """Hyperparameter mapping -> sorted, hashable ((key, value), ...) tuple."""
    if not params:
        return ()
    items = dict(params).items()
    allowed = _MOVE_PARAMS[name]
    for k, _ in items:
        if k not in allowed:
            raise ValueError(
                f"Unknown hyperparameter {k!r} for move '{name}' "
                f"(tunable: {allowed}).")
    return tuple(sorted((str(k), None if v is None else float(v))
                        for k, v in items))


def normalize_move(move):
    """Canonicalise a move spec into a hashable, normalised tuple of
    (name, weight, params) triples — the static-argument form consumed by
    the jitted samplers.

    Accepts a single name (``"de"``), a weighted mixture in the emcee v3
    ``moves=[(DEMove(), 0.8), (DESnookerMove(), 0.2)]`` style
    (``(("de", 0.8), ("snooker", 0.2))``), or entries with an explicit
    hyperparameter mapping (``("de", 1.0, {"gamma0": 0.8})``).  ``params``
    is a sorted ``((key, value), ...)`` tuple so the whole spec stays a
    valid jit static argument.  Weights are normalised to sum to 1.
    """
    if isinstance(move, str):
        entries = ((move, 1.0, ()),)
    else:
        entries = []
        try:
            for entry in move:
                if isinstance(entry, str):
                    entries.append((entry, 1.0, ()))
                else:
                    m, w, *rest = entry
                    params = rest[0] if rest else ()
                    entries.append((str(m), float(w), params))
            entries = tuple(entries)
        except (TypeError, ValueError) as err:
            raise ValueError(
                f"move must be a name or a sequence of (name, weight[, "
                f"params]) entries; got {move!r}") from err
    out = []
    for name, w, params in entries:
        if name not in _MOVE_NAMES:
            raise ValueError(f"Unknown move '{name}' (use one of {_MOVE_NAMES}).")
        if not w > 0:
            raise ValueError(
                f"Move weights must be positive (got {name!r}: {w}).")
        out.append((name, w, _normalize_params(name, params)))
    if not out:
        raise ValueError("Move weights must be positive.")
    total = sum(w for _, w, _p in out)
    return tuple((n, w / total, p) for n, w, p in out)


def _propose_one(name: str, params, active_coords, pool, key, a: float):
    kw = dict(params)
    if name == "stretch":
        return propose_stretch(active_coords, pool, key, kw.get("a", a))
    if name == "de":
        return propose_de(active_coords, pool, key, **kw)
    return propose_snooker(active_coords, pool, key, **kw)


def propose_mixture(moves, active_coords, pool, key, a: float = 2.0):
    """Proposals under a weighted move mixture (normalised (name, weight,
    params) tuple from :func:`normalize_move`).

    Each walker independently picks a move with the given probabilities —
    state-independent mixing of valid Metropolis kernels, so detailed balance
    holds per walker.  All component proposals are computed (they are a few
    elementwise ops each) and select()-ed per walker; the expensive lnprob still runs
    exactly once, on the selected proposals.  Shared by the single-device and
    shard_map samplers.
    """
    if len(moves) == 1:
        name, _w, params = moves[0]
        return _propose_one(name, params, active_coords, pool, key, a)
    keys = jax.random.split(key, len(moves) + 1)
    u = jax.random.uniform(keys[0], (active_coords.shape[0],),
                           dtype=active_coords.dtype)
    parts = [_propose_one(name, params, active_coords, pool, k, a)
             for (name, _w, params), k in zip(moves, keys[1:])]
    props = jnp.stack([p[0] for p in parts])       # (M, n, K)
    biases = jnp.stack([p[1] for p in parts])      # (M, n)
    lnus = jnp.stack([p[2] for p in parts])
    edges = jnp.cumsum(jnp.asarray([w for _, w, _p in moves[:-1]],
                                   active_coords.dtype))
    idx = jnp.sum(u[None, :] >= edges[:, None], axis=0)      # (n,) in [0, M-1]
    proposals = jnp.take_along_axis(props, idx[None, :, None], axis=0)[0]
    ln_bias = jnp.take_along_axis(biases, idx[None, :], axis=0)[0]
    ln_u = jnp.take_along_axis(lnus, idx[None, :], axis=0)[0]
    return proposals, ln_bias, ln_u


def _accept_update(batched_lnprob, active_coords, active_lnp, proposals,
                   ln_bias, ln_u):
    new_lnp = batched_lnprob(proposals)
    ln_accept = ln_bias + new_lnp - active_lnp
    # NaN-guard: a NaN lnprob never wins (failure containment analogous to the
    # reference returning -inf on invalid models, axisymmetric.py:292-310).
    accept = (ln_u < ln_accept) & jnp.isfinite(new_lnp)
    coords = jnp.where(accept[:, None], proposals, active_coords)
    lnp = jnp.where(accept, new_lnp, active_lnp)
    return coords, lnp, accept


def stretch_step(lnprob_fn: Callable, state: EnsembleState, a: float = 2.0,
                 batched: bool = False, move: str = "stretch") -> EnsembleState:
    """One full ensemble step: update first half against second, then vice versa.

    ``move``: ``"stretch"`` (Goodman & Weare, the emcee default), ``"de"``
    (differential evolution, ter Braak 2006 / emcee v3 DEMove — better mixing
    for strongly correlated, banana-shaped posteriors such as (a, r_peak)),
    ``"snooker"`` (ter Braak & Vrugt 2008 / emcee v3 DESnookerMove —
    projection-based DE; the emcee-recommended companion for multimodal
    targets), or a weighted mixture in the emcee v3 ``moves=`` style:
    ``(("de", 0.8), ("snooker", 0.2))`` — each walker draws its move
    independently per half-step."""
    fn = lnprob_fn if batched else as_batched(lnprob_fn)
    moves = normalize_move(move)
    n_walkers, ndim = state.coords.shape
    half = n_walkers // 2
    key_next, key0, key1 = jax.random.split(state.key, 3)

    c0, c1 = state.coords[:half], state.coords[half:]
    p0, p1 = state.log_prob[:half], state.log_prob[half:]

    def half_update(active, lnp, other, k):
        proposals, ln_bias, ln_u = propose_mixture(moves, active, other, k, a)
        return _accept_update(fn, active, lnp, proposals, ln_bias, ln_u)

    c0, p0, acc0 = half_update(c0, p0, c1, key0)
    c1, p1, acc1 = half_update(c1, p1, c0, key1)

    return EnsembleState(
        coords=jnp.concatenate([c0, c1], axis=0),
        log_prob=jnp.concatenate([p0, p1], axis=0),
        key=key_next,
        accepted=state.accepted + jnp.concatenate([acc0, acc1]).astype(jnp.int32),
        step=state.step + 1,
    )


class EnsembleResult(NamedTuple):
    """Sampling output. ``chain``: (W, S, K) in emcee layout (walkers, steps, params);
    ``log_prob``: (W, S); ``final``: resumable :class:`EnsembleState`;
    ``acceptance_fraction``: (W,)."""

    chain: jnp.ndarray
    log_prob: jnp.ndarray
    final: EnsembleState
    acceptance_fraction: jnp.ndarray


# ``a`` is static: baked as a compile-time constant, exactly like the
# shard_map samplers close over it — keeping the two proposal streams
# bitwise-identical (a traced scalar folds differently at the ULP level)
@partial(jax.jit, static_argnums=(0, 2, 3, 4, 5, 6))
def _scan_chain(batched_lnprob, state: EnsembleState, n_steps: int, a: float,
                thin: int, store_chain: bool, move: str):
    def body(carry, _):
        new = stretch_step(batched_lnprob, carry, a=a, batched=True, move=move)
        out = (new.coords, new.log_prob) if store_chain else None
        return new, out

    if thin <= 1:
        final, traj = jax.lax.scan(body, state, None, length=n_steps)
    else:
        def thinned_body(carry, _):
            inner, _ = jax.lax.scan(
                lambda c, __: (stretch_step(batched_lnprob, c, a=a, batched=True,
                                            move=move),
                               None),
                carry, None, length=thin)
            out = (inner.coords, inner.log_prob) if store_chain else None
            return inner, out

        final, traj = jax.lax.scan(thinned_body, state, None, length=n_steps // thin)
    return final, traj


def run_ensemble(lnprob_fn: Callable,
                 initial: EnsembleState,
                 n_steps: int,
                 a: float = 2.0,
                 thin: int = 1,
                 store_chain: bool = True,
                 batched: bool = False,
                 move: str = "stretch") -> EnsembleResult:
    """Advance the ensemble ``n_steps`` steps inside one XLA computation.

    ``lnprob_fn(theta: f[K]) -> f[]`` must be pure/trace-safe (or, with
    ``batched=True``, map (W, K) -> (W,) directly — e.g. a fused Pallas kernel).
    With ``thin > 1`` only every ``thin``-th step is recorded (n_steps must be a
    multiple of ``thin``).
    """
    if initial.coords.shape[0] % 2:
        raise ValueError("Number of walkers must be even for half-ensemble moves.")
    if thin > 1 and n_steps % thin:
        raise ValueError("n_steps must be a multiple of thin.")

    fn = lnprob_fn if batched else as_batched(lnprob_fn)
    final, traj = _scan_chain(fn, initial, int(n_steps), float(a),
                              int(thin), bool(store_chain),
                              normalize_move(move))
    if store_chain:
        coords, lnp = traj  # (S, W, K), (S, W)
        chain = jnp.swapaxes(coords, 0, 1)          # -> (W, S, K) emcee layout
        log_prob = jnp.swapaxes(lnp, 0, 1)          # -> (W, S)
    else:
        chain = jnp.zeros((initial.coords.shape[0], 0, initial.coords.shape[1]),
                          dtype=initial.coords.dtype)
        log_prob = jnp.zeros((initial.coords.shape[0], 0), dtype=initial.log_prob.dtype)

    n_done = final.step - initial.step
    acc = (final.accepted - initial.accepted) / jnp.maximum(n_done, 1)
    return EnsembleResult(chain=chain, log_prob=log_prob, final=final,
                          acceptance_fraction=acc)
