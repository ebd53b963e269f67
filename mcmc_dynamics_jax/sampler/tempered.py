"""Parallel-tempered ensemble sampling (replica exchange) + evidence estimation.

A capability beyond the reference: JAM posteriors (mass-to-light vs distance vs
black-hole mass) can be multimodal, where a single-temperature ensemble mixes
poorly.  On an accelerator the temperature ladder is just another batch axis: K tempered
ensembles advance simultaneously inside one ``lax.scan`` and exchange states
between adjacent temperatures with the standard replica-swap acceptance

    ln alpha = (beta_k - beta_{k+1}) (lnP_{k+1} - lnP_k).

Power-posterior convention: level k targets ``beta_k * lnP(theta)`` (with hard
bounds staying -inf at every temperature).  The per-level mean log-posterior over
the run gives a thermodynamic-integration estimate of the log-evidence,
``ln Z = int_0^1 E_beta[lnP] dbeta`` — model comparison the reference cannot do.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .stretch import as_batched, normalize_move, propose_mixture

__all__ = ["TemperedState", "TemperedResult", "make_beta_ladder",
           "init_tempered", "run_tempered", "log_evidence"]


class TemperedState(NamedTuple):
    coords: jnp.ndarray     # (K, W, P)
    log_prob: jnp.ndarray   # (K, W) — UNtempered lnP
    key: jax.Array
    accepted: jnp.ndarray   # (K, W)
    swaps_accepted: jnp.ndarray  # (K-1,)
    step: jnp.ndarray


class TemperedResult(NamedTuple):
    chain: jnp.ndarray         # (W, S, P) — the cold (beta=1) chain
    log_prob: jnp.ndarray      # (W, S)
    mean_lnp_by_beta: jnp.ndarray  # (K,) run-averaged lnP per level (for TI)
    final: TemperedState
    acceptance_fraction: jnp.ndarray  # (K, W)
    swap_acceptance: jnp.ndarray      # (K-1,)


def make_beta_ladder(n_temps: int, beta_min: float = 1e-3) -> np.ndarray:
    """Geometric inverse-temperature ladder from 1 down to beta_min."""
    if n_temps == 1:
        return np.array([1.0])
    return np.geomspace(1.0, beta_min, n_temps)


def init_tempered(lnprob_fn: Callable, coords, key, n_temps: int,
                  beta_min: float = 1e-3, batched: bool = False):
    """Replicate (W, P) starting positions across the ladder and evaluate lnP."""
    fn = lnprob_fn if batched else as_batched(lnprob_fn)
    coords = jnp.asarray(coords)
    betas = jnp.asarray(make_beta_ladder(n_temps, beta_min), coords.dtype)
    stacked = jnp.broadcast_to(coords, (n_temps,) + coords.shape)
    lnp = jax.vmap(fn)(stacked)
    state = TemperedState(
        coords=stacked, log_prob=lnp, key=key,
        accepted=jnp.zeros(stacked.shape[:2], jnp.int32),
        swaps_accepted=jnp.zeros(n_temps - 1, jnp.int32),
        step=jnp.zeros((), jnp.int32))
    return state, betas


def _tempered_half(batched_lnprob, moves, active, active_lnp, other, beta, key,
                   a):
    """Ensemble half-update at inverse temperature beta: the proposal comes
    from the shared move machinery (stretch/de/snooker or a weighted mixture,
    sampler/stretch.py) and the acceptance tempers only the likelihood term,
    ``ln alpha = ln_bias + beta dlnP``."""
    proposals, ln_bias, ln_u = propose_mixture(moves, active, other, key, a)
    new_lnp = batched_lnprob(proposals)
    ln_accept = ln_bias + beta * (new_lnp - active_lnp)
    accept = (ln_u < ln_accept) & jnp.isfinite(new_lnp)
    return (jnp.where(accept[:, None], proposals, active),
            jnp.where(accept, new_lnp, active_lnp), accept)


# ``a`` static for the same reason as _scan_chain: compile-time constant,
# bitwise-aligned with the shard_map ladder which closes over it
@partial(jax.jit, static_argnums=(0, 3, 4, 5, 6, 7))
def _scan_tempered(batched_lnprob, state: TemperedState, betas, n_steps: int,
                   a: float, swap_every: int, store_chain: bool, moves):
    n_temps, n_walkers, ndim = state.coords.shape
    half = n_walkers // 2

    def level_step(coords_k, lnp_k, beta_k, key_k):
        k0, k1 = jax.random.split(key_k)
        cA, cB = coords_k[:half], coords_k[half:]
        pA, pB = lnp_k[:half], lnp_k[half:]
        cA, pA, aA = _tempered_half(batched_lnprob, moves, cA, pA, cB, beta_k,
                                    k0, a)
        cB, pB, aB = _tempered_half(batched_lnprob, moves, cB, pB, cA, beta_k,
                                    k1, a)
        return (jnp.concatenate([cA, cB]), jnp.concatenate([pA, pB]),
                jnp.concatenate([aA, aB]))

    def body(carry, _):
        st = carry
        key, k_move, k_swap = jax.random.split(st.key, 3)
        move_keys = jax.random.split(k_move, n_temps)
        coords, lnp, acc = jax.vmap(level_step)(st.coords, st.log_prob, betas,
                                                move_keys)

        # replica exchange between adjacent levels (walker-aligned swaps)
        def do_swaps(args):
            coords, lnp, swaps = args
            u = jax.random.uniform(k_swap, (n_temps - 1, n_walkers),
                                   dtype=coords.dtype)

            def swap_pair(k, args):
                coords, lnp, swaps = args
                d_beta = betas[k] - betas[k + 1]
                ln_alpha = d_beta * (lnp[k + 1] - lnp[k])
                sw = jnp.log(u[k]) < ln_alpha                     # (W,)
                ck, ck1 = coords[k], coords[k + 1]
                coords = coords.at[k].set(jnp.where(sw[:, None], ck1, ck))
                coords = coords.at[k + 1].set(jnp.where(sw[:, None], ck, ck1))
                pk, pk1 = lnp[k], lnp[k + 1]
                lnp = lnp.at[k].set(jnp.where(sw, pk1, pk))
                lnp = lnp.at[k + 1].set(jnp.where(sw, pk, pk1))
                swaps = swaps.at[k].add(jnp.sum(sw, dtype=jnp.int32))
                return coords, lnp, swaps

            return jax.lax.fori_loop(0, n_temps - 1, swap_pair,
                                     (coords, lnp, swaps))

        # gate on the carried GLOBAL step (st.step), not the scan-local
        # index: a run resumed from a checkpoint then keeps the exact swap
        # schedule of an uninterrupted run at any chunk split
        coords, lnp, swaps = jax.lax.cond(
            (st.step % swap_every) == swap_every - 1,
            do_swaps, lambda args: args, (coords, lnp, st.swaps_accepted))

        new = TemperedState(coords=coords, log_prob=lnp, key=key,
                            accepted=st.accepted + acc.astype(jnp.int32),
                            swaps_accepted=swaps, step=st.step + 1)
        out = ((coords[0], lnp[0]) if store_chain else None,
               jnp.mean(lnp, axis=1))
        return new, out

    final, (traj, lnp_by_beta) = jax.lax.scan(body, state, None,
                                              length=n_steps)
    return final, traj, lnp_by_beta


def run_tempered(lnprob_fn: Callable, state: TemperedState, betas,
                 n_steps: int, a: float = 2.0, swap_every: int = 1,
                 store_chain: bool = True, batched: bool = False,
                 move="stretch") -> TemperedResult:
    """Advance the tempered ensembles ``n_steps`` steps in one XLA computation.

    ``move`` accepts the same specs as :func:`run_ensemble` (a name or a
    weighted mixture)."""
    fn = lnprob_fn if batched else as_batched(lnprob_fn)
    if state.coords.shape[1] % 2:
        raise ValueError("Number of walkers must be even.")
    final, traj, lnp_by_beta = _scan_tempered(fn, state, jnp.asarray(betas),
                                              int(n_steps), float(a),
                                              int(swap_every), bool(store_chain),
                                              normalize_move(move))
    if store_chain:
        coords, lnp = traj
        chain = jnp.swapaxes(coords, 0, 1)
        log_prob = jnp.swapaxes(lnp, 0, 1)
    else:
        w, p = state.coords.shape[1:]
        chain = jnp.zeros((w, 0, p), state.coords.dtype)
        log_prob = jnp.zeros((w, 0), state.log_prob.dtype)

    n_done = jnp.maximum(final.step - state.step, 1)
    return TemperedResult(
        chain=chain, log_prob=log_prob,
        mean_lnp_by_beta=jnp.mean(lnp_by_beta, axis=0),
        final=final,
        acceptance_fraction=(final.accepted - state.accepted) / n_done,
        # max(..., 1): n_steps < swap_every means zero swap rounds — report
        # an acceptance of 0, not 0/0 = NaN
        swap_acceptance=(final.swaps_accepted - state.swaps_accepted)
        / jnp.maximum(n_done // max(swap_every, 1) * state.coords.shape[1], 1))


def log_evidence(betas, mean_lnp_by_beta) -> float:
    """Thermodynamic-integration log-evidence: trapezoid over the ladder.

    ``mean_lnp_by_beta`` are run-averaged UNtempered log-posteriors per level.
    """
    betas = np.asarray(betas)
    means = np.asarray(mean_lnp_by_beta)
    order = np.argsort(betas)
    return float(np.trapezoid(means[order], betas[order]))
