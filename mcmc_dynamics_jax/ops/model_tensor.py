"""Exact O(1)-per-walker ModelFit likelihood via 3-D tensor-Chebyshev tables.

The global-model likelihood (reference model.py:93-180 + runner.py:260-271) is

    lnL = -0.5 sum_i m_i [ log(2 pi n_i) + (v_i - v_sys - c_i (x_i vx + y_i vy))^2 / n_i ]
    n_i = E_i + s g(u_i; a),  E_i = verr_i^2,  s = sigma_max^2,  u_i = r_i^2
    g(u; a) = (1 + u/a^2)^(-1/2)          [Plummer dispersion, squared]
    c(u; rp) = 2 rp / (rp^2 + u)          [Lynden-Bell rotation shape]
    x = dy,  y = -dx

— quadratic in (v_sys, vx, vy), so the star axis collapses into ELEVEN channel
functions of the remaining parameters (w_i = m_i / n_i):

    2-D in (s, a):      F   = sum m_i log n_i        M0  = sum w v^2
                        m1v = sum w v                m11 = sum w
    3-D in (s, a, rp):  Svx = sum w c v x            Svy = sum w c v y
                        Sx  = sum w c x              Sy  = sum w c y
                        Qxx = sum w c^2 x^2          Qxy = sum w c^2 x y
                        Qyy = sum w c^2 y^2

    lnL = -0.5 [ F + M0 - 2 (v_sys m1v + vx Svx + vy Svy)
                 + v_sys^2 m11 + 2 v_sys (vx Sx + vy Sy)
                 + vx^2 Qxx + 2 vx vy Qxy + vy^2 Qyy + N log 2 pi ]

Unlike ops/model_sufficient.py (radially binned, 2nd-order Taylor inside each
bin) this tier is EXACT in the star sum: the only approximation is Chebyshev
truncation, which is driven below the evaluation dtype's own floor.

Variables and pole geometry.  Each channel is analytic in
(t_s, t_a, t_r) = (log(s + E_min), log(a^2), log(rp^2)): the poles sit at
n_i = 0 (complex s/a) and rp^2 = -u_i — in every log variable a distance ~pi
off the real interval, giving geometric coefficient decay with rate
rho = eta + sqrt(1 + eta^2), eta = pi / half-length.  Degrees are therefore
set by the PRIOR BOX: tighter priors on sigma_max / a / r_peak directly mean
fewer terms and a faster sampler.  The build oversizes the node grid by the
pole-geometry estimate plus margin and then truncates each axis at the
measured coefficient tail (self-certifying; the Q channels carry double poles
that cost a few terms over the single-pole estimate).

Layout.  Per walker the evaluation is
    mom = (T_s kron T_a) @ TABLE,    TABLE: (Ds*Da, 4 + 7*Dr)
followed by a tiny T_r contraction of the 3-D block — ONE matrix product with
no gathers, the same restructuring that took the ConstantFit tier gather-free
(ops/sufficient.py).  Per-walker cost is O(Ds*Da*(4 + 7*Dr)) independent of
the catalog size.

Tucker compression.  The coefficient tensor is numerically low-rank along the
s and a modes (measured on a realistic catalog: rank 18/33 in s, 16/18 in a
at 1e-6; the r mode is FULL rank — its pole moves with r_peak).  The build
therefore HOSVD-projects the s/a modes onto their singular bases and stores
``u_s``/``u_a`` plus the core table: the evaluation projects the Chebyshev
bases (two tiny matmuls) and the main contraction depth drops Ds*Da -> rs*ra
(~2x compute AND ~2x HBM traffic for the kron operand).  The compression is
self-certifying: the build compares core-reconstructed moments against the
full table on a random parameter sample and falls back to identity bases if
the per-channel deviation exceeds the truncation target.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["ModelTensorStats"]

logger = logging.getLogger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)
_N_2D = 4     # F, M0, m1v, m11
_N_3D = 7     # Svx, Svy, Sx, Sy, Qxx, Qxy, Qyy


def _cheb_nodes(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.cos(np.pi * (k + 0.5) / n)


def _dct_matrix(xi: np.ndarray) -> np.ndarray:
    n = xi.shape[0]
    tmat = np.cos(np.outer(np.arange(n), np.arccos(xi))) * (2.0 / n)
    tmat[0] *= 0.5
    return tmat


def _pole_degree(half_len: float, trunc: float) -> int:
    """Pole-geometry Chebyshev degree: poles ~pi off the real axis in the log
    variable, interval half-length ``half_len``."""
    eta = math.pi / max(half_len, 1e-6)
    rho = eta + math.sqrt(1.0 + eta * eta)
    return int(math.ceil(math.log(1.0 / trunc) / math.log(rho)))


def _tail_degree(coefs: np.ndarray, axis: int, trunc: float) -> int:
    """Smallest degree d such that every |coefficient| with index >= d along
    ``axis`` is below ``trunc`` times that channel's scale (channels = last
    axis, normalised independently)."""
    mags = np.abs(coefs)
    scale = np.maximum(mags.reshape(-1, mags.shape[-1]).max(0), 1e-300)
    prof = np.moveaxis(mags / scale, axis, 0)
    prof = prof.reshape(prof.shape[0], -1).max(1)
    keep = np.nonzero(prof >= trunc)[0]
    return int(keep[-1]) + 1 if keep.size else 1


def _tucker_compress(table: np.ndarray, k_s: int, k_a: int, trunc: float):
    """HOSVD-project the (s, a) modes of the channel table onto their singular
    bases.  ``table``: (k_s*k_a, C) with channels scaled independently for the
    truncation criterion.  Returns (u_s, u_a, core) with core (rs*ra, C).

    Self-certifying: the compressed moments are compared against the full
    table on a random coefficient sample; if any channel deviates by more
    than the truncation target the identity bases are returned instead.
    """
    n_ch = table.shape[1]
    scale = np.maximum(np.abs(table).max(0), 1e-300)
    t3 = (table / scale).reshape(k_s, k_a, n_ch)

    def mode_basis(ax, n):
        unf = np.moveaxis(t3, ax, 0).reshape(n, -1)
        u, sv, _ = np.linalg.svd(unf, full_matrices=False)
        # 0.3 margin: two truncated modes compound; keep each below the target
        keep = max(int(np.sum(sv > 0.3 * trunc * sv[0])), 1)
        return np.ascontiguousarray(u[:, :keep])

    u_s = mode_basis(0, k_s)
    u_a = mode_basis(1, k_a)
    core = np.einsum("pi,qj,pqc->ijc", u_s, u_a, t3, optimize=True)
    rs, ra = u_s.shape[1], u_a.shape[1]
    if rs * ra >= k_s * k_a:
        return np.eye(k_s), np.eye(k_a), table

    # certification: random basis-coefficient sample (covers the whole box —
    # Chebyshev bases at box points are bounded by 1, so random [-1, 1]
    # coefficient vectors bound the evaluation error from above in spirit;
    # use actual basis vectors at random box points for the honest check
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1.0, 1.0, (512, 2))
    bs = np.cos(np.arange(k_s)[None, :] * np.arccos(xs[:, :1]))
    ba = np.cos(np.arange(k_a)[None, :] * np.arccos(xs[:, 1:2]))
    f_full = (bs[:, :, None] * ba[:, None, :]).reshape(512, -1)
    f_comp = ((bs @ u_s)[:, :, None] * (ba @ u_a)[:, None, :]).reshape(512, -1)
    err = np.abs(f_comp @ core.reshape(rs * ra, n_ch)
                 - f_full @ (t3.reshape(k_s * k_a, n_ch)))
    if err.max() > 20.0 * trunc:
        logger.warning(
            "tensor-tier Tucker compression failed certification "
            "(max dev %.2e > %.1e); keeping the full table", err.max(),
            20.0 * trunc)
        return np.eye(k_s), np.eye(k_a), table
    logger.info("tensor-tier Tucker ranks (%d, %d) <- degrees (%d, %d), "
                "certified max dev %.2e", rs, ra, k_s, k_a, err.max())
    return u_s, u_a, (core.reshape(rs * ra, n_ch) * scale)


class ModelTensorStats(NamedTuple):
    """Tensor-Chebyshev tables of the eleven ModelFit channels."""

    table: jnp.ndarray      # (rs*ra, 4 + 7*Dr) Tucker core (or full table)
    u_s: jnp.ndarray        # (Ds, rs) s-mode singular basis (identity-free:
    u_a: jnp.ndarray        # (Da, ra)  rs = Ds / ra = Da when uncompressed)
    n_s: int                # static degrees
    n_a: int
    n_r: int
    t_s: jnp.ndarray        # (2,) interval [lo, hi] of log(s + offset)
    t_a: jnp.ndarray        # (2,) interval of log(a^2)
    t_r: jnp.ndarray        # (2,) interval of log(rp^2)
    offset: jnp.ndarray     # scalar: E_min pole shift for s
    n_stars: jnp.ndarray    # effective (masked) star count
    s_max: float            # static grid edges (internal units: (km/s)^2,
    a_lo: float             #  arcmin; used for the -inf box guard)
    a_hi: float
    r_lo: float
    r_hi: float

    @classmethod
    def build(cls, dxm, dym, v, verr2, a_bounds, r_bounds, mask=None,
              s_max: float = 1.0e6, dtype=None,
              trunc: Optional[float] = None,
              star_chunk: int = 8192) -> "ModelTensorStats":
        """Precompute the tables from the star catalog (host-side, float64).

        ``dxm``/``dym``: arcmin offsets from the (fixed) centre; ``verr2`` in
        (km/s)^2; ``a_bounds``/``r_bounds``: finite positive (lo, hi) prior
        bounds in arcmin — the grid IS the prior box, so the box guard in the
        caller coincides with the prior's own bound rejection.  The node grid
        is oversized ~30% beyond the pole-geometry degree estimate, then each
        axis is truncated at the measured coefficient tail.
        """
        dxm = np.asarray(dxm, np.float64)
        dym = np.asarray(dym, np.float64)
        v = np.asarray(v, np.float64)
        verr2 = np.asarray(verr2, np.float64)
        # binarise: documented membership (0/1) semantics, as in
        # ops/sufficient.py — fractional masks would re-weight the channels
        m = np.ones_like(v) if mask is None \
            else (np.asarray(mask, np.float64) > 0).astype(np.float64)
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        is_f64 = jnp.dtype(dtype) == jnp.float64
        if trunc is None:
            # the f32 evaluation floor is ~2e-6 relative (coefficient
            # cancellation in the contraction); terms below it are dead weight
            trunc = 1e-10 if is_f64 else 1e-6

        a_lo, a_hi = float(a_bounds[0]), float(a_bounds[1])
        r_lo, r_hi = float(r_bounds[0]), float(r_bounds[1])
        if not (0.0 < a_lo < a_hi < np.inf and 0.0 < r_lo < r_hi < np.inf):
            raise ValueError(
                "ModelTensorStats needs finite positive prior bounds on "
                f"'a' and 'r_peak'; got a in ({a_lo}, {a_hi}), "
                f"r_peak in ({r_lo}, {r_hi}).")

        u = dxm * dxm + dym * dym
        x, y = dym, -dxm
        e_min = float(np.min(verr2[m > 0])) if np.any(m > 0) else 1.0
        off = max(e_min, 1e-12)

        ts_lo, ts_hi = math.log(off), math.log(s_max + off)
        ta_lo, ta_hi = math.log(a_lo * a_lo), math.log(a_hi * a_hi)
        tr_lo, tr_hi = math.log(r_lo * r_lo), math.log(r_hi * r_hi)

        # oversized node grid: pole estimate + 30% margin (double poles of the
        # Q channels and star-sum prefactors cost a handful of extra terms)
        pad = lambda d, cap: int(np.clip(math.ceil(1.3 * d) + 4, 8, cap))
        n_s = pad(_pole_degree(0.5 * (ts_hi - ts_lo), trunc), 128 if is_f64 else 96)
        n_a = pad(_pole_degree(0.5 * (ta_hi - ta_lo), trunc), 96 if is_f64 else 64)
        n_r = pad(_pole_degree(0.5 * (tr_hi - tr_lo), trunc), 96 if is_f64 else 64)

        xi_s, xi_a, xi_r = _cheb_nodes(n_s), _cheb_nodes(n_a), _cheb_nodes(n_r)
        s_nodes = np.exp(0.5 * (ts_hi + ts_lo) + 0.5 * (ts_hi - ts_lo) * xi_s) - off
        s_nodes = np.clip(s_nodes, 0.0, s_max)
        a2_nodes = np.exp(0.5 * (ta_hi + ta_lo) + 0.5 * (ta_hi - ta_lo) * xi_a)
        rp_nodes = np.sqrt(np.exp(0.5 * (tr_hi + tr_lo) + 0.5 * (tr_hi - tr_lo) * xi_r))

        ch2 = np.zeros((n_s, n_a, _N_2D))
        ch3 = np.zeros((n_s * n_a, n_r * _N_3D))
        n_stars_total = v.shape[0]
        for lo in range(0, n_stars_total, star_chunk):
            sl = slice(lo, lo + star_chunk)
            us, xs, ys, vs, ms, es = u[sl], x[sl], y[sl], v[sl], m[sl], verr2[sl]
            g = 1.0 / np.sqrt(1.0 + us[:, None] / a2_nodes[None, :])   # (C, Da)
            den = es[:, None, None] + s_nodes[None, :, None] * g[:, None, :]
            w = ms[:, None, None] / den                                # (C, Ds, Da)
            ch2[:, :, 0] += np.einsum("isa,i->sa", np.log(den), ms)
            ch2[:, :, 1] += np.einsum("isa,i->sa", w, vs * vs)
            ch2[:, :, 2] += np.einsum("isa,i->sa", w, vs)
            ch2[:, :, 3] += w.sum(0)
            cb = 2.0 * rp_nodes[None, :] / (rp_nodes[None, :] ** 2 + us[:, None])
            # payload-weighted c and c^2 blocks -> (C, Dr*7), one BLAS matmul
            pay = np.concatenate(
                [cb * f[:, None] for f in (vs * xs, vs * ys, xs, ys)]
                + [cb * cb * f[:, None] for f in (xs * xs, xs * ys, ys * ys)],
                axis=1)                                                # (C, 7*Dr)
            ch3 += w.reshape(len(us), -1).T @ pay
        # pay blocks are channel-major: (7, Dr) -> want (Dr, 7) grouping later;
        # keep channel-major layout (ch, k) and document in the evaluator
        ch3 = ch3.reshape(n_s, n_a, _N_3D, n_r)

        # Chebyshev coefficients along each axis (optimize=True: the naive
        # einsum path for the 4-operand contraction is O(Ds^2 Da^2 Dr^2))
        d_s, d_a, d_r = _dct_matrix(xi_s), _dct_matrix(xi_a), _dct_matrix(xi_r)
        c2 = np.einsum("ps,qa,sac->pqc", d_s, d_a, ch2, optimize=True)
        c3 = np.einsum("ps,qa,kr,sacr->pqck", d_s, d_a, d_r, ch3,
                       optimize=True)

        # truncate each axis at the measured tail (channels normalised
        # independently; take the worst across 2-D and 3-D blocks)
        c3m = np.moveaxis(c3, 2, 3)                 # (Ds, Da, Dr, 7): ch last
        k_s = max(_tail_degree(c2, 0, trunc), _tail_degree(c3m, 0, trunc))
        k_a = max(_tail_degree(c2, 1, trunc), _tail_degree(c3m, 1, trunc))
        k_r = _tail_degree(c3m, 2, trunc)
        c2 = c2[:k_s, :k_a]
        c3 = c3[:k_s, :k_a, :, :k_r]

        table = np.concatenate(
            [c2.reshape(k_s * k_a, _N_2D),
             c3.reshape(k_s * k_a, _N_3D * k_r)], axis=1)
        u_s, u_a, table = _tucker_compress(table, k_s, k_a, trunc)

        return cls(table=jnp.asarray(table, dtype),
                   u_s=jnp.asarray(u_s, dtype), u_a=jnp.asarray(u_a, dtype),
                   n_s=int(k_s), n_a=int(k_a), n_r=int(k_r),
                   t_s=jnp.asarray([ts_lo, ts_hi], dtype),
                   t_a=jnp.asarray([ta_lo, ta_hi], dtype),
                   t_r=jnp.asarray([tr_lo, tr_hi], dtype),
                   offset=jnp.asarray(off, dtype),
                   n_stars=jnp.asarray(np.sum(m), dtype),
                   s_max=float(s_max), a_lo=a_lo, a_hi=a_hi,
                   r_lo=r_lo, r_hi=r_hi)

    # ------------------------------------------------------------------ evaluation
    @staticmethod
    def _cheb_basis(t, interval, n: int):
        """T_0..T_{n-1} at xi(t), stacked on the LAST axis: (..., n)."""
        xi = jnp.clip((2.0 * t - (interval[1] + interval[0]))
                      / (interval[1] - interval[0]), -1.0, 1.0)
        cols = [jnp.ones_like(xi), xi]
        for _ in range(n - 2):
            cols.append(2.0 * xi * cols[-1] - cols[-2])
        return jnp.stack(cols[:n], axis=-1)

    def lnlike(self, params, precision=jax.lax.Precision.HIGHEST):
        """Batched ModelFit log-likelihood: params (W, 6) columns
        (v_sys, sigma_max, a, v_maxx, v_maxy, r_peak) in internal units
        (km/s, arcmin) -> (W,).  Exact up to Chebyshev truncation (below the
        dtype's evaluation floor); callers must guard the prior box
        (s <= s_max, a/r_peak inside their bounds) — outside it the clipped
        basis extrapolates by the edge value.

        ``precision`` pins the contractions.  HIGHEST (full f32) is what the
        sampler runs: on an H100 (PERF.md, 16384 walkers x 1e5 stars against
        float64) it measured 1.0e-6 relative lnL in 0.33 ms, where HIGH runs
        in TF32 (3.7e-4 relative, 158 lnL) and the bf16x3 preset is both
        less accurate (4.2e-5) and slower (0.43 ms).  The bound is the
        tier's own Chebyshev truncation at the f32 floor (~1e-6).
        """
        v_sys, sigma_max, a = params[:, 0], params[:, 1], params[:, 2]
        vx, vy, rp = params[:, 3], params[:, 4], params[:, 5]
        s = sigma_max * sigma_max

        ts = jnp.log(jnp.maximum(s, 0.0) + self.offset)
        ta = 2.0 * jnp.log(jnp.maximum(a, 1e-300))
        tr = 2.0 * jnp.log(jnp.maximum(rp, 1e-300))
        bs = self._cheb_basis(ts, self.t_s, self.n_s)       # (W, Ds)
        ba = self._cheb_basis(ta, self.t_a, self.n_a)       # (W, Da)
        br = self._cheb_basis(tr, self.t_r, self.n_r)       # (W, Dr)

        # Tucker projections (tiny matmuls; u_s/u_a are identity-free when the
        # build's compression certified — rs*ra ~ 0.5x Ds*Da on real catalogs)
        ps = jnp.matmul(bs, self.u_s, precision=precision)  # (W, rs)
        pa = jnp.matmul(ba, self.u_a, precision=precision)  # (W, ra)
        # one matrix product: K = rs*ra, N = 4 + 7*Dr
        f2 = (ps[:, :, None] * pa[:, None, :]).reshape(ps.shape[0], -1)
        mom = jnp.matmul(f2, self.table, precision=precision)

        ff, m0, m1v, m11 = mom[:, 0], mom[:, 1], mom[:, 2], mom[:, 3]
        mom3 = mom[:, _N_2D:].reshape(-1, _N_3D, self.n_r)  # channel-major
        svx, svy, sx, sy, qxx, qxy, qyy = [
            jnp.einsum("wk,wk->w", mom3[:, i, :], br) for i in range(_N_3D)]

        quad = (m0 - 2.0 * (v_sys * m1v + vx * svx + vy * svy)
                + v_sys * v_sys * m11 + 2.0 * v_sys * (vx * sx + vy * sy)
                + vx * vx * qxx + 2.0 * vx * vy * qxy + vy * vy * qyy)
        return -0.5 * (ff + quad + self.n_stars * _LOG_2PI)

    def in_box(self, params):
        """Inside-the-table-box mask for the batched guard: True where the
        tables are valid (coincides with the prior box when the bounds came
        from the priors)."""
        s = params[:, 1] * params[:, 1]
        return ((s <= self.s_max)
                & (params[:, 2] >= self.a_lo) & (params[:, 2] <= self.a_hi)
                & (params[:, 5] >= self.r_lo) & (params[:, 5] <= self.r_hi))
