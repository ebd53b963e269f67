"""Axisymmetric Jeans (JAM) line-of-sight velocity moments in pure JAX.

This replaces the reference's only native dependency: the external C library ``cjam``
(called at reference axisymmetric.py:288-290 / chemo_profiles.py:240-242), which
implements the anisotropic MGE Jeans models of Cappellari (2008) as used by
Watkins et al. (2013).  Interface contract (inputs/outputs/validity) follows the
reference call sites; the numerics are an original accelerator-first formulation:

Physics
-------
Luminous tracer and total mass are Multi-Gaussian Expansions.  With per-Gaussian
anisotropy ``b_j = sigma_R^2 / sigma_z^2 = 1/(1-beta_j)`` and <v_R v_z> = 0, the
vertical Jeans equation integrates analytically through each Gaussian pair (j, k):

    [nu sigma_z^2]_j (R,z) = 4 pi G nu0_j  sum_k q_k rho0_k
        * int_0^1 du u^2 (1-e_k^2 u^2)^{-3/2} exp(-a_jk R^2 - A_jk z^2) / (2 A_jk)

    a_jk(u) = 1/(2 s_j^2) + u^2/(2 s_k^2)
    A_jk(u) = 1/(2 s_j^2 q_j^2) + u^2 / (2 s_k^2 (1 - e_k^2 u^2))

(from the classical homoeoid potential of a Gaussian, Emsellem et al. 1994), the
radial Jeans equation then gives

    [nu <v_phi^2>]_j = b_j ([nu sigma_z^2]_j + R d/dR [nu sigma_z^2]_j)
                       + nu_j R dPhi/dR,

and the mean rotation follows Cappellari (2008) section 3.3 / Watkins et al. (2013):
``vbar_phi,j = kappa_j sqrt(max(0, <v_phi^2>_j - b_j sigma_z,j^2))`` (kappa = 1 is the
isotropic rotator).  LOS projection at inclination ``i`` with sky coords (x', y')
(x' along the projected major axis) and LOS coordinate zeta:

    x = x',  y = y' cos i + zeta sin i,  z = -y' sin i + zeta cos i
    nu <v_los^2> = sin^2 i (b_j [nu sigma_z^2] y^2/R^2 + [nu <v_phi^2>] x^2/R^2)
                   + cos^2 i [nu sigma_z^2]
    nu <v_los>   = sin i  nu_j vbar_phi,j  x / R

Accelerator formulation
-----------------------
All Gaussian pair exponentials factor as exp(-a R^2 - A z^2) =
E_j(R,z) * E_k(R,z;u) with E_j independent of (k,u).  The double quadrature
(Gauss-Legendre in u) x mass-component sum therefore becomes a single contraction
S[j, p] = sum_t C[j, t] E_t[t, p]  over t = (u-node, mass-component) pairs and
p = (star, LOS-node) points — one matrix contraction per batch, not a scalar
loop.  The u-quadrature runs in the substituted variable s = u/sqrt(1-e^2 u^2),
whose Jacobian absorbs the near-singular homoeoid factor exactly (see the pair-
table section), so ~16 nodes suffice even for flattened components.  The LOS
integral is Gauss-Legendre under a per-star tangent map.  The black hole enters as an extra
near-point-mass Gaussian of width ``rbh`` (the reference's fiducial BH radius).

Everything is pure and jit/vmap-safe; invalid configurations (deprojection failure,
beta >= 1) return a ``valid=False`` flag instead of raising, so samplers map them to
-inf inside jit (the failure-containment analog of reference axisymmetric.py:292-310).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["jam_los_moments", "JamMoments", "PC_PER_ARCSEC_PER_KPC", "G_PC"]

# G in pc (km/s)^2 / Msun
G_PC = 4.30091727e-3
# pc per arcsec at 1 kpc distance
PC_PER_ARCSEC_PER_KPC = math.pi / 180.0 / 3600.0 * 1000.0
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_MIN_Q_DEPROJECTED = 0.05  # cjam's hard deprojection floor (deprojection.py:8-37)


class JamMoments(NamedTuple):
    vz: jnp.ndarray      # first LOS moment [km/s] per input position
    v2zz: jnp.ndarray    # second LOS moment [km^2/s^2]
    valid: jnp.ndarray   # scalar bool: model physically valid


def _gauss_legendre(n: int):
    nodes, weights = np.polynomial.legendre.leggauss(n)
    return nodes, weights


def jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                    d, beta, kappa, mscale, incl, mbh=0.0, rbh=1.0,
                    n_u: int = 24, n_zeta: int = 32) -> JamMoments:
    """LOS velocity moments of an axisymmetric JAM model.

    Parameters (all plain arrays/scalars; no units inside jit):
      x, y           sky positions [arcsec], x along the projected major axis
      lum_i/s/q      tracer MGE: central surface brightness [Lsun/pc^2],
                     width [arcsec], projected axis ratio
      mass_i/s/q     mass MGE: surface density [Msun/pc^2] (before mscale), width, q
      d              distance [kpc]
      beta           anisotropy beta_z, scalar or per tracer Gaussian
      kappa          rotation parameter, scalar or per tracer Gaussian
      mscale         mass scale (M/L), scalar or per mass Gaussian
      incl           inclination [rad]; pi/2 = edge-on
      mbh, rbh       black-hole mass [Msun] and fiducial width [arcsec]
      n_u, n_zeta    quadrature orders (u in [0,1]; LOS)

    Returns vz [km/s], v2zz [km^2/s^2] at each (x, y), plus a validity flag.
    """
    # Decide the black-hole branch *statically*: when mbh is a concrete zero
    # (a fixed parameter at trace time), the erfcx chain over (L, P) is dead
    # weight and is compiled out entirely.
    with_bh = not (isinstance(mbh, (int, float, np.floating))
                   and float(mbh) == 0.0)
    return _jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                            d, beta, kappa, mscale, incl, mbh, rbh,
                            n_u=n_u, n_zeta=n_zeta, with_bh=with_bh)


@partial(jax.jit, static_argnames=("n_u", "n_zeta", "with_bh"))
def _jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                     d, beta, kappa, mscale, incl, mbh, rbh,
                     n_u: int, n_zeta: int, with_bh: bool) -> JamMoments:
    dtype = jnp.result_type(jnp.asarray(x).dtype, jnp.float32)
    x = jnp.atleast_1d(jnp.asarray(x, dtype))
    y = jnp.atleast_1d(jnp.asarray(y, dtype))

    pc = d * PC_PER_ARCSEC_PER_KPC  # pc per arcsec

    lum_i = jnp.atleast_1d(jnp.asarray(lum_i, dtype))
    lum_s = jnp.atleast_1d(jnp.asarray(lum_s, dtype)) * pc    # -> pc
    lum_q = jnp.atleast_1d(jnp.asarray(lum_q, dtype))
    n_lum = lum_i.shape[0]

    # mass MGE (the black hole is handled separately below: a near-point-mass
    # Gaussian would put an unresolvable spike at u ~ 0 in the pair quadrature)
    mass_i = jnp.atleast_1d(jnp.asarray(mass_i, dtype))
    mass_i = mass_i * jnp.broadcast_to(jnp.asarray(mscale, dtype), mass_i.shape)
    mass_s = jnp.atleast_1d(jnp.asarray(mass_s, dtype)) * pc
    mass_q = jnp.atleast_1d(jnp.asarray(mass_q, dtype))

    rbh_pc = jnp.maximum(jnp.asarray(rbh, dtype) * pc, 1e-8)

    beta = jnp.broadcast_to(jnp.asarray(beta, dtype), (n_lum,))
    kappa = jnp.broadcast_to(jnp.asarray(kappa, dtype), (n_lum,))
    b = 1.0 / (1.0 - beta)  # sigma_R^2 / sigma_z^2

    cosi = jnp.cos(incl)
    sini_2 = jnp.maximum(1.0 - cosi * cosi, 1e-12)
    sini = jnp.sqrt(sini_2)

    # -------------------------------------------------------------- deprojection
    def deproject(qp):
        q2 = (qp * qp - cosi * cosi) / sini_2
        return jnp.sqrt(jnp.maximum(q2, 1e-10)), q2

    lum_qi, lum_q2raw = deproject(lum_q)
    mass_qi, mass_q2raw = deproject(mass_q)
    valid = (jnp.all(lum_q2raw >= _MIN_Q_DEPROJECTED ** 2)
             & jnp.all(mass_q2raw >= _MIN_Q_DEPROJECTED ** 2)
             & jnp.all(beta < 1.0))

    nu0 = lum_i * lum_q / (lum_s * lum_qi * _SQRT_2PI)      # Lsun / pc^3
    rho0 = mass_i * mass_q / (mass_s * mass_qi * _SQRT_2PI)  # Msun / pc^3

    # -------------------------------------------------------------- LOS sampling
    x_pc = x * pc
    y_pc = y * pc
    r_sky = jnp.sqrt(x_pc ** 2 + y_pc ** 2)
    s_max = jnp.max(lum_s)
    s_min = jnp.min(lum_s)
    if with_bh:
        # BH-aware per-star LOS scale: a point mass puts structure at zeta ~ R
        # for stars inside the innermost tracer Gaussian, where the plain
        # clip-to-s_min rule leaves ~2 nodes (measured dsig up to 1e-2 at the
        # n_zeta=32 default).  The geometric mean of the sky radius and the
        # clipped scale resolves both the BH cusp and the global structure:
        # measured worst-case dsig over incl x mbh x rbh grids is 8e-4 (at
        # negligible mbh) and <= 1e-4 wherever the BH actually matters.
        s_scale = jnp.sqrt(jnp.clip(r_sky, 1e-3, s_max)
                           * jnp.clip(r_sky, s_min, s_max))
    else:
        # cap at 1.0 * s_max (NOT 3x): beyond the outermost tracer Gaussian
        # the LOS integrand stays ~s_max wide, and a window that keeps
        # growing with r starves it of nodes — measured v2zz errors of 3-5x
        # at r ~ 2.8 s_max on a truncated MGE with the old 3 * s_max cap,
        # vs <= 1e-3 with this one (tools/probe_jam_grid.py edge case)
        s_scale = jnp.clip(r_sky, s_min, s_max)             # per-star LOS scale

    # LOS ridge centring: for a deprojected Gaussian of axis ratio q_i the
    # intrinsic ellipsoidal radius along the LOS through (x', y'),
    # l^2 = R^2 + z^2/q_i^2 with y = y' cos i + zeta sin i,
    # z = -y' sin i + zeta cos i, is minimised at
    #     zeta_c = y' sin i cos i (1/q_i^2 - 1) / (sin^2 i + cos^2 i / q_i^2)
    # — for strongly flattened components the density ridge sits up to ~1 y'
    # AWAY from zeta = 0, so a map centred at 0 starves it of nodes at large
    # |y'| (measured 3-5x v2zz errors at r ~ 2.8 s_max, barq ~ 0.4).  Centre
    # the tangent map on the ridge of the total-luminosity-weighted tracer.
    lum_w = lum_i * lum_s ** 2 * lum_q                       # component L_tot
    q2bar = jnp.sum(lum_w * lum_qi * lum_qi) / jnp.maximum(jnp.sum(lum_w),
                                                           1e-300)
    tilt = (sini * cosi * (1.0 / q2bar - 1.0)
            / (sini_2 + cosi * cosi / q2bar))
    zeta_c = y_pc * tilt                                     # (N,)

    t_nodes, t_weights = _gauss_legendre(n_zeta)
    t_nodes = jnp.asarray(0.5 * jnp.pi * t_nodes * 0.999, dtype)
    t_weights = jnp.asarray(t_weights, dtype) * 0.5 * jnp.pi * 0.999
    tan_t = jnp.tan(t_nodes)
    sec2_t = 1.0 + tan_t * tan_t
    zeta = zeta_c[:, None] + s_scale[:, None] * tan_t[None, :]   # (N, Z)
    w_zeta = s_scale[:, None] * (t_weights * sec2_t)[None, :]

    # intrinsic coordinates at each (star, LOS node)
    yy = y_pc[:, None] * cosi + zeta * sini                  # (N, Z)
    zz = -y_pc[:, None] * sini + zeta * cosi
    R2 = x_pc[:, None] ** 2 + yy * yy
    z2 = zz * zz
    safe_R2 = jnp.maximum(R2, 1e-12)

    # -------------------------------------------------------------- pair tables
    # The u-integrand carries the near-singular homoeoid factor
    # (1 - e_k^2 u^2)^(-3/2), which makes plain Gauss-Legendre in u converge
    # slowly for flattened components (e_k -> 1).  Substituting
    #     s = u / sqrt(1 - e_k^2 u^2)      (ds = (1 - e_k^2 u^2)^(-3/2) du)
    # absorbs that factor EXACTLY into the measure: the quadrature runs over
    # s in [0, 1/q_k] with per-component node placement and a uniformly smooth
    # integrand, so ~8-16 nodes reach the accuracy plain u-quadrature needs
    # 50+ for.  (The force integrand's (1-e^2 u^2)^(-1/2) becomes a benign
    # extra factor of (1 - e_k^2 u^2) on the transformed weights.)
    u_nodes, u_weights = _gauss_legendre(n_u)
    x01 = jnp.asarray(0.5 * (u_nodes + 1.0), dtype)          # (U,) on [0, 1]
    w01 = jnp.asarray(0.5 * u_weights, dtype)

    e2 = 1.0 - mass_qi * mass_qi                             # (M,)
    s_hi = 1.0 / mass_qi                                     # (M,) upper edge
    s_nodes = s_hi[:, None] * x01[None, :]                   # (M, U)
    ws = s_hi[:, None] * w01[None, :]
    u_mk = s_nodes * jax.lax.rsqrt(1.0 + e2[:, None] * s_nodes * s_nodes)
    u2 = u_mk * u_mk                                         # (M, U)
    one_m_e2u2 = 1.0 - e2[:, None] * u2
    bk = u2 / (2.0 * mass_s[:, None] ** 2)                   # beta_k(u)   (M, U)
    bk_t = bk / one_m_e2u2                                   # beta~_k(u)  (M, U)

    alpha = 1.0 / (2.0 * lum_s ** 2)                         # (L,)
    alpha_t = 1.0 / (2.0 * lum_s ** 2 * lum_qi ** 2)         # (L,)

    # flatten (M, U) -> T pair axis
    T = mass_s.shape[0] * n_u
    bk_f = bk.reshape(T)
    bkt_f = bk_t.reshape(T)
    qrho = (mass_qi * rho0)[:, None]
    w_pair = (qrho * ws * u2).reshape(T)     # w_s u^2 q_k rho0_k (measure in s)

    a_jt = alpha[:, None] + bk_f[None, :]                    # (L, T)
    A_jt = alpha_t[:, None] + bkt_f[None, :]                 # (L, T)

    coef_sz = w_pair[None, :] / (2.0 * A_jt)                 # (L, T)
    coef_sz_a = coef_sz * a_jt                               # for R d/dR term
    coef_fr = w_pair * one_m_e2u2.reshape(T)                 # (T,) force integrand

    # ---------------------------------------------------- underflow-proof scaling
    # Every numerator term carries the tracer factor E_j = exp(-alpha_j R^2 -
    # alpha~_j z^2), and the normalisation is the projected surface brightness
    # surf = sum_j lum_i_j exp(-e_jn).  In float32 both underflow to exactly 0
    # beyond ~13 sigma, turning the moments of a far-out star into 0/0.  The
    # ratio, however, is O(1): factor the per-star exponent of the DOMINANT
    # projected tracer Gaussian, g_n = min_j e_jn, out of numerators and
    # normalisation alike.  Because a Gaussian's projected exponent equals the
    # LOS-minimum of its intrinsic exponent, g_n <= alpha_j R^2 + alpha~_j z^2
    # for every (j, LOS node) — so each scaled exponential lies in (0, 1], the
    # dominant one is O(1) at every radius, and the scale cancels exactly in
    # vz = num1/surf and v2zz = num2/surf (num1 scales via sqrt(E_j * E_j)).
    # This is the online-max trick of ops/background_kernel.py applied at the
    # moment-assembly level; it makes float32 JAM valid at ANY radius.
    e_proj = (x_pc[None, :] ** 2 + (y_pc[None, :] ** 2) / (lum_q[:, None] ** 2)) \
        / (2.0 * lum_s[:, None] ** 2)                        # (L, N)
    # zero-intensity components (population-weighted MGEs in the chemo models
    # carry them) must not set the scale: they contribute nothing to surf, so
    # letting one dominate the min would re-introduce the very underflow this
    # scaling removes
    e_masked = jnp.where(lum_i[:, None] > 0, e_proj, jnp.inf)
    g_star = jnp.min(e_masked, axis=0)                       # (N,)
    g_star = jnp.where(jnp.isfinite(g_star), g_star, 0.0)    # all-zero MGE

    # -------------------------------------------------------------- contractions
    # S[r, p] = sum_t C[r, t] exp(-beta_k(t) R_p^2 - beta~_k(t) z_p^2) over the
    # t = (u-node, mass-component) pair axis, plus the tracer factor E_j.
    # A fused kernel that avoided materialising the (T, P) pair table lost to
    # this dot formulation twice on an earlier accelerator (the exponentials,
    # not the table traffic, set its floor); it has not been tried on the
    # current card.  The real lever was the LOS node count (n_zeta 40 -> 24,
    # accuracy-neutral).
    P = R2.size
    R2f = R2.reshape(P)
    z2f = z2.reshape(P)
    coef_rows = jnp.concatenate([coef_sz, coef_sz_a, coef_fr[None, :]], axis=0)

    g_f = jnp.broadcast_to(g_star[:, None], R2.shape).reshape(P)   # (P,)
    E_t = jnp.exp(-(bk_f[:, None] * R2f[None, :] + bkt_f[:, None] * z2f[None, :]))
    # float32: three bf16 products with f32 accumulation.  On an H100 (PERF.md)
    # Precision.HIGH runs in TF32 and put 0.15 lnL (5e-6 relative) on the
    # 6284-star example catalog against the float64 CPU evaluation; this
    # preset gives HIGHEST's accuracy (0.0035 lnL direct tier, 0.028 grid) at
    # TF32's speed (4.0 ms per 64 walkers direct, vs 6.2 ms for HIGHEST).
    # The bound it must meet is the JAM accelerator-vs-CPU gate (bench.py
    # --validate): rtol 2e-5, atol 0.1.  The preset takes f32 operands only;
    # float64 keeps HIGHEST.
    prec = (jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
            if jnp.result_type(coef_rows, E_t) == jnp.float32
            else jax.lax.Precision.HIGHEST)
    S_rows = jnp.matmul(coef_rows, E_t, precision=prec)            # (2L+1, P)
    # g <= e_j holds only for components that were allowed to set the scale;
    # a masked zero-intensity component (excluded from g_star above) can have
    # g - e_j >> 0, overflowing to inf and poisoning its nu0 = 0 row with
    # 0 * inf = NaN.  Clamping at 0 is exact for live components (their
    # dominant node sits at exactly 0) and caps dead rows at 1.
    E_j = jnp.exp(jnp.minimum(
        g_f[None, :] - (alpha[:, None] * R2f[None, :]
                        + alpha_t[:, None] * z2f[None, :]), 0.0))
    S_sz = S_rows[:n_lum]       # (L, P)
    S_sz_a = S_rows[n_lum:2 * n_lum]
    S_fr = S_rows[2 * n_lum]    # (P,)

    four_pi_g = 4.0 * jnp.pi * G_PC
    nu_sz2 = four_pi_g * nu0[:, None] * E_j * S_sz                        # (L, P)
    r_dr = four_pi_g * nu0[:, None] * E_j * (-2.0 * R2f[None, :]) * S_sz_a
    nu_rfr = four_pi_g * nu0[:, None] * E_j * R2f[None, :] * S_fr[None, :]
    nu_j = nu0[:, None] * E_j                                             # (L, P)

    # ---------------------------------------------------------- black hole terms
    # Plummer-softened point mass: Phi = -G M / sqrt(r^2 + rbh^2).  The vertical
    # Jeans integral through a Gaussian tracer is, with a_j = (s_j q_j)^2 and
    # C = R^2 + z^2 + rbh^2, x0 = C/(2 a_j),
    #   I32 = int_0^inf e^-w (C + 2 a_j w)^{-3/2} dw
    #       = (2 a)^{-3/2} [2 x0^{-1/2} - 2 sqrt(pi) erfcx(sqrt(x0))]
    # (and analogously I52) — CLOSED FORM via the scaled complementary error
    # function (sympy-verified; a near-point-mass Gaussian would be unresolvable
    # by the shared pair quadrature at u ~ 0, hence the dedicated treatment).
    # Large x0 uses the asymptotic series to dodge catastrophic cancellation.
    # (skipped statically when the caller passed a concrete mbh == 0)
    if with_bh:
        gm = G_PC * jnp.asarray(mbh, dtype)
        a_bh = (lum_s * lum_qi) ** 2                                      # (L,)
        C = R2f + z2f + rbh_pc * rbh_pc                                   # (P,)
        x0 = C[None, :] / (2.0 * a_bh[:, None])                           # (L, P)

        sqrt_pi = math.sqrt(math.pi)
        x0_safe = jnp.minimum(x0, 50.0)
        F = jnp.exp(x0_safe) * jax.scipy.special.erfc(jnp.sqrt(x0_safe))  # erfcx
        inv_sq = jax.lax.rsqrt(x0)
        small32 = 2.0 * inv_sq - 2.0 * sqrt_pi * F
        small52 = (2.0 / 3.0) * (inv_sq ** 3 - 2.0 * inv_sq + sqrt_pi * 2.0 * F)
        ix = 1.0 / x0
        large32 = inv_sq ** 3 * (1.0 + ix * (-1.5 + ix * (3.75 + ix * (
            -13.125 + ix * 59.0625))))
        large52 = inv_sq ** 5 * (1.0 + ix * (-2.5 + ix * (8.75 + ix * (
            -39.375 + ix * 216.5625))))
        use_small = x0 < 50.0
        two_a = (2.0 * a_bh[:, None]) ** -1.5
        i32 = two_a * jnp.where(use_small, small32, large32)
        i52 = two_a / (2.0 * a_bh[:, None]) * jnp.where(use_small, small52,
                                                        large52)

        nu_sz2 = nu_sz2 + nu_j * gm * a_bh[:, None] * i32
        r_dr = r_dr + nu_j * gm * a_bh[:, None] * (
            -(R2f[None, :] / (lum_s ** 2)[:, None]) * i32
            - 3.0 * R2f[None, :] * i52)
        nu_rfr = nu_rfr + nu_j * gm * R2f[None, :] * C[None, :] ** -1.5

    nu_vphi2 = b[:, None] * (nu_sz2 + r_dr) + nu_rfr                      # (L, P)

    # mean rotation per Gaussian, clipped where sigma_phi^2 would exceed <v_phi^2>.
    # nu_j * vbar_phi,j = kappa_j sqrt((nu<v_phi^2> - b nu sigma_z^2) * nu) — no
    # division by nu, so zero-intensity components stay exactly zero (needed for the
    # population-weighted MGEs of the chemo-dynamical models).
    nu_vbar = kappa[:, None] * jnp.sqrt(
        jnp.maximum(nu_vphi2 - b[:, None] * nu_sz2, 0.0) * nu_j)

    # -------------------------------------------------------------- LOS assembly
    sin2phi = (yy * yy / safe_R2).reshape(P)[None, :]
    cos2phi = (x_pc[:, None] ** 2 / safe_R2).reshape(P)[None, :]
    cosphi = (x_pc[:, None] / jnp.sqrt(safe_R2)).reshape(P)[None, :]

    integrand2 = (sini_2 * (b[:, None] * nu_sz2 * sin2phi + nu_vphi2 * cos2phi)
                  + (cosi * cosi) * nu_sz2)                               # (L, P)
    integrand1 = sini * nu_vbar * cosphi                                  # (L, P)

    num2 = jnp.sum(integrand2, axis=0).reshape(R2.shape)   # (N, Z)
    num1 = jnp.sum(integrand1, axis=0).reshape(R2.shape)
    num2 = jnp.sum(num2 * w_zeta, axis=1)                   # (N,)
    num1 = jnp.sum(num1 * w_zeta, axis=1)

    # normalisation under the SAME per-star scaling as the numerators: the
    # dominant term is exp(0) = 1, so surf_scaled in [lum_i_min, sum lum_i]
    # at every radius and the exp(g_star) factors cancel exactly in the ratio
    # clamped at 0 for the same reason as E_j: a masked zero-intensity
    # component may sit below g_star, and 0 * inf would poison the sum
    surf = jnp.sum(lum_i[:, None]
                   * jnp.exp(jnp.minimum(g_star[None, :] - e_proj, 0.0)), axis=0)
    surf = jnp.maximum(surf, jnp.finfo(dtype).tiny)
    return JamMoments(vz=num1 / surf, v2zz=num2 / surf, valid=valid)
