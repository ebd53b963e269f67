"""Global radial models: Lynden-Bell rotation curve + Plummer dispersion profile.

JAX reimplementation of the reference's ``analysis/model.py``:

* rotation: violent-relaxation profile (Lynden-Bell 1967)
  ``v_los = v_sys + 2 (v_max / r_peak) x_pa / (1 + (r/r_peak)^2)`` with
  ``x_pa = r sin(theta - theta_0)`` (model.py:130-180);
* dispersion: Plummer (1911) profile
  ``sigma(r) = sigma_max / (1 + r^2/a^2)^(1/4)`` (model.py:93-128);
* the GB variant mixes in a parametric Gaussian background with membership priors
  ``m = density/(density + f_back)`` (model.py:391-456);
* ``ModelFitConstantBackground`` uses a fixed per-star background likelihood computed
  once from a background model, sampling only the mixing weight (model.py:513-623).
"""

from __future__ import annotations

import logging

import numpy as np
import jax.numpy as jnp

from .base import (Runner, gaussian_lnlike_terms, lnprob_mode, masked_sum,
                   mixture_lnlike_terms)
from .. import units as u
from ..utils.coordinates import xy_offset_rad
from ..utils.table import Table

logger = logging.getLogger(__name__)

__all__ = ["ModelFit", "ModelFitGB", "ModelFitConstantBackground"]

_ARCMIN_PER_RAD = 10800.0 / np.pi


class ModelFit(Runner):
    MODEL_PARAMETERS = ["v_sys", "v_maxx", "v_maxy", "r_peak", "sigma_max", "a",
                        "ra_center", "dec_center"]
    OBSERVABLES = {"v": "km/s", "verr": "km/s", "ra": "deg", "dec": "deg"}
    INTERNAL_UNITS = {"v_sys": "km/s", "v_maxx": "km/s", "v_maxy": "km/s",
                      "sigma_max": "km/s", "r_peak": "arcmin", "a": "arcmin",
                      "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "model.json"

    # ------------------------------------------------------------------ pure model
    def prepare_data(self, data):
        """Fixed centre -> precompute (dx, dy) arcmin offsets in float64 host-side;
        the traced likelihood then has no per-star trig.  Free centre -> ship
        the exact shifted-centre star constants as data columns (sliceable
        over sp on star-sharded meshes); _offsets_arcmin and the free-centre
        kernel evaluate the projection from them with per-WALKER trig only."""
        if self.center_is_fixed():
            dx, dy = self.fixed_center_offsets()
            data["dxm"] = jnp.asarray(dx * _ARCMIN_PER_RAD, self.dtype)
            data["dym"] = jnp.asarray(dy * _ARCMIN_PER_RAD, self.dtype)
        else:
            data = self.add_freecenter_columns(data)
        return data

    def _offsets_arcmin(self, p, data):
        if "dxm" in data:
            return data["dxm"], data["dym"]
        if "fc_dx0" in data:
            # exact trig-identity form of the shifted-centre projection: this
            # is what the XLA fallback of EVERY free-centre variant (GB, CB,
            # double-model) evaluates — ~10 FMAs per (walker, star) pair
            # instead of four transcendentals
            return self.freecenter_offsets_arcmin(p, data)
        dx, dy = xy_offset_rad(data["ra"], data["dec"],
                               p["ra_center"], p["dec_center"], xp=jnp)
        return dx * _ARCMIN_PER_RAD, dy * _ARCMIN_PER_RAD

    def rotation_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        r2 = dx * dx + dy * dy
        # x_pa * v_max = r sin(theta - theta_0) * v_max = dy v_maxx - dx v_maxy
        x_pa_vmax = dy * p["v_maxx"] - dx * p["v_maxy"]
        return p["v_sys"] + 2.0 * x_pa_vmax / (p["r_peak"] * (1.0 + r2 / p["r_peak"] ** 2))

    def dispersion_field(self, p, data):
        dx, dy = self._offsets_arcmin(p, data)
        r2 = dx * dx + dy * dy
        return p["sigma_max"] / (1.0 + r2 / p["a"] ** 2) ** 0.25

    def lnlike_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        terms = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return terms

    # ------------------------------------------------------------------ fast paths
    def _canonical_layout(self) -> bool:
        return (type(self) is ModelFit
                and self.center_is_fixed()
                and "lnlike_background" not in self._data_arrays
                and self.compiled.free_names == ["v_sys", "sigma_max", "a",
                                                 "v_maxx", "v_maxy", "r_peak"])

    def _sufficient_eligible(self) -> bool:
        """The O(n_bins)-per-walker radially-binned sufficient-statistics path
        (ops/model_sufficient.py): canonical layout, no per-star mixture.

        In ``auto`` mode the tier is picked only for large catalogs: its
        per-walker cost is O(n_bins x n_coef x 61) independent of N, so it can
        only pay off where the direct O(N) tier is slow — and unlike the direct
        tier it is approximate (~1e-4 in lnL), so it must never silently replace
        the exact likelihood for ordinary catalogs.  The 16384-star crossover is
        not re-measured on the current card.  ``MCMC_LNPROB=sufficient`` forces
        it regardless of size.  When the priors on ``a``/``r_peak`` are finite
        the tensor-Chebyshev tier (:meth:`_tensor_eligible`) supersedes this
        one in ``auto`` mode — it is exact in the star sum and faster."""
        mode = lnprob_mode()
        if mode not in ("auto", "sufficient"):
            return False
        if not self._canonical_layout():
            return False
        if mode == "auto":
            return int(self._data_arrays["v"].shape[0]) >= 16384
        return True

    def _tensor_bounds(self):
        """Finite positive (lo, hi) prior bounds of ``a`` and ``r_peak`` in
        internal arcmin — the grid box of the tensor-Chebyshev tier — or
        ``None`` when either prior is unbounded (the tier needs a box)."""
        scales = self.compiled.scale_factors({"a": "arcmin", "r_peak": "arcmin"})
        out = []
        for name in ("a", "r_peak"):
            par = self.parameters[name]
            lo, hi = par.min * scales[name], par.max * scales[name]
            if not (0.0 < lo < hi < np.inf):
                return None
            out.append((float(lo), float(hi)))
        return tuple(out)

    def _tensor_eligible(self) -> bool:
        """The exact O(1)-per-walker tensor-Chebyshev path
        (ops/model_tensor.py): the star sum collapses into eleven channel
        functions tabulated over the (sigma_max^2, a, r_peak) prior box, so
        it needs the canonical layout plus finite positive priors on ``a``
        and ``r_peak``.  Same ``auto`` catalog-size threshold as the binned
        tier (below it the direct tier is exact and its O(N) cost is small);
        ``MCMC_LNPROB=tensor`` forces it at any size."""
        mode = lnprob_mode()
        if mode not in ("auto", "tensor"):
            return False
        if not self._canonical_layout():
            return False
        if self._tensor_bounds() is None:
            if mode == "tensor":
                raise ValueError(
                    "MCMC_LNPROB=tensor needs finite positive prior "
                    "bounds on 'a' and 'r_peak' (they define the table box).")
            return False
        if mode == "auto":
            return int(self._data_arrays["v"].shape[0]) >= 16384
        return True

    def build_lnprob_tensor(self):
        """Batched lnprob through the 3-D tensor-Chebyshev channel tables:
        exact in the star sum (unlike the radially-binned tier), O(1) per
        walker, and the dominant contraction is a single matrix product (see
        ops.model_tensor).  Walkers outside the (sigma_max, a, r_peak) table
        box get -inf — the box IS the prior box, so this coincides with the
        prior's own bound rejection."""
        import jax

        from ..ops.model_tensor import ModelTensorStats

        data = self.prepare_data(dict(self._data_arrays))
        s_max = self._sufficient_s_max()
        a_bounds, r_bounds = self._tensor_bounds()
        stats = ModelTensorStats.build(
            data["dxm"], data["dym"], data["v"], data["verr"] * data["verr"],
            a_bounds=a_bounds, r_bounds=r_bounds, mask=data.get("mask"),
            s_max=s_max, dtype=self.dtype)
        logger.info("tensor tier: degrees (%d, %d, %d), table %s",
                    stats.n_s, stats.n_a, stats.n_r, stats.table.shape)
        col_scale = self._internal_col_scale()
        lnprior_batched = jax.vmap(self.compiled.lnprior)
        def batched(thetas):
            lp = lnprior_batched(thetas)
            ti = thetas * col_scale[None, :]
            return jnp.where(jnp.isfinite(lp) & stats.in_box(ti),
                             lp + stats.lnlike(ti), -jnp.inf)

        return batched

    def _internal_col_scale(self):
        """Static per-column conversion factors to internal units (km/s, arcmin)."""
        a_scale = self.compiled.scale_factors({"a": "arcmin"})["a"]
        rp_scale = self.compiled.scale_factors({"r_peak": "arcmin"})["r_peak"]
        return jnp.asarray([1.0, 1.0, a_scale, 1.0, 1.0, rp_scale], self.dtype)

    def build_lnprob_sufficient(self):
        """Batched lnprob through the radially-binned Chebyshev moment tables:
        the star catalog is read once at build; each walker evaluation contracts
        a Chebyshev basis with the (n_bins, n_coef, 61) table — matrix work with no
        per-star reads (see ops.model_sufficient)."""
        import jax

        from ..ops.model_sufficient import ModelSufficientStats

        data = self.prepare_data(dict(self._data_arrays))
        s_max = self._sufficient_s_max()
        stats = ModelSufficientStats.build(
            data["dxm"], data["dym"], data["v"], data["verr"] * data["verr"],
            mask=data.get("mask"), s_max=s_max, dtype=self.dtype)
        col_scale = self._internal_col_scale()
        lnprior_batched = jax.vmap(self.compiled.lnprior)

        eval_ll = stats.lnlike

        def batched(thetas):
            lp = lnprior_batched(thetas)
            ll = eval_ll(thetas * col_scale[None, :])
            in_grid = thetas[:, 1] * thetas[:, 1] <= s_max
            return jnp.where(jnp.isfinite(lp) & in_grid, lp + ll, -jnp.inf)

        return batched

    def _direct_lnlike(self, thetas, data):
        """(W,) log-likelihood of the canonical layout over ``data``'s stars.

        Lowered for a CUDA device it is the fused kernel
        (ops.lnlike_kernels.model_lnlike_batched); on any other platform it is
        the plain masked sum of :meth:`lnlike_terms`, which is also the
        reference the kernel is tested against."""
        import jax

        from ..ops.lnlike_kernels import model_lnlike_batched

        col_scale = self._internal_col_scale()
        mask = data.get("mask", jnp.ones_like(data["v"]))

        def fused(t):
            dxm, dym = data["dxm"], data["dym"]
            return model_lnlike_batched(t * col_scale[None, :], dxm, dym,
                                        dxm * dxm + dym * dym, data["v"],
                                        data["verr"] * data["verr"], mask)

        def plain(t):
            return jax.vmap(lambda th: masked_sum(
                self.lnlike_terms(self.scaled_values(th), data), data))(t)

        return jax.lax.platform_dependent(thetas, cuda=fused, default=plain)

    def build_lnlike_partial_batched(self):
        """Per-shard ModelFit partial sums (see Runner hook): the direct
        tier's star reduction is additive, so each sp-shard evaluates its
        slice with the fused kernel and the partials psum over the mesh."""
        if not self._canonical_layout():
            return None
        return self._direct_lnlike

    def build_lnprob_batched(self):
        import jax

        if self._tensor_eligible():
            return self.build_lnprob_tensor()
        if self._sufficient_eligible():
            return self.build_lnprob_sufficient()
        if not self._canonical_layout():
            return super().build_lnprob_batched()

        data = self.prepare_data(dict(self._data_arrays))
        lnprior_batched = jax.vmap(self.compiled.lnprior)

        def batched(thetas):
            lp = lnprior_batched(thetas)
            return jnp.where(jnp.isfinite(lp),
                             lp + self._direct_lnlike(thetas, data), -jnp.inf)

        return batched

    # ------------------------------------------------------------------ post-processing
    def create_profiles(self, chains, n_burn, radii=None, filename=None) -> Table:
        """Posterior -> radial v_rot / sigma profiles with 1- and 3-sigma bands
        (reference model.py:225-317); vectorised over all posterior samples."""
        chains = np.asarray(chains)
        flat = {}
        i = 0
        for name, par in self.parameters.items():
            if par.fixed:
                flat[name] = np.asarray(par.value)
            else:
                flat[name] = chains[:, n_burn:, i].reshape(-1)
                i += 1

        if radii is None:
            radii = u.Quantity(np.logspace(-1, 2.5, 50), u.arcsec)
        radii = u.Quantity(radii, u.arcsec) if not isinstance(radii, u.Quantity) else radii

        r_unit_peak = self.parameters["r_peak"].unit
        r = radii.to(r_unit_peak).value[:, None]
        v_max = np.sqrt(flat["v_maxx"] ** 2 + flat["v_maxy"] ** 2)
        v_rot = 2.0 * (v_max / flat["r_peak"]) * r / (1.0 + (r / flat["r_peak"]) ** 2)

        r_a = radii.to(self.parameters["a"].unit).value[:, None]
        sigma = flat["sigma_max"] / (1.0 + r_a ** 2 / flat["a"] ** 2) ** 0.25

        pv = np.percentile(v_rot, [50, 16, 84, 0.15, 99.85], axis=-1)
        ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=-1)

        vel_unit = self.parameters["v_maxx"].unit
        profile = Table({"r": radii})
        for key, arr in (("v_rot", pv), ("sigma", ps)):
            profile[key] = u.Quantity(arr[0], vel_unit)
            profile[f"{key}_lower_1s"] = u.Quantity(arr[1], vel_unit)
            profile[f"{key}_upper_1s"] = u.Quantity(arr[2], vel_unit)
            profile[f"{key}_lower_3s"] = u.Quantity(arr[3], vel_unit)
            profile[f"{key}_upper_3s"] = u.Quantity(arr[4], vel_unit)

        if filename is not None:
            profile.write(filename, fmt="ascii.ecsv", overwrite=True)
        return profile


class _GaussianBackgroundMixin:
    """Shared pure pieces for models with a parametric Gaussian velocity background."""

    def membership_prior(self, p, data):
        from .base import density_membership
        return density_membership(data["density"], p["f_back"])

    def cluster_background_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_cluster = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        lnl_back = gaussian_lnlike_terms(data["v"], data["verr"],
                                         p["v_back"], p["sigma_back"])
        return lnl_cluster, lnl_back, self.membership_prior(p, data)

    def lnlike_terms(self, p, data):
        lnl_cluster, lnl_back, m = self.cluster_background_terms(p, data)
        if "ln_density" in data:
            # log-space mixture off the f64-accurate ln_density: NaN-free at
            # f_back = 0
            from .base import density_mixture_terms
            return density_mixture_terms(data["density"], data["ln_density"],
                                         p["f_back"], lnl_cluster, lnl_back)
        return mixture_lnlike_terms(lnl_cluster, lnl_back, m)

    def calculate_membership_probabilities(self, chain, n_burn):
        bestfit = self.compute_bestfit_values(chain=chain, n_burn=n_burn)
        theta = np.array([bestfit.value(n)[0] for n in self.fitted_parameters])
        p = self.scaled_values(jnp.asarray(theta, dtype=self.dtype))
        lnl_c, lnl_b, m = self.cluster_background_terms(p, self._data_arrays)
        lnl_c, lnl_b, m = map(np.asarray, (lnl_c, lnl_b, m))
        peak = np.maximum(lnl_c, lnl_b)
        num = m * np.exp(lnl_c - peak)
        return num / (num + (1.0 - m) * np.exp(lnl_b - peak))


class _DensityMixtureMixin:
    """Shared data preparation of the two density-mixture ModelFit variants."""

    def prepare_data(self, data):
        from .base import with_density_logs
        return with_density_logs(super().prepare_data(data), self.dtype)


class ModelFitGB(_DensityMixtureMixin, _GaussianBackgroundMixin, ModelFit):
    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["v_back", "sigma_back", "f_back"]
    OBSERVABLES = dict(ModelFit.OBSERVABLES, density=None)
    INTERNAL_UNITS = dict(ModelFit.INTERNAL_UNITS, v_back="km/s", sigma_back="km/s")
    parameters_file = "model_with_background.json"

    def __init__(self, data, parameters=None, **kwargs):
        background = kwargs.pop("background", None)
        if background is not None:
            logger.error("Class %s does not support additional background components.",
                         type(self).__name__)
        super().__init__(data=data, parameters=parameters, **kwargs)


class ModelFitConstantBackground(_DensityMixtureMixin, ModelFit):
    """ModelFit + non-parametric fixed background: per-star background likelihoods are
    precomputed once from a background callable; only the mixing weight ``f_back`` is
    sampled (reference model.py:513-623)."""

    MODEL_PARAMETERS = ModelFit.MODEL_PARAMETERS + ["f_back"]
    OBSERVABLES = dict(ModelFit.OBSERVABLES, density=None)
    parameters_file = "model_with_background.json"

    def __init__(self, data, background, parameters=None, **kwargs):
        super().__init__(data=data, parameters=parameters, **kwargs)
        self.fixed_background = background
        lnl_back = np.asarray(background(data.data["v"], data.data["verr"]),
                              dtype=np.float64)
        self._data_arrays["lnlike_fixed_background"] = jnp.asarray(lnl_back, self.dtype)

    def membership_prior(self, p, data):
        from .base import density_membership
        return density_membership(data["density"], p["f_back"])

    def lnlike_terms(self, p, data):
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_cluster = gaussian_lnlike_terms(data["v"], data["verr"], v_los, sigma_los)
        if "ln_density" in data:
            from .base import density_mixture_terms
            return density_mixture_terms(data["density"], data["ln_density"],
                                         p["f_back"], lnl_cluster,
                                         data["lnlike_fixed_background"])
        m = self.membership_prior(p, data)
        return mixture_lnlike_terms(lnl_cluster, data["lnlike_fixed_background"], m)

    def lnlike_fn(self, p, data, no_sum: bool = False):
        terms = self.lnlike_terms(p, data)
        if no_sum:
            return terms
        return masked_sum(terms, data)

    def calculate_membership_probabilities(self, chain, n_burn):
        bestfit = self.compute_bestfit_values(chain=chain, n_burn=n_burn)
        theta = np.array([bestfit.value(n)[0] for n in self.fitted_parameters])
        p = self.scaled_values(jnp.asarray(theta, dtype=self.dtype))
        data = self._data_arrays
        v_los = self.rotation_field(p, data)
        sigma_los = self.dispersion_field(p, data)
        lnl_c = np.asarray(gaussian_lnlike_terms(data["v"], data["verr"],
                                                 v_los, sigma_los))
        lnl_b = np.asarray(data["lnlike_fixed_background"])
        m = np.asarray(self.membership_prior(p, data))
        peak = np.maximum(lnl_c, lnl_b)
        num = m * np.exp(lnl_c - peak)
        return num / (num + (1.0 - m) * np.exp(lnl_b - peak))
