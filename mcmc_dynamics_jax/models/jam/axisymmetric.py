"""Axisymmetric JAM model classes.

JAX reimplementation of the reference's ``analysis/cjam/axisymmetric.py``: the
likelihood evaluates anisotropic Jeans velocity moments of MGE models (via the pure
JAX engine in :mod:`.moments`, replacing the external C ``cjam`` library) and compares
them to per-star radial velocities.

Key reference semantics preserved (with file:line citations):
* intrinsic flattening ``barq`` -> inclination through the median observed axis ratio:
  ``incl = arccos(sqrt((q_med^2 - barq^2)/(1 - barq^2)))`` (axisymmetric.py:237-241);
* rotation parametrised as (kappa_x, kappa_y): amplitude ``kappa`` and position angle
  ``theta_0`` rotate the star frame (axisymmetric.py:260-271);
* model mean velocity ``vz - delta_v``; models with ``v2zz <= vz^2`` are rejected
  (-inf), as are failed deprojections (axisymmetric.py:299-316);
* optional MGE grid keyed by centre position: the nearest grid point's MGE is used.
  Unlike the reference (file I/O per likelihood call, axisymmetric.py:245-254) the
  grid is pre-stacked into arrays and selected by ``argmin`` *inside* jit;
* ``create_profiles`` reconstructs radial v_rot/sigma profiles from posterior samples
  on an (r, theta) polar grid — here a single vmapped forward pass instead of a
  50-process pool (axisymmetric.py:391-397).
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .moments import jam_los_moments
from ..base import Runner, gaussian_lnlike_terms, mixture_lnlike_terms
from ... import units as u
from ...utils.coordinates import xy_offset_rad
from ...utils.mge import MgeReader, stack_mge_grid
from ...utils.morphology import find_barq_limits
from ...utils.table import Table

logger = logging.getLogger(__name__)

__all__ = ["Axisymmetric"]

_ARCSEC_PER_RAD = 180.0 * 3600.0 / math.pi

# the JamGridSpec fields that are per-star (everything else in the spec is
# star-independent grid geometry); these are what the star-sharded path
# slices over the sp mesh axis
_GRID_STAR_COLUMNS = ("t_star", "cos_even", "sin_even", "cos_odd", "sin_odd")


class Axisymmetric(Runner):
    MODEL_PARAMETERS = ["d", "mlr", "barq", "kappa_x", "kappa_y", "beta", "mbh",
                        "ra_center", "dec_center", "rbh", "delta_v"]
    OBSERVABLES = {"ra": "deg", "dec": "deg", "v": "km/s", "verr": "km/s"}
    INTERNAL_UNITS = {"d": "kpc", "mbh": "solMass", "rbh": "arcsec",
                      "delta_v": "km/s", "ra_center": "rad", "dec_center": "rad"}
    parameters_file = "axisymmetric.json"

    # quadrature orders of the JAM engine (see moments.jam_los_moments).
    # The defaults are CERTIFIED AT POSTERIOR LEVEL (round 3): n_u = 16 left
    # ~1e-3 relative sigma error, which shifted posterior medians by up to
    # ~0.9 posterior sigma on an omega-Cen-like fit — the same order as the
    # statistical error.  Gauss-Legendre converges steeply here: n_u = 24,
    # n_zeta = 32 reaches <= 2e-5 relative sigma over r = 0.3-300 arcsec,
    # incl = 45-88 deg, flattened multi-component MGEs (and <= 8e-4 with a
    # black hole, via the BH-aware LOS scale in moments.py), making the
    # residual posterior bias << 0.1 sigma
    # (tests/test_axisymmetric.py::TestQuadraturePosteriorAccuracy).  Cost is
    # ~2x the old (16, 24) default — accuracy is the right default; lower the
    # knobs explicitly for quick-look work.
    n_u = 24
    n_zeta = 32

    def __init__(self, data, parameters=None, mge_mass: Optional[MgeReader] = None,
                 mge_lum: Optional[MgeReader] = None, mge_files: Optional[dict] = None,
                 **kwargs):
        super().__init__(data=data, parameters=parameters, **kwargs)

        assert mge_mass is None or isinstance(mge_mass, MgeReader)
        assert mge_lum is None or isinstance(mge_lum, MgeReader)
        self.mge_mass = mge_mass
        self.mge_lum = mge_lum
        if mge_mass is None or mge_lum is None:
            assert mge_mass is None and mge_lum is None and mge_files is not None, \
                ("if 'mge_lum' or 'mge_mass' is None, both must be None and "
                 "'mge_files' must be given.")
        self.use_mge_grid = mge_files is not None
        self.mge_files = mge_files

        if self.use_mge_grid:
            (self._grid_offsets, self._grid_lum_i, self._grid_lum_s,
             self._grid_lum_q, self._grid_mass_i, self._grid_mass_s,
             self._grid_mass_q) = stack_mge_grid(mge_files)
            # median q from the grid point closest to the nominal centre
            ra0 = self.parameters["ra_center"].value
            dec0 = self.parameters["dec_center"].value
            idx = int(np.argmin(np.hypot(self._grid_offsets[:, 0] - ra0,
                                         self._grid_offsets[:, 1] - dec0)))
            q_values = self._grid_lum_q[idx][self._grid_lum_i[idx] > 0]
        else:
            q_values = self.mge_lum.as_arrays()[2]

        self.median_q = float(np.median(q_values))
        self.min_q = float(np.min(q_values))
        find_barq_limits(q_values, parameters=self.parameters)
        self._compiled = None  # bounds changed -> recompile
        # (No float32 radius limit: the moment engine factors the per-star
        # dominant tracer exponent out of numerators and normalisation, so a
        # star at ANY radius gets finite, correct moments in float32 — see
        # moments.py "underflow-proof scaling" and tests/test_f32.py.)

    # ------------------------------------------------------------------ pure pieces
    def _inclination(self, barq):
        """barq -> inclination (reference axisymmetric.py:237-241), trace-safe."""
        barq = jnp.minimum(barq, 1.0 - 1e-9)
        arg = (self.median_q ** 2 - barq ** 2) / (1.0 - barq ** 2)
        return jnp.arccos(jnp.sqrt(jnp.clip(arg, 0.0, 1.0)))

    def _rotated_coords_arcsec(self, p, data):
        """Star offsets rotated into the kappa-defined frame, in arcsec (pure)."""
        if "dxr" in data:
            dx, dy = data["dxr"], data["dyr"]
        elif "fc_dx0" in data:
            # free centre: exact trig-identity evaluation (Runner hook;
            # arcmin constants -> arcsec), per-walker trig only
            dx, dy = self.freecenter_offsets_arcmin(p, data)
            dx = dx * 60.0
            dy = dy * 60.0
        else:
            dx, dy = xy_offset_rad(data["ra"], data["dec"],
                                   p["ra_center"], p["dec_center"], xp=jnp)
            dx = dx * _ARCSEC_PER_RAD
            dy = dy * _ARCSEC_PER_RAD
        theta0 = jnp.arctan2(p["kappa_y"], p["kappa_x"])
        cos0, sin0 = jnp.cos(theta0), jnp.sin(theta0)
        x = dx * cos0 + dy * sin0
        y = -dx * sin0 + dy * cos0
        return x, y

    def prepare_data(self, data):
        if self.center_is_fixed():
            dx, dy = self.fixed_center_offsets()
            data["dxr"] = jnp.asarray(dx * _ARCSEC_PER_RAD, self.dtype)
            data["dyr"] = jnp.asarray(dy * _ARCSEC_PER_RAD, self.dtype)
            spec = self._jam_grid_spec()
            if spec is not None:
                # ship the grid tier's per-star interpolation bases as data
                # columns so the star-sharded path can slice them over sp
                # (the SAME device arrays the closure spec holds — no copy;
                # paths that keep the spec as closure constants simply never
                # read these and XLA dead-code-eliminates them)
                for name in _GRID_STAR_COLUMNS:
                    data[f"jam_{name}"] = getattr(spec, name)
        else:
            # free centre: exact trig-identity star constants (Runner hook)
            data = self.add_freecenter_columns(data)
        return data

    def _grid_index(self, p):
        """Nearest grid point to the proposed centre (THE grid selection: every
        centre-dependent grid lookup — MGE arrays, profile anchors — must go
        through this one function so they can never disagree)."""
        offs = jnp.asarray(self._grid_offsets, self.dtype)
        ra_deg = p["ra_center"] * (180.0 / jnp.pi)
        dec_deg = p["dec_center"] * (180.0 / jnp.pi)
        return jnp.argmin((offs[:, 0] - ra_deg) ** 2 + (offs[:, 1] - dec_deg) ** 2)

    def _select_mge(self, p):
        """Current MGE component arrays (single profile, or in-jit grid selection)."""
        if not self.use_mge_grid:
            li, ls, lq = self.mge_lum.as_arrays()
            mi, ms, mq = self.mge_mass.as_arrays()
            to = lambda a: jnp.asarray(a, self.dtype)
            return to(li), to(ls), to(lq), to(mi), to(ms), to(mq)
        idx = self._grid_index(p)
        take = lambda a: jnp.asarray(a, self.dtype)[idx]
        return (take(self._grid_lum_i), take(self._grid_lum_s),
                take(self._grid_lum_q), take(self._grid_mass_i),
                take(self._grid_mass_s), take(self._grid_mass_q))

    def jam_parameters(self, p):
        """Hook mapping sampled parameters -> (beta, kappa, mscale) per component.

        The base class uses global values; AnalyticalProfiles overrides with radial
        profiles assigned per MGE component."""
        kappa = jnp.sqrt(p["kappa_x"] ** 2 + p["kappa_y"] ** 2)
        return p["beta"], kappa, p["mlr"]

    def _moments_at(self, p, x, y):
        """Engine call at arbitrary MODEL-FRAME positions (pure): the one
        funnel for the likelihood's moment evaluations, shared by the direct
        per-star path and the polar-grid tier."""
        lum_i, lum_s, lum_q, mass_i, mass_s, mass_q = self._select_mge(p)
        incl = self._inclination(p["barq"])
        beta, kappa, mscale = self.jam_parameters(p)
        res = jam_los_moments(x, y, lum_i, lum_s, lum_q, mass_i, mass_s, mass_q,
                              d=p["d"], beta=beta, kappa=kappa, mscale=mscale,
                              incl=incl, mbh=p["mbh"], rbh=p["rbh"],
                              n_u=self.n_u, n_zeta=self.n_zeta)
        return res.vz, res.v2zz, res.valid

    def model_moments(self, p, data):
        """(vz, v2zz, valid) at every star for the current parameters (pure)."""
        x, y = self._rotated_coords_arcsec(p, data)
        return self._moments_at(p, x, y)

    def _terms_from_moments(self, p, data, vz, v2zz, valid):
        """Per-star terms from LOS moments: validity mapping, Gaussian terms,
        optional fixed-background mixture (reference axisymmetric.py:299-316)."""
        sigma2 = v2zz - vz * vz
        ok = valid & jnp.all(sigma2 > 0) & jnp.all(jnp.isfinite(v2zz))
        safe_sigma = jnp.sqrt(jnp.maximum(sigma2, 1e-12))
        terms = gaussian_lnlike_terms(data["v"], data["verr"],
                                      vz - p["delta_v"], safe_sigma)
        if "lnlike_background" in data:
            terms = mixture_lnlike_terms(terms, data["lnlike_background"],
                                         data["pmember"])
        return jnp.where(ok, terms, -jnp.inf)

    def lnlike_terms(self, p, data):
        return self._terms_from_moments(p, data, *self.model_moments(p, data))

    # big-ensemble memory containment: the moment engine materialises the
    # (u-node x mass-component, star x LOS-node) pair table PER WALKER
    # (~6 MB at 1e3 stars, n_u=24, n_zeta=32), so a plain vmap over a
    # 2048-walker ensemble wants >= 12 GB of HBM for the tables alone and
    # OOMs.  Chunking the walker axis with lax.map(batch_size=) caps the
    # live footprint at lnprob_chunk walkers AND sets the XLA program shape
    # of the per-chunk contraction.  64 was tuned on an earlier accelerator
    # and is untuned on the current card: re-derive it with
    # tools/probe_jam.py before relying on it.
    lnprob_chunk = 64

    # polar-grid moment tier (models/jam/grid.py): per walker the engine runs
    # at n_r x n_phi quarter-plane points instead of N stars and the star
    # moments come from one interpolation matmul — JAM cost decoupled
    # from the catalog size.  Auto-selected for large fixed-centre catalogs;
    # MCMC_JAM=grid|direct forces/disables it.  Default orders measured
    # in tools/probe_jam_grid.py and certified in tests/test_jam_grid.py:
    # the angular cosine series of log v2zz needs ~12 harmonics at the
    # edge-on/faint-edge corner, while the radial decay is only ~d^-3 — the
    # JAM rotation model vbar_phi = kappa sqrt(max(0, <v_phi^2> -
    # b sigma_z^2)) has C^(1/2) kinks — so most of the budget goes into
    # radial nodes: at (128, 12) the tier's worst-case moment error EQUALS
    # the direct engine's own quadrature error (dvz 8.6e-4, dsig 5.1e-4
    # dispersion-relative) over the full incl/beta/kappa/BH box.  The
    # star-sharded (multi-device) path rides the tier too: each sp rank
    # repeats the star-independent G-point grid solve per walker and
    # interpolates only its local star slice (build_lnlike_partial_batched).
    jam_grid_orders = (128, 12)
    jam_grid_min_stars = 4096

    # grid-tier walker chunk, tuned SEPARATELY from the direct path's
    # lnprob_chunk: per walker the grid path solves G = n_r x n_phi ~ 1536
    # positions (~9 MB of pair tables, vs ~6 MB at the direct row's 1e3
    # stars), so the footprint-vs-fusion balance shifts.  32 was tuned on an
    # earlier accelerator and is untuned on the current card: re-derive it
    # with tools/probe_jam_grid_chunk.py before relying on it.
    jam_grid_chunk = 32

    def _jam_grid_spec(self):
        """The polar-grid interpolation spec, or None for the direct path."""
        import os

        mode = os.environ.get("MCMC_JAM", "auto")
        if mode not in ("auto", "grid", "direct"):
            raise ValueError(f"MCMC_JAM={mode!r}: use auto|grid|direct.")
        if mode == "direct":
            return None
        # the grid path reproduces Axisymmetric's moment->terms pipeline;
        # subclasses that reroute it must either keep the direct evaluation
        # or supply their own grid evaluation via _grid_lnlike_terms
        # (ChemoProfiles does: one grid solve per population).  The gate is
        # MRO-positional: the _grid_lnlike_terms override must be defined at
        # or below the class that last rerouted lnlike_terms/model_moments —
        # a subclass of a grid-capable model that overrides lnlike_terms
        # again would otherwise inherit a stale grid evaluation and silently
        # diverge from its own direct path.
        mro = type(self).__mro__

        def definer(name):
            for klass in mro:
                if name in vars(klass):
                    return klass
            return Axisymmetric

        reroute_cls = min(definer("lnlike_terms"), definer("model_moments"),
                          key=mro.index)
        grid_cls = definer("_grid_lnlike_terms")
        reroutes = reroute_cls is not Axisymmetric
        grid_capable = (grid_cls is not Axisymmetric
                        and mro.index(grid_cls) <= mro.index(reroute_cls))
        if reroutes and not grid_capable:
            if mode == "grid":
                raise ValueError(
                    f"MCMC_JAM=grid: {reroute_cls.__name__} overrides the "
                    "moment->likelihood pipeline without a matching grid-tier "
                    "evaluation (_grid_lnlike_terms defined at or below it); "
                    "the grid tier only serves models whose _grid_lnlike_terms "
                    "is in sync with their lnlike_terms/model_moments.")
            return None
        if not self.center_is_fixed():
            if mode == "grid":
                raise ValueError(
                    "MCMC_JAM=grid needs a fixed cluster centre (the "
                    "per-star radial/angular bases are precomputed).")
            return None
        if mode == "auto" and self.n_data < self.jam_grid_min_stars:
            return None

        from .grid import JamGridSpec

        # key on the CENTRE as well as the orders: the per-star bases are
        # built from the fixed-centre offsets, so mutating ra/dec_center on a
        # built fit (then re-running — _compiled_fp rebuilds the lnprob) must
        # rebuild the spec too, or the tier would silently interpolate at the
        # old star positions
        ra_c = float(self.parameters["ra_center"].quantity.to(u.rad).value)
        dec_c = float(self.parameters["dec_center"].quantity.to(u.rad).value)
        key = (tuple(int(v) for v in self.jam_grid_orders), ra_c, dec_c)
        cached = getattr(self, "_jam_grid_cache", None)
        if cached is None or cached[0] != key:
            dx, dy = self.fixed_center_offsets()
            spec = JamGridSpec.build(np.asarray(dx) * _ARCSEC_PER_RAD,
                                     np.asarray(dy) * _ARCSEC_PER_RAD,
                                     n_r=key[0][0], n_phi=key[0][1],
                                     dtype=self.dtype)
            logger.info("JAM grid tier: %d stars -> %d x %d polar grid",
                        self.n_data, key[0][0], key[0][1])
            cached = (key, spec)
            self._jam_grid_cache = cached
        return cached[1]

    def _grid_lnlike_terms(self, spec, p, data, floor):
        """Per-star lnlike terms through the polar-grid tier.  Subclasses
        that reroute the moment->likelihood pipeline (ChemoProfiles) override
        this to stay grid-eligible."""
        from .grid import jam_grid_moments

        theta0 = jnp.arctan2(p["kappa_y"], p["kappa_x"])
        vz, v2zz, valid = jam_grid_moments(
            spec, lambda gx, gy: self._moments_at(p, gx, gy), theta0,
            floor=floor)
        return self._terms_from_moments(p, data, vz, v2zz, valid)

    def _grid_floor(self) -> float:
        """Likelihood-natural log floor of the grid tier: below the smallest
        measurement variance, sigma_model^2 is invisible in verr^2 + sigma^2.
        Computed from the FULL catalog so every sp shard of a sharded run
        interpolates the identical field."""
        return max(float(np.min(np.asarray(self._data_arrays["verr"])) ** 2),
                   1e-12)

    def build_lnlike_partial_batched(self):
        """Fused per-shard partial lnlike sums through the polar-grid tier
        (Runner hook; the star-sharded analog of the grid branch below): the
        grid solve is star-independent, so each sp rank repeats the tiny
        G-point moment solve per walker and interpolates only its LOCAL star
        slice — the per-star Chebyshev/harmonic bases arrive as sharded data
        columns (see prepare_data) and the partial sums psum over the mesh.
        Models where the grid tier does not apply (free centre, small
        catalogs, MCMC_JAM=direct, grid-incapable subclasses) return
        None and the sharded sampler falls back to the direct per-star
        evaluation.  Replaces the reference's 50-process cjam pool for the
        biggest catalogs (axisymmetric.py:391-397)."""
        import jax

        spec = self._jam_grid_spec()
        if spec is None:
            return None

        floor = self._grid_floor()
        chunk = int(self.jam_grid_chunk)

        def single(theta, local):
            lspec = spec._replace(**{name: local[f"jam_{name}"]
                                     for name in _GRID_STAR_COLUMNS})
            p = self.scaled_values(theta)
            terms = self._grid_lnlike_terms(lspec, p, local, floor)
            # select(), not multiply: -inf terms x 0 on padded lanes = NaN
            return jnp.sum(jnp.where(local["mask"] > 0, terms, 0.0))

        def fn(thetas, local):
            f = lambda t: single(t, local)
            if thetas.shape[0] <= chunk:
                return jax.vmap(f)(thetas)
            return jax.lax.map(f, thetas, batch_size=chunk)

        return fn

    def build_lnprob_batched(self):
        import jax

        spec = self._jam_grid_spec()
        if spec is None:
            fn = self.build_lnprob()
        else:
            compiled = self.compiled
            data = self.prepare_data(dict(self._data_arrays))
            from ..base import masked_sum

            floor = self._grid_floor()

            def fn(theta):
                lp = compiled.lnprior(theta)
                p = self.scaled_values(theta)
                lp = lp + self.extra_lnprior_fn(p)
                ll = masked_sum(self._grid_lnlike_terms(spec, p, data, floor),
                                data)
                return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)

        chunk = int(self.jam_grid_chunk if spec is not None
                    else self.lnprob_chunk)

        def batched(thetas):
            if thetas.shape[0] <= chunk:
                return jax.vmap(fn)(thetas)
            return jax.lax.map(fn, thetas, batch_size=chunk)

        return batched

    # ------------------------------------------------------------------ profiles
    def create_profiles(self, chain, n_burn: int, n_samples: int = 100, radii=None,
                        n_theta: int = 10, filename=None, n_threads: int = 1,
                        save_samples: bool = False, seed: int = 0) -> Table:
        """Posterior -> radial rotation/dispersion profiles on an (r, theta) polar
        grid; single vmapped JAM forward pass over the posterior samples
        (reference axisymmetric.py:318-447)."""
        del n_threads  # API compatibility; parallelism is vmap
        if radii is None:
            radii = u.Quantity(np.logspace(-1, 3, 200), u.arcsec)
        radii = u.Quantity(radii, u.arcsec)
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)

        x = (radii.value[:, None] * np.cos(theta)[None, :]).ravel()
        y = (radii.value[:, None] * np.sin(theta)[None, :]).ravel()

        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(seed)
        draws = flat[rng.integers(0, flat.shape[0], size=n_samples)]

        xj = jnp.asarray(x, self.dtype)
        yj = jnp.asarray(y, self.dtype)

        def forward(theta_vec):
            p = self.scaled_values(theta_vec)
            # per-sample MGE (single profile, or grid point nearest the sample's
            # centre — matching the lnlike selection, reference axisymmetric.py:374-378)
            lum_i, lum_s, lum_q, mass_i, mass_s, mass_q = self._select_mge(p)
            beta, kappa, mscale = self.jam_parameters(p)
            res = jam_los_moments(xj, yj, lum_i, lum_s, lum_q,
                                  mass_i, mass_s, mass_q,
                                  d=p["d"], beta=beta, kappa=kappa, mscale=mscale,
                                  incl=self._inclination(p["barq"]),
                                  mbh=p["mbh"], rbh=p["rbh"],
                                  n_u=self.n_u, n_zeta=self.n_zeta)
            return res.vz, res.v2zz

    # vmapped posterior-predictive fan-out (replaces the reference's 50-process pool)
        vz, v2zz = jax.jit(jax.vmap(forward))(jnp.asarray(draws, self.dtype))
        vz = np.asarray(vz)
        v2zz = np.asarray(v2zz)
        good = np.isfinite(vz).all(axis=1) & np.isfinite(v2zz).all(axis=1)
        vz, v2zz = vz[good], v2zz[good]
        sigma = np.sqrt(np.maximum(v2zz - vz ** 2, 0.0))

        pv = np.percentile(vz, [50, 16, 84, 0.15, 99.85], axis=0)
        ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=0)

        # rotation read along the positive x-axis (semi-major axis);
        # dispersion azimuthally averaged per radius
        semimajor = np.mod(np.arange(x.size), n_theta) == 0
        vz_radial = pv[:, semimajor]
        sig_radial = ps.reshape(5, radii.value.size, n_theta).mean(axis=2)

        profile = Table({"r": radii})
        for key, arr in (("v_rot", vz_radial), ("sigma", sig_radial)):
            profile[key] = u.Quantity(arr[0], u.km_per_s)
            profile[f"{key}_lower_1s"] = u.Quantity(arr[1], u.km_per_s)
            profile[f"{key}_upper_1s"] = u.Quantity(arr[2], u.km_per_s)
            profile[f"{key}_lower_3s"] = u.Quantity(arr[3], u.km_per_s)
            profile[f"{key}_upper_3s"] = u.Quantity(arr[4], u.km_per_s)

        if filename is not None:
            profile.write(filename, fmt="ascii.ecsv", overwrite=True)
        if save_samples and filename is not None:
            import pandas as pd
            frames = []
            for i in range(vz.shape[0]):
                frames.append(pd.DataFrame({"x": x, "y": y,
                                            "first_moment": vz[i],
                                            "second_moment": v2zz[i]}))
            import os
            pd.concat(frames, ignore_index=True).to_csv(
                os.path.splitext(filename)[0] + "_allsamples.csv", index=False)
        return profile

    def predict_fields(self, chain, n_burn: int, ra, dec,
                       n_samples: int = 200, seed: int = 0):
        """Posterior-predictive JAM (v_los, sigma_los) at arbitrary sky
        positions: one vmapped moment solve per posterior draw, with the
        per-sample kappa-frame rotation and (in grid mode) MGE selection the
        likelihood itself uses.  Mean velocity follows the lnlike convention
        ``vz - delta_v``."""
        import jax

        ra_q = ra if isinstance(ra, u.Quantity) else u.Quantity(ra, "deg")
        dec_q = dec if isinstance(dec, u.Quantity) else u.Quantity(dec, "deg")
        pdata = {"ra": jnp.asarray(np.atleast_1d(ra_q.to("rad").value),
                                   self.dtype),
                 "dec": jnp.asarray(np.atleast_1d(dec_q.to("rad").value),
                                    self.dtype)}

        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(seed)
        draws = jnp.asarray(flat[rng.integers(0, flat.shape[0], n_samples)],
                            self.dtype)

        def forward(theta_vec):
            p = self.scaled_values(theta_vec)
            x, y = self._rotated_coords_arcsec(p, pdata)
            lum_i, lum_s, lum_q, mass_i, mass_s, mass_q = self._select_mge(p)
            beta, kappa, mscale = self.jam_parameters(p)
            res = jam_los_moments(x, y, lum_i, lum_s, lum_q,
                                  mass_i, mass_s, mass_q,
                                  d=p["d"], beta=beta, kappa=kappa,
                                  mscale=mscale,
                                  incl=self._inclination(p["barq"]),
                                  mbh=p["mbh"], rbh=p["rbh"],
                                  n_u=self.n_u, n_zeta=self.n_zeta)
            sigma2 = res.v2zz - res.vz ** 2
            return res.vz - p["delta_v"], jnp.sqrt(jnp.maximum(sigma2, 0.0))

        v, s = jax.jit(jax.vmap(forward))(draws)
        return self._predictive_table(ra_q, dec_q, np.asarray(v), np.asarray(s))

    def mass_scale(self, p):
        """Per-mass-component M/L scale for the mass posterior.  Subclasses
        whose kinematics are parametrised differently (ChemoProfiles) override
        this without needing the full (beta, kappa, mscale) tuple."""
        return self.jam_parameters(p)[2]

    def program_cache_salt(self) -> tuple:
        """MGE tables + quadrature orders are closure constants (see
        Runner.program_cache_salt)."""
        import hashlib

        h = hashlib.sha1()
        if self.use_mge_grid:
            arrays = (self._grid_offsets, self._grid_lum_i, self._grid_lum_s,
                      self._grid_lum_q, self._grid_mass_i, self._grid_mass_s,
                      self._grid_mass_q)
        else:
            arrays = (*self.mge_lum.as_arrays(), *self.mge_mass.as_arrays())
        for a in arrays:
            h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
        import os
        return (h.hexdigest(), self.n_u, self.n_zeta, int(self.lnprob_chunk),
                os.environ.get("MCMC_JAM", "auto"),
                tuple(int(v) for v in self.jam_grid_orders),
                int(self.jam_grid_min_stars), int(self.jam_grid_chunk))

    def compute_mass_posterior(self, chain, n_burn: int, n_samples: int = 1000,
                               seed: int = 0) -> np.ndarray:
        """Posterior samples of the total cluster mass: per-component M/L scale
        times component luminous mass, M_k = 2 pi Sigma0_k sigma_k^2 q_k (in pc).
        (The capability behind the reference driver's mass posterior,
        bin/run.py:273-356.)"""
        from .moments import PC_PER_ARCSEC_PER_KPC

        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(seed)
        draws = flat[rng.integers(0, flat.shape[0], size=n_samples)]

        grid = self.use_mge_grid
        if not grid:
            mi, ms, mq = self.mge_mass.as_arrays()

        masses = np.zeros(n_samples)
        for n, theta in enumerate(draws):
            p_jax = self.scaled_values(jnp.asarray(theta))
            if grid:
                # the SAME grid point the likelihood used for this sample's
                # centre offset (_select_mge), not a fixed corner of the grid
                idx = int(np.asarray(self._grid_index(p_jax)))
                mi = self._grid_mass_i[idx]
                ms = self._grid_mass_s[idx]
                mq = self._grid_mass_q[idx]
            p = {k: float(np.asarray(v)) for k, v in p_jax.items()}
            mscale = np.asarray(self.mass_scale(
                {k: jnp.asarray(v) for k, v in p.items()}))
            pc = p["d"] * PC_PER_ARCSEC_PER_KPC
            comp_mass = 2.0 * np.pi * mi * (ms * pc) ** 2 * mq
            masses[n] = float(np.sum(np.broadcast_to(mscale, comp_mass.shape)
                                     * comp_mass))
        return masses

    def calculate_mlr_profile(self, mlr, radii=None, mge_mass=None):
        """Radial mass-to-light-ratio profile from per-component scale factors
        (reference axisymmetric.py:449-503)."""
        _mge = self.mge_mass if mge_mass is None else mge_mass
        i_arr, s_arr, q_arr = _mge.as_arrays()
        if radii is None:
            radii = np.logspace(np.log10(s_arr.min()) - 0.5,
                                np.log10(s_arr.max()) + 0.5, 50)
        radii = u.as_value(radii, u.arcsec)
        mlr = np.atleast_1d(np.asarray(
            mlr.value if isinstance(mlr, u.Quantity) else mlr, dtype=np.float64))
        assert len(mlr) == len(i_arr), \
            "Length of parameter <mlr> must match no. of MGE components."
        gaussians = i_arr[None, :] * np.exp(
            -0.5 * (radii[:, None] / (np.sqrt(1.0 - q_arr[None, :]) * s_arr[None, :]
                                      + 1e-300)) ** 2)
        profile = (gaussians * mlr[None, :]).sum(axis=1) / gaussians.sum(axis=1)
        return u.Quantity(radii, u.arcsec), profile
