"""Multi-population chemo-dynamical JAM models.

Modernised JAX reimplementation of the reference's ``analysis/cjam/chemo_profiles.py``
(which still targets a pre-Parameters API and cannot run against its own Runner — see
SURVEY.md stale-API ledger).  Capabilities preserved:

* ``n_pops`` stellar populations, each with its own rotation profile
  (``kappa_max_<p>``, ``logr_kappa_<p>`` in dex), metallicity Gaussian
  (``mu_feh_<p>``, ``sigma_feh_<p>``), and a mixing matrix ``h_<p><q>`` assigning a
  fraction of each population-tagged MGE component q to chemical population p
  (chemo_profiles.py:153-175); the last matrix row is derived so columns sum to 1;
* spatial membership priors from the population-tagged tracer MGE evaluated at the
  star positions (chemo_profiles.py:71-75);
* per-star likelihood = spatial x velocity x metallicity, log-sum-exp mixed over
  populations (chemo_profiles.py:203-272);
* ordering prior preventing populations from crossing in [Fe/H]
  (chemo_profiles.py:187-197).

Each population's JAM evaluation reuses the same mass model; only the tracer weights
and kappa profile change, so the populations are evaluated in a static Python loop of
pure JAM calls inside one trace.
"""

from __future__ import annotations

import logging
from string import ascii_lowercase

import numpy as np

import jax.numpy as jnp

from .axisymmetric import _ARCSEC_PER_RAD
from .moments import jam_los_moments
from .radial_profiles import AnalyticalProfiles
from ..base import gaussian_lnlike_terms
from ...parameters import Parameters
from ...utils.mge import MgeReader

logger = logging.getLogger(__name__)

__all__ = ["ChemoProfiles"]

_INF = float("inf")


class ChemoProfiles(AnalyticalProfiles):
    OBSERVABLES = {"ra": "deg", "dec": "deg", "v": "km/s", "verr": "km/s",
                   "feh": None, "feherr": None}

    def __init__(self, data, mge_mass: MgeReader, mge_lum: MgeReader,
                 parameters=None, n_pops: int = 2, **kwargs):
        self.n_pops = n_pops
        if parameters is None:
            parameters = self.default_parameters(n_pops)

        # grid mode is an AnalyticalProfiles feature the multi-population mixture
        # does not support: the per-pop spatial priors and kappa anchors are
        # derived from ONE population-tagged MGE at build time (VERDICT r1 weak 6)
        if kwargs.get("mge_files") is not None:
            raise ValueError(
                "ChemoProfiles does not support the centre-offset MGE grid "
                "('mge_files'); pass explicit mge_mass/mge_lum readers with a "
                "'pop' column on the luminous MGE.")
        if mge_lum is None or mge_mass is None:
            raise ValueError(
                "ChemoProfiles requires explicit mge_mass and mge_lum readers "
                "(the luminous one carrying per-component 'pop' tags).")

        # population tags on the tracer MGE
        if "pop" not in mge_lum.data:
            raise IOError('Missing population tags (column "pop") in luminosity MGE.')
        tags = np.asarray(mge_lum.data.value("pop"), dtype=int)
        if not np.array_equal(np.unique(tags), np.arange(n_pops)):
            raise IOError(f"Population tags inconsistent with {n_pops} populations.")

        super().__init__(data=data, parameters=parameters, mge_mass=mge_mass,
                         mge_lum=mge_lum, **kwargs)
        assert self.center_is_fixed(), \
            "ChemoProfiles requires a fixed cluster centre."
        self._pop_tags = tags

        # kappa anchor radii: computed within each population's component slice
        # (reference chemo_profiles.py:63-69)
        lum_i, lum_s, _ = mge_lum.as_arrays()
        x_kappa = np.zeros(len(lum_s))
        for p in range(n_pops):
            slc = tags == p
            x_kappa[slc] = self.calculate_x_values(lum_i[slc], lum_s[slc])
        self._x_kappa = x_kappa

        # spatial membership fractions per population at each star (static: centre
        # fixed), reference chemo_profiles.py:71-75
        dx, dy = self.fixed_center_offsets()
        x_arc = dx * _ARCSEC_PER_RAD
        y_arc = dy * _ARCSEC_PER_RAD
        total = np.zeros(self.n_data)
        per_pop = np.zeros((n_pops, self.n_data))
        for j, (i0, s0, q0) in enumerate(zip(lum_i, lum_s, mge_lum.as_arrays()[2])):
            comp = i0 * np.exp(-(x_arc ** 2 + y_arc ** 2 / q0 ** 2) / (2 * s0 ** 2))
            per_pop[tags[j]] += comp
            total += comp
        self._p_spatial = jnp.asarray(per_pop / np.maximum(total, 1e-300),
                                      self.dtype)

        # per-component population indicator matrix for the mixing weights
        self._pop_onehot = jnp.asarray(
            np.eye(n_pops)[:, tags], self.dtype)  # (n_pops, n_components)

    # ------------------------------------------------------------------ parameters
    @classmethod
    def default_parameters(cls, n_pops: int = 2) -> Parameters:
        """Build the parameter set programmatically (one block per population)."""
        params = Parameters()
        params.add("d", unit="kpc", min=0.0, label=r"$d$",
                   initials="rng.lognormal(size=n)")
        for name, label in (("mlr_0", r"$\Upsilon_{\rm 0}$"),
                            ("mlr_t", r"$\Upsilon_{\rm t}$"),
                            ("mlr_inf", r"$\Upsilon_\infty$")):
            params.add(name, min=0.0, label=label, initials="rng.lognormal(size=n)")
        params.add("r_mlr", unit="arcsec", min=0.0, label=r"$r_{\rm \Upsilon}$",
                   initials="rng.lognormal(size=n)")
        params.add("barq", min=0.0, max=1.0, label=r"$\bar{q}$",
                   initials="rng.random(size=n)")
        params.add("beta", max=1.0, label=r"$\beta$",
                   initials="rng.uniform(-0.5, 0.5, size=n)")
        params.add("mbh", unit="solMass", value=0.0, min=0.0, fixed=True,
                   label=r"$M_{\rm BH}$")
        params.add("rbh", unit="arcsec", value=1.0, min=0.0, fixed=True,
                   label=r"$r_{\rm BH}$")
        params.add("ra_center", unit="deg", min=0.0, max=360.0,
                   label=r"$\alpha_{\rm c}$")
        params.add("dec_center", unit="deg", min=-90.0, max=90.0,
                   label=r"$\delta_{\rm c}$")
        params.add("delta_v", unit="km/s", value=0.0, fixed=True,
                   label=r"$\Delta v$")

        letters = ascii_lowercase[:n_pops]
        for i, p in enumerate(letters):
            params.add(f"mu_feh_{p}", min=-1.0, max=1.0,
                       label=rf"$\mu_{{\rm chem.,\,{p.upper()}}}$",
                       initials=f"rng.uniform({-0.8 + 1.6 * i / n_pops:.3f}, "
                                f"{-0.8 + 1.6 * (i + 1) / n_pops:.3f}, size=n)")
            params.add(f"sigma_feh_{p}", min=0.0,
                       label=rf"$\sigma_{{\rm chem.,\,{p.upper()}}}$",
                       initials="0.1*rng.lognormal(size=n)")
            params.add(f"kappa_max_{p}",
                       label=rf"$\kappa_{{\rm max.,\,{p.upper()}}}$",
                       initials="rng.normal(size=n)")
            params.add(f"logr_kappa_{p}", unit="dex(arcmin)",
                       label=rf"$\log(r_{{\rm \kappa,\,{p.upper()}}})$",
                       initials="0.2*rng.normal(size=n)")
        # mixing matrix: rows a..(n_pops-1) free, last row derived column-wise.
        # Free-row initials draw U(0, 1/n_pops) so the derived last row
        # 1 - sum(h) is always positive: i.i.d. U(0,1) draws would violate the
        # simplex with probability 1/2 per column at n_pops = 3 and brick the
        # walker-initials prior check.
        last = letters[-1]
        for q in letters:
            for p in letters[:-1]:
                params.add(f"h_{p}{q}", value=1.0 / n_pops, min=0.0, max=1.0,
                           label=rf"$h_{{\rm {p.upper()}{q.upper()}}}$",
                           initials=f"rng.uniform(0.0, {1.0 / n_pops:.6f}, "
                                    "size=n)")
            expr = "1" + "".join(f" - h_{p}{q}" for p in letters[:-1])
            params.add(f"h_{last}{q}", min=0.0, max=1.0, expr=expr,
                       label=rf"$h_{{\rm {last.upper()}{q.upper()}}}$")
        return params

    @property
    def MODEL_PARAMETERS(self):  # noqa: N802 - class-attr parity with reference
        letters = ascii_lowercase[:self.n_pops]
        base = ["d", "mlr_0", "mlr_t", "mlr_inf", "r_mlr", "barq", "beta", "mbh",
                "rbh", "ra_center", "dec_center", "delta_v"]
        for p in letters:
            base += [f"mu_feh_{p}", f"sigma_feh_{p}", f"kappa_max_{p}",
                     f"logr_kappa_{p}"]
        for q in letters:
            base += [f"h_{p}{q}" for p in letters]
        return base

    @staticmethod
    def find_mge_peaks(sigma, intensity):
        """Reference-named alias (chemo_profiles.py:142-151) of the anchor-radius
        computation; note the reversed argument order of the original."""
        return AnalyticalProfiles.calculate_x_values(intensity, sigma)

    def prepare_data(self, data):
        """The spatial membership fractions are per-star state: ship them as
        a data column (star axis first) so star-sharded paths slice them over
        the sp mesh axis along with everything else; unsharded paths read the
        identical array (no copy — it is the closure constant transposed)."""
        data = super().prepare_data(data)
        data["p_spatial"] = self._p_spatial.T          # (N, n_pops)
        return data

    # ------------------------------------------------------------------ pure model
    def extra_lnprior_fn(self, p):
        """[Fe/H] ordering (populations must not cross, chemo_profiles.py:187-197)
        plus the positive-M/L prior of the parent."""
        base = AnalyticalProfiles.extra_lnprior_fn(self, p)
        letters = ascii_lowercase[:self.n_pops]
        ok = jnp.asarray(True)
        for a, b_ in zip(letters[:-1], letters[1:]):
            ok = ok & (p[f"mu_feh_{a}"] < p[f"mu_feh_{b_}"])
        return base + jnp.where(ok, 0.0, -jnp.inf)

    def mass_scale(self, p):
        """M/L scale per mass component (the chemo parameter set has no
        kappa_x/r_kappa, so the base jam_parameters hook does not apply)."""
        x_mlr = jnp.asarray(self._x_mlr, self.dtype)
        return self.mlr_profile(x_mlr, p["mlr_0"], p["mlr_t"], p["mlr_inf"],
                                p["r_mlr"])

    def predict_fields(self, chain, n_burn: int, ra, dec,
                       n_samples: int = 200, seed: int = 0):
        """Per-population posterior-predictive (v_los, sigma_los) at arbitrary
        sky positions: {pop_index: Table}, one vmapped moment solve per
        population per draw (the inherited single-field JAM version reads
        kappa_x/r_kappa, which the chemo parameter set does not have)."""
        import jax
        from ... import units as u

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

        letters = ascii_lowercase[:self.n_pops]
        lum_i, lum_s, lum_q = [jnp.asarray(a, self.dtype)
                               for a in self.mge_lum.as_arrays()]
        mass_i, mass_s, mass_q = [jnp.asarray(a, self.dtype)
                                  for a in self.mge_mass.as_arrays()]
        x_kappa = jnp.asarray(self._x_kappa, self.dtype)

        out = {}
        for i, pop in enumerate(letters):
            def forward(theta_vec, pop=pop):
                p = self.scaled_values(theta_vec)
                x, y = self._rotated_coords_no_rotation(p, pdata)
                h_row = jnp.stack([p[f"h_{pop}{q}"] for q in letters])
                weights = h_row @ self._pop_onehot
                mscale = self.mass_scale(p)
                r_kappa = 10.0 ** p[f"logr_kappa_{pop}"] * 60.0
                kappa = self.kappa_profile(x_kappa, p[f"kappa_max_{pop}"],
                                           r_kappa)
                res = jam_los_moments(x, y, lum_i * weights, lum_s, lum_q,
                                      mass_i, mass_s, mass_q, d=p["d"],
                                      beta=p["beta"], kappa=kappa,
                                      mscale=mscale,
                                      incl=self._inclination(p["barq"]),
                                      mbh=p["mbh"], rbh=p["rbh"],
                                      n_u=self.n_u, n_zeta=self.n_zeta)
                sigma2 = res.v2zz - res.vz ** 2
                return (res.vz - p["delta_v"],
                        jnp.sqrt(jnp.maximum(sigma2, 0.0)))

            v, s = jax.jit(jax.vmap(forward))(draws)
            out[i] = self._predictive_table(ra_q, dec_q, np.asarray(v),
                                            np.asarray(s))
        return out

    def _lnlike_terms_impl(self, p, data, eval_moments):
        """Shared multi-population mixture assembly.  ``eval_moments(at)``
        maps a per-population engine closure ``at(x, y) -> (vz, v2zz, valid)``
        to star-position moments — directly, or through the polar-grid tier
        (each population is still an axisymmetric JAM field, so the grid's
        bisymmetric harmonic representation applies per population)."""
        letters = ascii_lowercase[:self.n_pops]
        lum_i, lum_s, lum_q = [jnp.asarray(a, self.dtype)
                               for a in self.mge_lum.as_arrays()]
        mass_i, mass_s, mass_q = [jnp.asarray(a, self.dtype)
                                  for a in self.mge_mass.as_arrays()]
        incl = self._inclination(p["barq"])

        x_mlr = jnp.asarray(self._x_mlr, self.dtype)
        mscale = self.mlr_profile(x_mlr, p["mlr_0"], p["mlr_t"], p["mlr_inf"],
                                  p["r_mlr"])
        x_kappa = jnp.asarray(self._x_kappa, self.dtype)

        # per-star spatial fractions: from the (possibly sp-sharded) data
        # slice when present, else the full-catalog closure constant
        p_spatial = (data["p_spatial"].T if "p_spatial" in data
                     else self._p_spatial)             # (n_pops, N_local)

        valid = jnp.asarray(True)
        pop_lnlike = []
        for i, pop in enumerate(letters):
            # mixing weights per component: h_{pop, tag_of_component}
            h_row = jnp.stack([p[f"h_{pop}{q}"] for q in letters])   # (n_pops,)
            weights = h_row @ self._pop_onehot                        # (n_comp,)
            lum_i_pop = lum_i * weights

            r_kappa = 10.0 ** p[f"logr_kappa_{pop}"] * 60.0  # dex(arcmin) -> arcsec
            kappa = self.kappa_profile(x_kappa, p[f"kappa_max_{pop}"], r_kappa)

            def at(px, py, lum_i_pop=lum_i_pop, kappa=kappa):
                res = jam_los_moments(px, py, lum_i_pop, lum_s, lum_q,
                                      mass_i, mass_s, mass_q,
                                      d=p["d"], beta=p["beta"], kappa=kappa,
                                      mscale=mscale, incl=incl,
                                      mbh=p["mbh"], rbh=p["rbh"],
                                      n_u=self.n_u, n_zeta=self.n_zeta)
                return res.vz, res.v2zz, res.valid

            vz, v2zz, ok = eval_moments(at)
            sigma2 = v2zz - vz * vz
            valid = valid & ok & jnp.all(sigma2 > 0) \
                & jnp.all(jnp.isfinite(v2zz))
            sigma = jnp.sqrt(jnp.maximum(sigma2, 1e-12))

            like_spatial = h_row @ p_spatial                          # (N,)
            ln_v = gaussian_lnlike_terms(data["v"], data["verr"],
                                         vz - p["delta_v"], sigma)
            ln_feh = gaussian_lnlike_terms(data["feh"], data["feherr"],
                                           p[f"mu_feh_{pop}"],
                                           p[f"sigma_feh_{pop}"])
            pop_lnlike.append(jnp.log(jnp.maximum(like_spatial, 1e-300)) +
                              ln_v + ln_feh)

        stacked = jnp.stack(pop_lnlike)                               # (n_pops, N)
        peak = jnp.max(stacked, axis=0)
        terms = peak + jnp.log(jnp.sum(jnp.exp(stacked - peak), axis=0))
        return jnp.where(valid, terms, -jnp.inf)

    def lnlike_terms(self, p, data):
        x, y = self._rotated_coords_no_rotation(p, data)
        return self._lnlike_terms_impl(p, data, lambda at: at(x, y))

    def _grid_lnlike_terms(self, spec, p, data, floor):
        """Polar-grid tier (models/jam/grid.py), one grid solve per
        population.  Chemo models fix the morphological frame — no
        kappa-frame rotation — so the harmonic shift angle is zero and the
        grid (built from the same fixed-centre offsets the direct path
        evaluates at) interpolates each population's bisymmetric field
        directly."""
        from .grid import jam_grid_moments

        zero = jnp.zeros((), self.dtype)
        return self._lnlike_terms_impl(
            p, data, lambda at: jam_grid_moments(spec, at, zero, floor=floor))

    def _rotated_coords_no_rotation(self, p, data):
        """Chemo models fix the morphological frame: plain centre offsets in arcsec
        (the reference uses self.x/self.y directly, chemo_profiles.py:240)."""
        if "dxr" in data:
            return data["dxr"], data["dyr"]
        from ...utils.coordinates import xy_offset_rad
        dx, dy = xy_offset_rad(data["ra"], data["dec"],
                               p["ra_center"], p["dec_center"], xp=jnp)
        return dx * _ARCSEC_PER_RAD, dy * _ARCSEC_PER_RAD

    # ------------------------------------------------------------------ profiles
    def create_profiles(self, chain, n_burn: int, n_samples: int = 100, radii=None,
                        n_theta: int = 10, prefix=None, filename=None,
                        n_threads: int = 1, seed: int = 0):
        """Per-population radial v_rot/sigma profiles from posterior samples
        (reference chemo_profiles.py:302-419). Returns {pop_index: Table}.

        ``filename=`` (the base-class/driver spelling) is accepted as an alias
        for ``prefix=``: per-population tables are written next to it as
        ``<stem>_pop<i>.ecsv``, so polymorphic callers written against
        ``Axisymmetric.create_profiles`` work unchanged."""
        import os

        import jax
        from ... import units as u
        from ...utils.table import Table

        del n_threads
        if filename is not None and prefix is None:
            prefix = os.path.splitext(str(filename))[0]
        if radii is None:
            radii = u.Quantity(np.logspace(-1, 3, 200), u.arcsec)
        radii = u.Quantity(radii, u.arcsec)
        theta = np.linspace(0, 2 * np.pi, n_theta, endpoint=False)
        x = (radii.value[:, None] * np.cos(theta)[None, :]).ravel()
        y = (radii.value[:, None] * np.sin(theta)[None, :]).ravel()
        xj = jnp.asarray(x, self.dtype)
        yj = jnp.asarray(y, self.dtype)

        chain = np.asarray(chain)
        flat = chain[:, n_burn:, :].reshape(-1, chain.shape[-1])
        rng = np.random.default_rng(seed)
        draws = jnp.asarray(flat[rng.integers(0, flat.shape[0], size=n_samples)],
                            self.dtype)

        lum_i, lum_s, lum_q = [jnp.asarray(a, self.dtype)
                               for a in self.mge_lum.as_arrays()]
        mass_i, mass_s, mass_q = [jnp.asarray(a, self.dtype)
                                  for a in self.mge_mass.as_arrays()]
        letters = ascii_lowercase[:self.n_pops]
        x_mlr = jnp.asarray(self._x_mlr, self.dtype)
        x_kappa = jnp.asarray(self._x_kappa, self.dtype)

        profiles = {}
        for i, pop in enumerate(letters):
            def forward(theta_vec, pop=pop):
                p = self.scaled_values(theta_vec)
                h_row = jnp.stack([p[f"h_{pop}{q}"] for q in letters])
                weights = h_row @ self._pop_onehot
                mscale = self.mlr_profile(x_mlr, p["mlr_0"], p["mlr_t"],
                                          p["mlr_inf"], p["r_mlr"])
                r_kappa = 10.0 ** p[f"logr_kappa_{pop}"] * 60.0
                kappa = self.kappa_profile(x_kappa, p[f"kappa_max_{pop}"], r_kappa)
                res = jam_los_moments(xj, yj, lum_i * weights, lum_s, lum_q,
                                      mass_i, mass_s, mass_q, d=p["d"],
                                      beta=p["beta"], kappa=kappa, mscale=mscale,
                                      incl=self._inclination(p["barq"]),
                                      mbh=p["mbh"], rbh=p["rbh"],
                                      n_u=self.n_u, n_zeta=self.n_zeta)
                return res.vz, res.v2zz

            vz, v2zz = jax.jit(jax.vmap(forward))(draws)
            vz, v2zz = np.asarray(vz), np.asarray(v2zz)
            good = np.isfinite(vz).all(axis=1) & np.isfinite(v2zz).all(axis=1)
            vz, v2zz = vz[good], v2zz[good]
            sigma = np.sqrt(np.maximum(v2zz - vz ** 2, 0.0))
            pv = np.percentile(vz, [50, 16, 84, 0.15, 99.85], axis=0)
            ps = np.percentile(sigma, [50, 16, 84, 0.15, 99.85], axis=0)
            semimajor = np.mod(np.arange(x.size), n_theta) == 0
            vz_radial = pv[:, semimajor]
            sig_radial = ps.reshape(5, radii.value.size, n_theta).mean(axis=2)

            table = Table({"r": radii})
            for key, arr in (("v_rot", vz_radial), ("sigma", sig_radial)):
                table[key] = u.Quantity(arr[0], u.km_per_s)
                table[f"{key}_lower_1s"] = u.Quantity(arr[1], u.km_per_s)
                table[f"{key}_upper_1s"] = u.Quantity(arr[2], u.km_per_s)
                table[f"{key}_lower_3s"] = u.Quantity(arr[3], u.km_per_s)
                table[f"{key}_upper_3s"] = u.Quantity(arr[4], u.km_per_s)
            profiles[i] = table
            if prefix is not None:
                table.write(f"{prefix}_pop{i}.ecsv", fmt="ascii.ecsv")
        return profiles
