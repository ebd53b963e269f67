"""Likelihood tiers vs independent float64 NumPy references: the fused ModelFit
kernel (Pallas interpreter on CPU), every model's dispatched batched lnprob, the
sufficient-statistics tables, the blocked background log-sum-exp, and the rule
that tier choice follows the input and never the backend's name."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _inputs(n_walkers=24, n_stars=1000, seed=0):
    rng = np.random.default_rng(seed)
    params = np.column_stack([
        rng.normal(0, 1, n_walkers),
        np.exp(rng.normal(1.5, 0.2, n_walkers)),
        rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers),
    ])
    gx = rng.normal(size=n_stars)
    gy = rng.normal(size=n_stars)
    v = 5 * rng.normal(size=n_stars)
    verr2 = (0.5 + rng.random(n_stars)) ** 2
    mask = np.ones(n_stars)
    return params, gx, gy, v, verr2, mask


def _gauss_terms(v, verr2, v_los, sigma2):
    """Per-star Gaussian log-likelihood terms (float64 NumPy)."""
    norm = verr2 + sigma2
    return -0.5 * (np.log(2 * np.pi * norm) + (v - v_los) ** 2 / norm)


def _reference_lnlike(params, gx, gy, v, verr2, mask):
    out = np.zeros(params.shape[0])
    for w in range(params.shape[0]):
        v_sys, sigma, vx, vy = params[w]
        vlos = v_sys + gx * vx + gy * vy
        out[w] = np.sum(_gauss_terms(v, verr2, vlos, sigma ** 2) * mask)
    return out



RA_C, DEC_C = 56.345, -26.675


def _kernel_inputs(n_walkers, n_stars, seed):
    rng = np.random.default_rng(seed)
    params = np.column_stack([
        rng.normal(0, 1, n_walkers), np.exp(rng.normal(1.5, 0.2, n_walkers)),
        0.3 + rng.random(n_walkers), rng.normal(0, 3, n_walkers),
        rng.normal(0, 3, n_walkers), 0.5 + rng.random(n_walkers)])
    dxm, dym = rng.normal(size=n_stars), rng.normal(size=n_stars)
    v = 5 * rng.normal(size=n_stars)
    verr2 = (0.4 + rng.random(n_stars)) ** 2
    return params, dxm, dym, dxm ** 2 + dym ** 2, v, verr2


def _model_fields(p, dx, dy):
    """ModelFit (v_los, sigma^2) per star; offsets and radii in arcmin."""
    r2 = dx ** 2 + dy ** 2
    v_los = p["v_sys"] + 2 * (dy * p["v_maxx"] - dx * p["v_maxy"]) \
        / (p["r_peak"] * (1 + r2 / p["r_peak"] ** 2))
    return v_los, p["sigma_max"] ** 2 / np.sqrt(1 + r2 / p["a"] ** 2)


def _kernel_reference(params, dxm, dym, v, verr2, mask):
    names = ["v_sys", "sigma_max", "a", "v_maxx", "v_maxy", "r_peak"]
    return np.array([np.sum(mask * _gauss_terms(
        v, verr2, *_model_fields(dict(zip(names, row)), dxm, dym)))
        for row in params])


class TestModelKernel:
    """The fused direct-tier kernel, run by the Pallas interpreter."""

    @pytest.mark.parametrize("n_walkers,n_stars,tail", [
        (12, 400, 50), (13, 1000, 0), (5, 77, 7), (70, 130, 1)])
    def test_matches_reference(self, n_walkers, n_stars, tail):
        from mcmc_dynamics_jax.ops import model_lnlike_batched

        params, dxm, dym, r2, v, verr2 = _kernel_inputs(n_walkers, n_stars,
                                                        seed=n_stars)
        mask = np.ones(n_stars)
        mask[n_stars - tail:] = 0.0      # masked stars, as sp padding makes
        got = np.asarray(model_lnlike_batched(
            *[jnp.asarray(a) for a in (params, dxm, dym, r2, v, verr2, mask)],
            walker_tile=8, star_chunk=16, interpret=True))
        expected = _kernel_reference(params, dxm, dym, v, verr2, mask)
        np.testing.assert_allclose(got, expected, rtol=1e-10)

    def test_boundary_walker_survives_padded_lanes(self):
        """A prior-legal boundary walker (sigma_max = 0) with zero-padded
        star lanes must produce a finite lnlike: the padded lane hits
        rsqrt(0) = inf, and inf * mask(0) would be NaN."""
        from mcmc_dynamics_jax.ops import model_lnlike_batched

        _, dxm, dym, r2, v, verr2 = _kernel_inputs(2, 100, seed=3)
        params = np.array([[0.0, 0.0, 1.0, 0.0, 0.0, 1.0],   # sigma_max = 0
                           [0.0, 5.0, 1.0, 1.0, 1.0, 1.0]])
        args = [jnp.asarray(a) for a in (params, dxm, dym, r2, v, verr2,
                                         np.ones(100))]
        # 100 stars in spans of 4 x 16: 28 padded lanes
        got = np.asarray(model_lnlike_batched(*args, walker_tile=8,
                                              star_chunk=16, interpret=True))
        assert np.isfinite(got).all(), got
        np.testing.assert_allclose(
            got, _kernel_reference(params, dxm, dym, v, verr2, np.ones(100)),
            rtol=1e-10)

    @pytest.mark.parametrize("kwargs", [dict(star_chunk=6),
                                        dict(walker_tile=12)])
    def test_block_sizes_must_be_powers_of_two(self, kwargs):
        from mcmc_dynamics_jax.ops import model_lnlike_batched

        arrs = [jnp.ones(8) for _ in range(6)]
        with pytest.raises(ValueError, match="power of two"):
            model_lnlike_batched(jnp.ones((4, 6)), *arrs, interpret=True,
                                 **kwargs)

    def test_freecenter_matches_full_trig_reference(self):
        """The free-centre projection's trig-identity form is EXACT: a
        centre-fitting ModelFit must match the per-pair spherical projection
        at any centre offset (including a 5-degree one)."""
        from mcmc_dynamics_jax.models.base import Runner
        from mcmc_dynamics_jax.utils.coordinates import xy_offset_rad

        fit = _fit("modelfit-freecenter")
        rng = np.random.default_rng(5)
        thetas = _thetas(fit, 12, rng)
        thetas[-1, 6] += 5.0
        thetas[-1, 7] -= 5.0
        fit.parameters["ra_center"].set(min=RA_C - 6.0, max=RA_C + 6.0)
        fit.parameters["dec_center"].set(min=DEC_C - 6.0, max=DEC_C + 6.0)
        got = np.asarray(Runner.build_lnprob_batched(fit)(jnp.asarray(thetas)))

        ra, dec = fit._host_arrays["ra"], fit._host_arrays["dec"]
        v, verr2 = fit._host_arrays["v"], fit._host_arrays["verr"] ** 2
        expected = []
        for theta in thetas:
            p = {k: float(x) for k, x in fit.scaled_values(
                jnp.asarray(theta)).items()}
            dx, dy = xy_offset_rad(ra, dec, p["ra_center"], p["dec_center"],
                                   xp=np)
            m = 10800.0 / np.pi
            expected.append(np.sum(_gauss_terms(
                v, verr2, *_model_fields(p, dx * m, dy * m))))
        np.testing.assert_allclose(got, expected, rtol=1e-11)

    def test_subclass_never_gets_base_kernel(self):
        """A subclass overriding the physics must not silently inherit the
        hardcoded Plummer + Lynden-Bell direct kernel."""
        from mcmc_dynamics_jax.models import ModelFit

        class Tweaked(ModelFit):
            def dispersion_field(self, p, data):
                return 2.0 * super().dispersion_field(p, data)

        base = _fit("modelfit")
        assert base._canonical_layout()
        assert base.build_lnlike_partial_batched() is not None
        fit = Tweaked(base.data, parameters=base.parameters.copy())
        assert not fit._canonical_layout()
        assert fit.build_lnlike_partial_batched() is None


# ------------------------------------------------------------------ dispatch
def _catalog(n, seed, density=False, pmember=False):
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax.utils import DataReader

    rng = np.random.default_rng(seed)
    cols = {"ra": u.Quantity(RA_C + 0.03 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(DEC_C + 0.03 * rng.normal(size=n), "deg"),
            "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s")}
    if density:
        cols["density"] = 10.0 ** rng.uniform(-1, 2, n)
    if pmember:
        cols["pmember"] = 0.2 + 0.7 * rng.random(n)
    return DataReader(cols)


_BACKGROUND = (20.0, 60.0)      # fixed Gaussian background (mean, sigma) km/s


def _fit(case, n=151, seed=21):
    """One small fit per model of the dispatch table, centre fixed unless
    the case says otherwise."""
    from mcmc_dynamics_jax import units as u
    from mcmc_dynamics_jax import models as m
    from mcmc_dynamics_jax.background import Gaussian

    cls, kwargs = {
        "modelfit": (m.ModelFit, {}),
        "modelfit-freecenter": (m.ModelFit, {}),
        "modelfit-gb": (m.ModelFitGB, {}),
        "modelfit-cb": (m.ModelFitConstantBackground, {"background": True}),
        "constantfit-bg": (m.ConstantFit, {"background": True}),
        "constantfit-gb": (m.ConstantFitGB, {}),
        "doublemodel": (m.DoubleModelFit, {}),
        "doublemodel-gb": (m.DoubleModelFitGB, {}),
    }[case]
    data = _catalog(n, seed, density="gb" in case or "cb" in case,
                    pmember=case == "constantfit-bg")
    params = cls.default_parameters()
    if case == "modelfit-freecenter":
        params["ra_center"].set(value=RA_C, min=RA_C - 0.02, max=RA_C + 0.02)
        params["dec_center"].set(value=DEC_C, min=DEC_C - 0.02,
                                 max=DEC_C + 0.02)
    else:
        params["ra_center"].set(value=RA_C, fixed=True)
        params["dec_center"].set(value=DEC_C, fixed=True)
    if case == "modelfit-cb":
        params["v_back"].set(value=0.0, fixed=True)
        params["sigma_back"].set(value=50.0, fixed=True)
    if kwargs.get("background"):
        kwargs = {"background": Gaussian(u.Quantity(_BACKGROUND[0], "km/s"),
                                         u.Quantity(_BACKGROUND[1], "km/s"))}
    return cls(data, parameters=params, **kwargs)


_DRAWS = {
    "v_sys": lambda r, n: r.normal(0, 2, n),
    "sigma_max": lambda r, n: np.exp(r.uniform(np.log(3.0), np.log(30.0), n)),
    "a": lambda r, n: r.uniform(30, 300, n),               # arcsec
    "v_maxx": lambda r, n: r.normal(0, 3, n),
    "v_maxy": lambda r, n: r.normal(0, 3, n),
    "r_peak": lambda r, n: r.uniform(60, 300, n),          # arcsec
    "v_maxx_c": lambda r, n: r.normal(0, 2, n),
    "v_maxy_c": lambda r, n: r.normal(0, 2, n),
    "r_peak_c": lambda r, n: r.uniform(10, 50, n),
    "v_back": lambda r, n: r.normal(0, 30, n),
    "sigma_back": lambda r, n: np.exp(r.uniform(2, 4, n)),
    "f_back": lambda r, n: 10.0 ** r.uniform(-1, 0, n),
    "ra_center": lambda r, n: RA_C + 3e-3 * r.normal(size=n),
    "dec_center": lambda r, n: DEC_C + 3e-3 * r.normal(size=n),
}


def _thetas(fit, n, rng):
    return np.column_stack([_DRAWS[name](rng, n)
                            for name in fit.compiled.free_names])


def _double_fields(p, dx, dy):
    r2 = dx ** 2 + dy ** 2

    def component(vx, vy, rp):
        v_max = np.hypot(vx, vy)
        x_pa = (dy * vx - dx * vy) / v_max
        return 2.0 * (v_max / rp) * x_pa / (1.0 + (x_pa / rp) ** 2)

    v_los = (p["v_sys"] + component(p["v_maxx"], p["v_maxy"], p["r_peak"])
             + component(p["v_maxx_c"], p["v_maxy_c"], p["r_peak_c"]))
    return v_los, p["sigma_max"] ** 2 / np.sqrt(1 + r2 / p["a"] ** 2)


def _reference_lnprob(fit, theta):
    """float64 NumPy lnprob: the model's per-star likelihood written out
    from the reference formulas, plus the (shared) prior."""
    from mcmc_dynamics_jax.models import (ConstantFit, ConstantFitGB,
                                          DoubleModelFit, DoubleModelFitGB,
                                          ModelFitConstantBackground,
                                          ModelFitGB)
    from mcmc_dynamics_jax.utils.coordinates import xy_offset_rad

    pj = fit.scaled_values(jnp.asarray(theta))
    lp = float(fit.compiled.lnprior(jnp.asarray(theta))) \
        + float(fit.extra_lnprior_fn(pj))
    if not np.isfinite(lp):
        return -np.inf
    p = {k: float(x) for k, x in pj.items()}
    h = fit._host_arrays
    v, verr2 = h["v"], h["verr"] ** 2
    dx, dy = xy_offset_rad(h["ra"], h["dec"], p["ra_center"], p["dec_center"],
                           xp=np)
    if isinstance(fit, ConstantFit):
        r = np.hypot(dx, dy)
        v_los = p["v_sys"] + (dy * p["v_maxx"] - dx * p["v_maxy"]) / r
        fields = (v_los, p["sigma_max"] ** 2)
    elif isinstance(fit, DoubleModelFit):
        fields = _double_fields(p, dx * 10800 / np.pi, dy * 10800 / np.pi)
    else:
        fields = _model_fields(p, dx * 10800 / np.pi, dy * 10800 / np.pi)
    member = _gauss_terms(v, verr2, *fields)
    if isinstance(fit, (ModelFitGB, ConstantFitGB, DoubleModelFitGB,
                        ModelFitConstantBackground)):
        if isinstance(fit, ModelFitConstantBackground):
            back = _gauss_terms(v, verr2, _BACKGROUND[0], _BACKGROUND[1] ** 2)
        else:
            back = _gauss_terms(v, verr2, p["v_back"], p["sigma_back"] ** 2)
        dens, f = fit.data.data["density"], p["f_back"]
        with np.errstate(divide="ignore"):
            terms = np.logaddexp(np.log(dens) + member, np.log(f) + back) \
                - np.log(dens + f)
    elif fit.background is not None:
        pm = np.asarray(fit.data.data["pmember"], np.float64)
        back = _gauss_terms(v, verr2, _BACKGROUND[0], _BACKGROUND[1] ** 2)
        terms = np.logaddexp(np.log(pm) + member, np.log1p(-pm) + back)
    else:
        terms = member
    return lp + np.sum(terms)


class TestDispatchedLnprob:
    """Each model's production batched lnprob (whatever tier dispatch picks)
    against the float64 NumPy per-star reference."""

    @pytest.mark.parametrize("case", [
        "modelfit", "modelfit-gb", "modelfit-cb", "constantfit-bg",
        "constantfit-gb", "doublemodel", "doublemodel-gb",
        "modelfit-freecenter"])
    def test_matches_reference(self, case):
        fit = _fit(case)
        thetas = _thetas(fit, 16, np.random.default_rng(22))
        if "f_back" in fit.compiled.free_names:
            # the prior's lower bound: the mixture must stay finite there
            thetas[::4, fit.compiled.free_names.index("f_back")] = 0.0
        got = np.asarray(fit.build_lnprob_batched()(jnp.asarray(thetas)))
        expected = np.array([_reference_lnprob(fit, t) for t in thetas])
        assert np.isfinite(expected).sum() >= 8
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(expected))
        ok = np.isfinite(expected)
        np.testing.assert_allclose(got[ok], expected[ok], rtol=1e-10)


class TestTierChoice:
    """Tiers follow the input (size, layout, prior box), never the name of
    the backend; the fused kernel is chosen when the program is lowered."""

    @pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
    def test_dispatch_ignores_backend_name(self, backend, monkeypatch):
        from mcmc_dynamics_jax.sampler import make_key

        fit = _fit("modelfit")
        thetas = jnp.asarray(_thetas(fit, 8, np.random.default_rng(3)))
        before = np.asarray(fit.build_lnprob_batched()(thetas))
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert not fit._tensor_eligible() and not fit._sufficient_eligible()
        np.testing.assert_array_equal(
            np.asarray(fit.build_lnprob_batched()(thetas)), before)
        assert str(jax.random.key_impl(make_key(0))) == "threefry2x32"

    def test_plain_reference_off_cuda(self):
        """Lowered for the CPU, the direct tier is the plain per-star sum:
        the kernel must not appear (it has no CPU lowering)."""
        fit = _fit("modelfit")
        thetas = jnp.asarray(_thetas(fit, 8, np.random.default_rng(4)))
        text = jax.jit(fit.build_lnprob_batched()).lower(thetas).as_text()
        assert "model_lnlike" not in text

    def test_partial_tier_matches_full_lnlike(self):
        """The sp-shard partial sums of the direct tier over the whole
        catalog equal the per-walker lnlike."""
        fit = _fit("modelfit")
        thetas = jnp.asarray(_thetas(fit, 8, np.random.default_rng(6)))
        data = fit.prepare_data(dict(fit._data_arrays))
        data["mask"] = jnp.ones_like(data["v"])
        got = np.asarray(fit.build_lnlike_partial_batched()(thetas, data))
        expected = [float(fit.lnlike(t)) for t in thetas]
        np.testing.assert_allclose(got, expected, rtol=1e-12)

    @pytest.mark.parametrize("name,value", [
        ("MCMC_OLD_LNPROB", "direct"),     # an override under another name
        ("MCMC_LNPROB", "exact"),          # an unknown tier
    ])
    def test_misspelt_override_is_refused(self, name, value, monkeypatch):
        """An override that would be ignored must fail instead: ignoring it
        can swap the exact tier for an approximate one without a word."""
        from mcmc_dynamics_jax.models.base import lnprob_mode

        fit = _fit("modelfit")
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match="MCMC_LNPROB"):
            lnprob_mode()
        with pytest.raises(ValueError, match="MCMC_LNPROB"):
            fit._batched_lnprob_cached()


# ------------------------------------------------------------------ background
class TestBackgroundKernel:
    @pytest.mark.parametrize("n_catalog,chunk", [
        (300, 128), (300, 100), (300, 1), (300, 512), (1, 64)])
    def test_matches_numpy_logsumexp(self, n_catalog, chunk):
        """Across block edges: padded last block, exact multiple, one star
        per block, one block larger than the catalog, a single star."""
        from mcmc_dynamics_jax.ops import background_logsumexp

        rng = np.random.default_rng(7)
        vcat = rng.normal(25.0, 30.0, size=n_catalog)
        v = rng.normal(0.0, 15.0, size=150)
        verr = 0.4 + rng.random(150)
        sigma_int = 2.0
        got = np.asarray(background_logsumexp(vcat, v, verr, sigma_int,
                                              catalog_chunk=chunk))
        norm = sigma_int ** 2 + verr ** 2
        brute = np.log(np.mean(
            np.exp(-np.subtract.outer(vcat, v) ** 2 / (2 * norm))
            / np.sqrt(2 * np.pi * norm), axis=0))
        np.testing.assert_allclose(got, brute, rtol=1e-8)

    def test_far_targets_stay_finite(self):
        """Targets hundreds of kernel widths from every catalog star: the
        per-block max rescaling must keep the log-sum-exp finite where the
        plain sum underflows."""
        from mcmc_dynamics_jax.ops import background_logsumexp

        vcat = np.linspace(-5.0, 5.0, 40)
        v = np.array([300.0, -400.0])
        verr = np.array([1.0, 1.0])
        got = np.asarray(background_logsumexp(vcat, v, verr, catalog_chunk=16))
        top = -(v - np.array([5.0, -5.0])) ** 2 / 2.0
        assert np.isfinite(got).all()
        assert np.all(got <= top) and np.all(got > top - 10.0)

    def test_single_stars_device_path(self):
        """SingleStars switches to the device path for large pairwise
        problems and agrees with its NumPy path."""
        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.background import SingleStars

        rng = np.random.default_rng(8)
        vcat = rng.normal(20.0, 25.0, size=400)
        bg = SingleStars(u.Quantity(vcat, "km/s"))
        v = rng.normal(0.0, 10.0, size=100)
        verr = 0.5 + rng.random(100)

        reference = bg(v, verr)  # small -> numpy path
        bg._DEVICE_THRESHOLD = 1  # force the device path
        got = bg(v, verr)
        np.testing.assert_allclose(got, reference, rtol=1e-6)


class TestSufficientStats:
    """O(1)-per-walker ConstantFit likelihood via exact weighted-moment tables."""

    def test_matches_direct_lnlike(self):
        from mcmc_dynamics_jax.ops import ConstantSufficientStats

        params, gx, gy, v, verr2, mask = _inputs(n_walkers=64, n_stars=3000, seed=5)
        # spread sigma over several orders of magnitude
        params[:, 1] = np.exp(np.random.default_rng(0).uniform(-2, 4, 64))
        stats = ConstantSufficientStats.build(gx, gy, v, verr2, mask)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _reference_lnlike(params, gx, gy, v, verr2, mask)
        np.testing.assert_allclose(got, expected, rtol=1e-7)

    def test_respects_mask(self):
        from mcmc_dynamics_jax.ops import ConstantSufficientStats

        params, gx, gy, v, verr2, mask = _inputs(n_walkers=8, n_stars=500, seed=6)
        mask[250:] = 0.0
        stats = ConstantSufficientStats.build(gx, gy, v, verr2, mask)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _reference_lnlike(params[:, :4], gx[:250], gy[:250], v[:250],
                                     verr2[:250], np.ones(250))
        np.testing.assert_allclose(got, expected, rtol=1e-7)

    def test_jit_and_scan_compatible(self):
        from mcmc_dynamics_jax.ops import ConstantSufficientStats
        from mcmc_dynamics_jax.sampler import init_state, run_ensemble

        params, gx, gy, v, verr2, mask = _inputs(n_walkers=32, n_stars=800, seed=7)
        stats = ConstantSufficientStats.build(gx, gy, v, verr2, mask)

        def batched(thetas):
            ok = thetas[:, 1] > 0
            return jnp.where(ok, stats.lnlike(thetas), -jnp.inf)

        state = init_state(batched, jnp.asarray(params), jax.random.PRNGKey(0),
                           batched=True)
        res = run_ensemble(batched, state, n_steps=200, batched=True)
        chain = np.asarray(res.chain)
        assert np.isfinite(np.asarray(res.log_prob)).all()
        # posterior must match the direct-likelihood posterior
        direct = lambda ths: jnp.asarray(
            _reference_lnlike(np.asarray(ths), gx, gy, v, verr2, mask))
        lp_direct = _reference_lnlike(chain[:, -1, :], gx, gy, v, verr2, mask)
        np.testing.assert_allclose(np.asarray(res.log_prob[:, -1]), lp_direct,
                                   rtol=1e-6)


def _model_inputs(n_stars=1500, seed=11):
    rng = np.random.default_rng(seed)
    dxm = 0.5 * rng.normal(size=n_stars)
    dym = 0.5 * rng.normal(size=n_stars)
    v = 5.0 * rng.normal(size=n_stars)
    verr2 = (0.5 + 2.0 * rng.random(n_stars)) ** 2
    mask = np.ones(n_stars)
    return dxm, dym, v, verr2, mask


def _model_reference_lnlike(params, dxm, dym, v, verr2, mask):
    out = np.zeros(params.shape[0])
    u = dxm ** 2 + dym ** 2
    for w in range(params.shape[0]):
        v_sys, sig, a, vx, vy, rp = params[w]
        v_los = v_sys + 2.0 * rp * (dym * vx - dxm * vy) / (rp ** 2 + u)
        s2 = sig ** 2 / np.sqrt(1 + u / a ** 2)
        norm = verr2 + s2
        t = np.log(2 * np.pi * norm) + (v - v_los) ** 2 / norm
        out[w] = -0.5 * np.sum(t * mask)
    return out


def _model_box(n_walkers, seed=12):
    rng = np.random.default_rng(seed)
    return np.column_stack([
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.3), np.log(100.0), n_walkers)),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers)),  # a (arcmin)
        rng.uniform(-10, 10, n_walkers),
        rng.uniform(-10, 10, n_walkers),
        np.exp(rng.uniform(np.log(0.05), np.log(10.0), n_walkers)),  # r_peak
    ])


class TestModelSufficientStats:
    """Radially-binned Chebyshev moment tables for the ModelFit likelihood."""

    def test_matches_direct_lnlike(self):
        from mcmc_dynamics_jax.ops import ModelSufficientStats

        dxm, dym, v, verr2, mask = _model_inputs()
        stats = ModelSufficientStats.build(dxm, dym, v, verr2, mask, s_max=1e6)
        params = _model_box(256)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _model_reference_lnlike(params, dxm, dym, v, verr2, mask)
        err = np.abs(got - expected)
        # 2nd-order radial binning: small absolute bias, tiny relative error
        assert err.max() < 0.05, err.max()
        assert np.median(err) < 1e-3
        np.testing.assert_allclose(got, expected, rtol=5e-5)

    def test_respects_mask(self):
        from mcmc_dynamics_jax.ops import ModelSufficientStats

        dxm, dym, v, verr2, mask = _model_inputs(n_stars=600, seed=13)
        mask[300:] = 0.0
        stats = ModelSufficientStats.build(dxm, dym, v, verr2, mask)
        params = _model_box(16, seed=14)
        got = np.asarray(stats.lnlike(jnp.asarray(params)))
        expected = _model_reference_lnlike(params, dxm[:300], dym[:300], v[:300],
                                           verr2[:300], np.ones(300))
        np.testing.assert_allclose(got, expected, rtol=5e-5, atol=0.02)

    def test_modelfit_dispatch_and_equality(self):
        """ModelFit.build_lnprob_batched picks the sufficient tier by default and
        agrees with the direct (XLA) tier."""
        import os

        from mcmc_dynamics_jax import units as u
        from mcmc_dynamics_jax.models import ModelFit
        from mcmc_dynamics_jax.utils import DataReader

        ra_c, dec_c = 56.345, -26.675
        rng = np.random.default_rng(15)
        n = 400
        data = DataReader({
            "ra": u.Quantity(ra_c + 0.03 * rng.normal(size=n), "deg"),
            "dec": u.Quantity(dec_c + 0.03 * rng.normal(size=n), "deg"),
            "v": u.Quantity(5.0 * rng.normal(size=n), "km/s"),
            "verr": u.Quantity(0.5 + 0.5 * rng.random(n), "km/s"),
        })
        params = ModelFit.default_parameters()
        params["ra_center"].set(value=ra_c, fixed=True)
        params["dec_center"].set(value=dec_c, fixed=True)
        params["r_peak"].set(min=1.0, max=600.0)
        params["a"].set(min=1.0, max=600.0)
        fit = ModelFit(data, parameters=params)
        # auto mode applies a catalog-size threshold (the table tier is
        # approximate): not eligible at 400 stars, forced via the env knob
        assert not fit._sufficient_eligible()

        thetas = np.column_stack([
            rng.normal(0, 2, 32),
            np.exp(rng.uniform(np.log(1.0), np.log(60.0), 32)),
            rng.uniform(30, 500, 32),   # a (arcsec, declared unit)
            rng.normal(0, 3, 32),
            rng.normal(0, 3, 32),
            rng.uniform(30, 500, 32),   # r_peak (arcsec)
        ])
        thetas = jnp.asarray(thetas, fit.dtype)

        try:
            os.environ["MCMC_LNPROB"] = "sufficient"
            assert fit._sufficient_eligible()
            fast = fit.build_lnprob_batched()       # forced tier = sufficient
            os.environ["MCMC_LNPROB"] = "direct"
            assert not fit._sufficient_eligible()
            direct = fit.build_lnprob_batched()
        finally:
            del os.environ["MCMC_LNPROB"]
        np.testing.assert_allclose(np.asarray(fast(thetas)),
                                   np.asarray(direct(thetas)),
                                   rtol=1e-5, atol=5e-3)

    def test_jit_and_scan_compatible(self):
        from mcmc_dynamics_jax.ops import ModelSufficientStats
        from mcmc_dynamics_jax.sampler import init_state, run_ensemble

        dxm, dym, v, verr2, mask = _model_inputs(n_stars=500, seed=16)
        stats = ModelSufficientStats.build(dxm, dym, v, verr2, mask)
        rng = np.random.default_rng(17)
        pos = np.column_stack([
            rng.normal(0, 1, 32), np.exp(rng.normal(1.5, 0.2, 32)),
            0.3 + rng.random(32), rng.normal(0, 3, 32), rng.normal(0, 3, 32),
            0.5 + rng.random(32)])

        def batched(thetas):
            ok = (thetas[:, 1] > 0) & (thetas[:, 2] > 0) & (thetas[:, 5] > 0)
            return jnp.where(ok, stats.lnlike(thetas), -jnp.inf)

        state = init_state(batched, jnp.asarray(pos), jax.random.PRNGKey(0),
                           batched=True)
        res = run_ensemble(batched, state, n_steps=100, batched=True)
        chain = np.asarray(res.chain)
        assert np.isfinite(np.asarray(res.log_prob)).all()
        lp_direct = _model_reference_lnlike(chain[:, -1, :], dxm, dym, v, verr2,
                                            mask)
        np.testing.assert_allclose(np.asarray(res.log_prob[:, -1]), lp_direct,
                                   rtol=1e-5, atol=5e-3)


class TestKernelGuards:
    def test_sufficient_build_binarises_mask(self):
        """Fractional masks would enter the value and derivative tables with
        different powers; build() treats any positive mask as membership."""
        from mcmc_dynamics_jax.ops import ConstantSufficientStats

        rng = np.random.default_rng(0)
        n = 500
        gx, gy = rng.normal(size=n), rng.normal(size=n)
        v = 3.0 * rng.normal(size=n)
        verr2 = (0.5 + rng.random(n)) ** 2
        frac = np.where(rng.random(n) < 0.7, 0.5, 0.0)   # fractional weights
        binary = (frac > 0).astype(float)
        s_frac = ConstantSufficientStats.build(gx, gy, v, verr2, mask=frac)
        s_bin = ConstantSufficientStats.build(gx, gy, v, verr2, mask=binary)
        theta = jnp.asarray(np.array([[0.1, 4.0, 0.5, -0.3]]))
        np.testing.assert_allclose(np.asarray(s_frac.lnlike(theta)),
                                   np.asarray(s_bin.lnlike(theta)), rtol=1e-12)

    def test_empty_background_catalog_rejected(self):
        from mcmc_dynamics_jax.ops import background_logsumexp

        with pytest.raises(ValueError, match="Empty background"):
            background_logsumexp(np.zeros(0), np.array([1.0]), np.array([1.0]))
