"""Native C++ runtime library: CSV ingest, binary cache, radial binning."""

import numpy as np
import pytest

from mcmc_dynamics_jax import native
from mcmc_dynamics_jax.utils.data import radial_bin_numbers

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native toolchain unavailable")


class TestNativeCsv:
    def test_roundtrip_with_header(self, tmp_path):
        rng = np.random.default_rng(0)
        data = rng.normal(size=(1000, 4))
        path = tmp_path / "cat.csv"
        with open(path, "w") as f:
            f.write("ra,dec,v,verr\n")
            for row in data:
                f.write(",".join(repr(float(x)) for x in row) + "\n")
        got = native.read_csv(path, 4)
        assert got is not None
        np.testing.assert_allclose(got, data, rtol=1e-15)

    def test_matches_pandas(self, tmp_path):
        import pandas as pd
        rng = np.random.default_rng(1)
        df = pd.DataFrame({"a": rng.normal(size=500), "b": rng.random(500)})
        path = tmp_path / "t.csv"
        df.to_csv(path, index=False)
        got = native.read_csv(path, 2)
        np.testing.assert_allclose(got, df.to_numpy(), rtol=1e-12)


class TestNativeCache:
    def test_write_read_roundtrip(self, tmp_path):
        rng = np.random.default_rng(2)
        data = rng.normal(size=(5000, 6))
        path = tmp_path / "cat.mcmd"
        assert native.cache_write(path, data)
        got = native.cache_read(path)
        np.testing.assert_array_equal(got, data)

    def test_corrupt_cache_rejected(self, tmp_path):
        path = tmp_path / "bad.mcmd"
        path.write_bytes(b"NOPE" + b"\x00" * 64)
        assert native.cache_read(path) is None


class TestNativeBinning:
    def test_matches_numpy_reference(self, monkeypatch):
        """Native C++ vs the PURE-NUMPY fallback.  radial_bin_numbers itself
        dispatches to the native path first, so the fallback must be forced
        (monkeypatched native -> None) or this comparison is a tautology."""
        import mcmc_dynamics_jax.native as native_mod

        rng = np.random.default_rng(3)
        for n, nstars, dlogr in ((500, 50, 0.2), (1000, 80, 0.05), (120, 50, 0.3)):
            r = rng.lognormal(0.0, 1.0, size=n)
            got = native.radial_bins(r, nstars, dlogr)
            monkeypatch.setattr(native_mod, "radial_bins",
                                lambda *a, **k: None)
            expected = radial_bin_numbers(r, nstars=nstars, dlogr=dlogr)
            monkeypatch.undo()
            np.testing.assert_array_equal(got, expected)
