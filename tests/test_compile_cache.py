"""The persistent compilation cache helper honours JAX_COMPILATION_CACHE_DIR
and otherwise uses a fixed directory at the repository root."""

import pathlib

import jax

from mcmc_dynamics_jax import configure_compile_cache


def _restore(saved):
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert configure_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == saved
    finally:
        _restore(saved)


def test_default_is_fixed_repo_directory(monkeypatch):
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = configure_compile_cache()
        root = pathlib.Path(__file__).resolve().parents[1]
        assert path == str(root / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert configure_compile_cache() == path      # stable across calls
    finally:
        _restore(saved)
