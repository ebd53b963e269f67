"""The package's former import name still resolves to this package, module
for module, so scripts and pickled checkpoints written against it still load."""

import importlib
import pathlib
import pickle
import subprocess
import sys

import pytest

import mcmc_dynamics_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _alias():
    """The former name: the one other ``mcmc_dynamics_*`` package at the
    repository root."""
    names = [p.parent.name for p in ROOT.glob("mcmc_dynamics_*/__init__.py")
             if p.parent.name != "mcmc_dynamics_jax"]
    assert len(names) == 1, names
    return names[0]


def test_top_level_is_the_package():
    assert importlib.import_module(_alias()) is mcmc_dynamics_jax


@pytest.mark.parametrize("sub", ["models.model", "ops.lnlike_kernels",
                                 "sampler", "cli.run"])
def test_submodule_is_the_same_module(sub):
    real = importlib.import_module(f"mcmc_dynamics_jax.{sub}")
    assert importlib.import_module(f"{_alias()}.{sub}") is real
    # the alias leaves the real module's identity untouched
    assert real.__name__ == real.__spec__.name == f"mcmc_dynamics_jax.{sub}"


def test_pickled_class_path_resolves():
    """A checkpoint pickled before the rename names its classes under the
    old path (protocol-0 GLOBAL opcode)."""
    from mcmc_dynamics_jax.parameters import Parameter

    blob = f"c{_alias()}.parameters\nParameter\n.".encode()
    assert pickle.loads(blob) is Parameter


def test_unknown_submodule_raises():
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(f"{_alias()}.no_such_module")


def test_import_warns_deprecated():
    proc = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         f"import {_alias()}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "is deprecated; import 'mcmc_dynamics_jax'" in proc.stderr
