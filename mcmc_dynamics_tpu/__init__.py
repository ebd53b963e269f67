"""Former import name of :mod:`mcmc_dynamics_jax`, kept so that existing
scripts and pickled checkpoints still import.  Deprecated.

Importing this package returns :mod:`mcmc_dynamics_jax` itself, and every
submodule path under the old name resolves to the module of the same path
under the new one: the same module objects, so classes, ``isinstance`` checks
and module state agree.  The first import warns with a DeprecationWarning.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import mcmc_dynamics_jax

_OLD, _NEW = __name__, mcmc_dynamics_jax.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to the module ``<new>.x.y``."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_OLD + "."):
            return None
        real = importlib.util.find_spec(_NEW + fullname[len(_OLD):])
        if real is None:
            return None
        return importlib.util.spec_from_loader(fullname, self,
                                               origin=real.origin)

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        self._specs[spec.name] = module.__spec__
        return module

    def get_code(self, fullname):
        # ``python -m <old>.x.y`` runs the code of ``<new>.x.y``
        name = _NEW + fullname[len(_OLD):]
        return importlib.util.find_spec(name).loader.get_code(name)

    def exec_module(self, module):
        # the import system stamps the alias spec on the module it was
        # handed; give the real module its own spec back
        module.__spec__ = self._specs.pop(module.__spec__.name)


warnings.warn(f"the package name {_OLD!r} is deprecated; import {_NEW!r}",
              DeprecationWarning, stacklevel=2)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = mcmc_dynamics_jax
