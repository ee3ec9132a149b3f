"""JAX-free access to the numpy-only host modules of ``cracks_tpu``.

Importing ``cracks_tpu.<anything>`` runs ``cracks_tpu/__init__.py``,
which imports jax and configures it.  The host modules themselves
(configuration, expressions, mesh I/O, the forest with its native key
core, FE tables, problem definitions, statistics, timers) import only
numpy and each other, through relative imports.  This module registers
an alias package whose ``__path__`` is the ``cracks_tpu/`` directory
and imports those modules through it: their relative imports resolve
inside the alias, ``cracks_tpu/__init__.py`` never runs, and jax is
never loaded.  The modules are shared, not copied.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import os
import sys
import types

_ALIAS = __name__ + "_cracks_tpu"
_SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "cracks_tpu")


def _alias_package() -> types.ModuleType:
    pkg = sys.modules.get(_ALIAS)
    if pkg is None:
        pkg = types.ModuleType(_ALIAS)
        pkg.__path__ = [_SRC_DIR]
        pkg.__package__ = _ALIAS
        pkg.__spec__ = importlib.machinery.ModuleSpec(
            _ALIAS, None, is_package=True)
        pkg.__spec__.submodule_search_locations = [_SRC_DIR]
        sys.modules[_ALIAS] = pkg
    return pkg


def _load(name: str) -> types.ModuleType:
    _alias_package()
    return importlib.import_module(f"{_ALIAS}.{name}")


expressions = _load("expressions")
config = _load("config")
meshio = _load("meshio")
mesh = _load("mesh")
fem = _load("fem")
problems = _load("problems")
statistics = _load("statistics")
profiling = _load("profiling")

MESH_DIR = os.path.join(os.path.dirname(_SRC_DIR), "meshes")
