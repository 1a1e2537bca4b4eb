"""The repo's one config surface, shared with the JAX package.

``dvc_tpu/utils/config.py`` uses only the standard library and ``yaml``, but
importing it as ``dvc_tpu.utils.config`` runs ``dvc_tpu/utils/__init__.py``,
which imports JAX.  So the file is loaded here by its path: the same
``load_config`` and ``cfgs/*.yml`` inheritance, without JAX.
"""

from __future__ import annotations

import importlib.util
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_shared(relpath: str):
    """Load a framework-free file of the JAX package by its path, as a
    private module of this package, so that neither ``dvc_tpu`` nor JAX is
    imported (the file may import only the standard library and numpy or
    yaml)."""
    name = 'dvc_tpu_torch._shared_' + os.path.splitext(
        os.path.basename(relpath))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_mod = load_shared(os.path.join('dvc_tpu', 'utils', 'config.py'))
Config = _mod.Config
load_config = _mod.load_config
