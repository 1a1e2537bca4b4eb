"""The vocabulary ``Translator``, shared with the JAX package:
``dvc_tpu/data/vocabulary.py`` (standard library and numpy only) is loaded
by its path, so the vocab JSON format and the id <-> word rules stay
single-sourced without importing ``dvc_tpu``."""

from __future__ import annotations

import os

from ..utils.config import load_shared

Translator = load_shared(os.path.join('dvc_tpu', 'data',
                                      'vocabulary.py')).Translator
