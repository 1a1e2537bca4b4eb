"""Feature rescale of the serving path (port of
``dvc_tpu/data/dataset.py::resize_feature``, its numpy path)."""

from __future__ import annotations

import numpy as np


def resize_feature(feats: np.ndarray, new_size: int,
                   method: str = 'nearest') -> np.ndarray:
    """Temporal rescale of (T, C) features to ``new_size`` rows: 'nearest'
    takes row round(x) (numpy's half-to-even), 'linear' lerps rows floor(x)
    and floor(x) + 1, at x = i * (T - 1) / (new_size - 1)."""
    orig = len(feats)
    if orig == 1:
        return np.repeat(feats.reshape(1, -1), new_size, axis=0)
    if new_size == 1:
        x_new = np.zeros(1)
    else:
        x_new = np.arange(new_size) * (orig - 1) / (new_size - 1)
    if method == 'nearest':
        idx = np.clip(np.round(x_new).astype(np.int64), 0, orig - 1)
        return feats[idx]
    lo = np.clip(np.floor(x_new).astype(np.int64), 0, orig - 1)
    hi = np.clip(lo + 1, 0, orig - 1)
    w = (x_new - lo)[:, None].astype(np.float32)
    return feats[lo] * (1 - w) + feats[hi] * w
