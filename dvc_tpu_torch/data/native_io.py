"""The native feature-IO library, bound with ctypes (the port's own binding
of ``native/feature_io.cpp``, the library of the JAX package's
``dvc_tpu/data/native_io.py``).

The library parses ``.npy`` files (C-ordered f4 or f8), resamples (T, C)
features in time ('nearest' rounds half away from zero, as ``llround``
does; 'linear' lerps rows floor(x) and floor(x) + 1 with an f32 weight, at
x = i * (T - 1) / (new_size - 1)) and assembles a batch of files in
threads.  It is built at first use, never at import, with ``g++ -O3
-std=c++17 -fPIC -pthread -shared`` (``native/Makefile``'s flags) into
``dvc_tpu_torch/_build/feature_io-<hash of source and flags>/``; several
processes may build it at once (each writes a file of its own and renames
it into place).  A failed build raises with the compiler's log: the
dataset never drops to numpy on its own.

Each wrapper adds one to ``calls`` where it calls the library.  The numpy
versions (``*_ref``) compute what the library computes, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), 'native', 'feature_io.cpp')
BUILD_ROOT = os.path.join(_PKG, '_build')
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-pthread', '-shared')

_F32 = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
_LONG = ctypes.c_long
_SIGNATURES = {
    'dvc_npy_shape': ([ctypes.c_char_p, ctypes.POINTER(_LONG),
                       ctypes.POINTER(_LONG)], ctypes.c_int),
    'dvc_load_npy': ([ctypes.c_char_p, _F32, _LONG, _LONG], ctypes.c_int),
    'dvc_resize_feature': ([_F32, _LONG, _LONG, _F32, _LONG, ctypes.c_int],
                           None),
    'dvc_load_batch': ([ctypes.POINTER(ctypes.c_char_p), _LONG, _LONG, _LONG,
                        ctypes.c_int, ctypes.c_int, _F32,
                        np.ctypeslib.ndpointer(np.uint8),
                        np.ctypeslib.ndpointer(np.int64)], ctypes.c_int),
}

_LIB = None
build_seconds = None     # of this process's build (0.0: an earlier one's)
calls = 0


def build():
    """Compile the library unless this checkout has a build of the current
    source; returns (library path, build seconds)."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(' '.join(CXX_FLAGS).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, f'feature_io-{digest.hexdigest()[:16]}')
    path = os.path.join(out_dir, 'libdvc_feature_io.so')
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(out_dir, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    proc = subprocess.run([os.environ.get('CXX', 'g++'), *CXX_FLAGS, '-o',
                           tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'building {SOURCE} failed ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


def lib():
    """The library, built and loaded on first call."""
    global _LIB, build_seconds
    if _LIB is None:
        path, build_seconds = build()
        cdll = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = cdll
    return _LIB


def _count():
    global calls
    calls += 1


def load_npy(path: str) -> np.ndarray | None:
    """A 2-D ``.npy`` file as f32 (a 1-D one as one column), or None where
    the library refuses its format (Fortran order, a dtype other than f4 or
    f8) or cannot read it."""
    cdll = lib()
    _count()
    rows, cols = _LONG(), _LONG()
    if cdll.dvc_npy_shape(path.encode(), ctypes.byref(rows),
                          ctypes.byref(cols)) != 0:
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    if cdll.dvc_load_npy(path.encode(), out, rows.value, cols.value) != 0:
        return None
    return out


def resize_feature(feats: np.ndarray, new_size: int,
                   method: str = 'nearest') -> np.ndarray:
    """(T, C) features resampled to ``new_size`` rows, f32."""
    if feats.ndim != 2:
        raise ValueError(f'resize_feature takes (T, C) features, got '
                         f'{feats.shape}')
    cdll = lib()
    _count()
    feats = np.ascontiguousarray(feats, np.float32)
    out = np.empty((new_size, feats.shape[1]), np.float32)
    cdll.dvc_resize_feature(feats, feats.shape[0], feats.shape[1], out,
                            new_size, int(method == 'linear'))
    return out


def load_batch(paths, T: int, C: int, rescale=True, method='nearest'):
    """Load and resample B feature files in threads into ((B, T, C) f32,
    (B, T) bool mask, (B,) int64 lengths before resampling).  A missing
    file, or one that is not C columns wide, leaves zero rows, a False
    mask and length 0."""
    cdll = lib()
    _count()
    B = len(paths)
    out = np.zeros((B, T, C), np.float32)
    mask = np.zeros((B, T), np.uint8)
    lengths = np.zeros((B,), np.int64)
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    cdll.dvc_load_batch(arr, B, T, C, int(rescale), int(method == 'linear'),
                        out, mask, lengths)
    return out, mask.astype(bool), lengths


# -- plain versions ---------------------------------------------------------

def load_npy_ref(path: str) -> np.ndarray | None:
    """:func:`load_npy` in numpy."""
    x = np.load(path)
    if x.dtype not in (np.float32, np.float64) or x.ndim == 0 \
            or np.isfortran(x):
        return None
    # the header's first two dims, over the file's leading values
    rows, cols = x.shape[0], x.shape[1] if x.ndim > 1 else 1
    return x.reshape(-1)[:rows * cols].reshape(rows, cols).astype(np.float32)


def resize_feature_ref(feats: np.ndarray, new_size: int,
                       method: str = 'nearest') -> np.ndarray:
    """:func:`resize_feature` in numpy."""
    feats = np.asarray(feats, np.float32)
    orig = len(feats)
    if orig == 1:
        return np.repeat(feats.reshape(1, -1), new_size, axis=0)
    if new_size == 1:
        x = np.zeros(1)
    else:
        x = np.arange(new_size) * (orig - 1) / (new_size - 1)
    lo = np.floor(x)
    if method != 'linear':
        # half away from zero, as llround (x >= 0; x - floor(x) is exact)
        idx = (lo + (x - lo >= 0.5)).astype(np.int64)
        return feats[np.clip(idx, 0, orig - 1)]
    lo = np.minimum(lo.astype(np.int64), orig - 1)
    hi = np.minimum(lo + 1, orig - 1)
    w = (x - lo)[:, None].astype(np.float32)
    return feats[lo] * (np.float32(1) - w) + feats[hi] * w


def load_batch_ref(paths, T: int, C: int, rescale=True, method='nearest'):
    """:func:`load_batch` in numpy."""
    B = len(paths)
    out = np.zeros((B, T, C), np.float32)
    mask = np.zeros((B, T), bool)
    lengths = np.zeros((B,), np.int64)
    for b, path in enumerate(paths):
        x = load_npy_ref(path) if os.path.exists(path) else None
        if x is None or x.shape[1] != C:
            continue
        lengths[b] = len(x)
        if rescale:
            out[b] = resize_feature_ref(x, T, method)
            mask[b] = True
        else:
            n = min(len(x), T)
            out[b, :n] = x[:n]
            mask[b, :n] = True
    return out, mask, lengths
