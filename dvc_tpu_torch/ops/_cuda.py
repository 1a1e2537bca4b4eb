"""Build and load the hand-written CUDA kernels of ``dvc_tpu_torch/csrc``.

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds: one ``nvcc`` per source, all started together,
then one link into a shared library that is loaded with ``ctypes``.  The
build runs at first use, never at import, into
``dvc_tpu_torch/_build/<hash of sources and flags>/`` (listed in
``.gitignore``); a later call in the same checkout reuses it.

Each C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` of its launch; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_ROOT = os.path.join(_PKG, '_build')
SOURCES = ('ms_deform_attn.cu', 'dsa_greedy.cu', 'dsa_scan.cu', 'dsa_step.cu',
           'dsa_tables.cu')
# sm_90a: Hopper.  No -use_fast_math: tanhf/expf/logf stay exact, as the
# JAX kernels' f32 transcendentals; -Xptxas -v records registers and spills
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# split-K chunks of the backwards' outer sums: their workspace holds up to
# this many partial tiles (kGSplitMax in dsa_common.cuh); the table GEMM's
# backward up to TABLE_SPLITS (kTableSplits in dsa_tables.cu)
WORK_SPLITS = 8
TABLE_SPLITS = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each entry point (see the extern "C" signatures in csrc/)
_SIGNATURES = {
    'dvc_msda_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    'dvc_msda_bwd': [_P] * 7 + [_I] * 7 + [_P, _P],
    'dvc_dsa_greedy': [_P] * 22 + [_I] * 12 + [_P],
    'dvc_dsa_scan_fwd': [_P] * 17 + [_I] * 10 + [_P],
    'dvc_dsa_scan_bwd': [_P] * 35 + [_I] * 11 + [_P],
    'dvc_dsa_step_fwd': [_P] * 9 + [_I] * 8 + [_P],
    'dvc_dsa_step_bwd': [_P] * 19 + [_I] * 9 + [_P],
    'dvc_dsa_lstm_fwd': [_P] * 15 + [_I] * 9 + [_P],
    'dvc_dsa_lstm_bwd': [_P] * 29 + [_I] * 10 + [_P],
    'dvc_dsa_table_gemm': [_P] * 3 + [_I] * 3 + [_P],
    'dvc_dsa_table_gemm_bwd': [_P] * 6 + [_I] * 4 + [_P],
}


class KernelLib:
    """The loaded library plus how it was built."""

    def __init__(self, cdll, path, build_seconds, build_log):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log


_LIB: KernelLib | None = None


def _nvcc():
    for cand in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'), shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def _digest():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if this checkout has no build of the current
    sources yet; returns (library path, build seconds, compiler output)."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    path = os.path.join(out_dir, 'libdvc_kernels.so')
    log_path = os.path.join(out_dir, 'build.log')
    if os.path.exists(path):
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(out_dir, f'{s}.{tag}.o') for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', '-o', o,
                               os.path.join(CSRC, s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for s, o in zip(SOURCES, objs)]
    logs = [(s, p.communicate()[0], p.returncode)
            for s, p in zip(SOURCES, procs)]
    log = ''.join(f'== {s}\n{out}' for s, out, _ in logs)
    if any(rc != 0 for _, _, rc in logs):
        raise RuntimeError(f'nvcc failed:\n{log}')
    tmp = f'{path}.{tag}.tmp'
    proc = subprocess.run([nvcc, '-shared', '-o', tmp, *objs],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n{log}')
    with open(log_path, 'w') as f:
        f.write(log)
    os.replace(tmp, path)
    for o in objs:
        os.remove(o)
    return path, seconds, log


def lib() -> KernelLib:
    """The kernel library, built and loaded on first call."""
    global _LIB
    if _LIB is None:
        path, seconds, log = build()
        cdll = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = KernelLib(cdll, path, seconds, log)
    return _LIB


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')


def levels_array(temporal_shapes):
    """Level lengths as a C int array (copied into the launch arguments)."""
    return (ctypes.c_int * len(temporal_shapes))(*map(int, temporal_shapes))


def stream_ptr(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream
