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
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_ROOT = os.path.join(_PKG, '_build')
SOURCES = ('ms_deform_attn.cu', 'dsa_greedy.cu', 'dsa_scan.cu', 'dsa_step.cu',
           'dsa_tables.cu', 'dsa_gemm_plan.cc', 'assignment.cu')
# sm_90a: Hopper.  No -use_fast_math: tanhf/expf/logf stay exact, as the
# JAX kernels' f32 transcendentals; -Xptxas -v records registers and spills
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# argtypes of each entry point (see the extern "C" signatures in csrc/)
_SIGNATURES = {
    'dvc_msda_fwd': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    'dvc_msda_bwd': [_P] * 7 + [_I] * 7 + [_P, _P],
    'dvc_dsa_greedy': [_P] * 27 + [_I] * 14 + [_P],
    'dvc_dsa_scan_fwd': [_P] * 21 + [_I] * 12 + [_P],
    'dvc_dsa_scan_bwd': [_P] * 39 + [_I] * 12 + [_P],
    'dvc_dsa_step_fwd': [_P] * 10 + [_I] * 9 + [_P],
    'dvc_dsa_step_bwd': [_P] * 21 + [_I] * 10 + [_P],
    'dvc_dsa_step_dcw_rows': [_I, _I],
    'dvc_dsa_lstm_fwd': [_P] * 16 + [_I] * 10 + [_P],
    'dvc_dsa_lstm_bwd': [_P] * 30 + [_I] * 11 + [_P],
    'dvc_dsa_table_gemm': [_P] * 4 + [_I] * 5 + [_P],
    'dvc_dsa_table_gemm_bwd': [_P] * 6 + [_I] * 5 + [_P],
    'dvc_dsa_gemm': [_P, _I, _I, _P] + [_I] * 6 + [_P, _P, _LL, _I, _P],
    'dvc_dsa_gemm_work_floats': [_I] * 4,
    'dvc_dsa_gemm_plan': [_I] * 4 + [_P],
    'dvc_assignment': [_P, _P, _I, _I, _I, _P, _P, _P],
}
# the entry points that do not return a CUDA error code (int)
_RESTYPES = {'dvc_dsa_gemm_work_floats': _LL, 'dvc_dsa_gemm_plan': None}


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
        _LIB = KernelLib(bind(ctypes.CDLL(path), _SIGNATURES), path, seconds,
                         log)
    return _LIB


def bind(cdll, names):
    """Give the entry points ``names`` of ``cdll`` their C signatures."""
    for name in names:
        fn = getattr(cdll, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return cdll


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')


def count_launch(fn, bf16=False):
    """One launch of the kernel behind the wrapper ``fn``: counted in
    ``fn.launches``, or in ``fn.launches_bf16`` for its bf16-operand mode."""
    if bf16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def bf16_flags(*tensors):
    """The ``bf16`` argument of the GEMM entry points in the bf16-operand
    mode: bit 0 set, and bit i + 1 where operand i is stored in bf16
    (torch.bfloat16; else float32, which the GEMM's producer rounds)."""
    import torch
    return 1 | sum(2 << i for i, t in enumerate(tensors)
                   if t.dtype == torch.bfloat16)


def levels_array(temporal_shapes):
    """Level lengths as a C int array (copied into the launch arguments)."""
    return (ctypes.c_int * len(temporal_shapes))(*map(int, temporal_shapes))


@functools.lru_cache(maxsize=None)
def gemm_work_floats(sms, *shapes):
    """Floats of the workspace that one launch's GEMMs (each (M, N, T),
    run one after another on one stream) need for their split-K partial
    tiles on ``sms`` SMs, by the C rule itself
    (``dvc_dsa_gemm_work_floats``, csrc/dsa_gemm_plan.h); at least 1, so
    that the pointer is never null."""
    fn = lib().cdll.dvc_dsa_gemm_work_floats
    return max([1] + [fn(M, N, T, sms) for M, N, T in shapes])


_SMS = {}
_WORK = {}


def gemm_work(device, *shapes):
    """A workspace of at least :func:`gemm_work_floats` floats on CUDA
    ``device``, kept for the current stream and reused: the launches of
    one stream run in order, so one buffer serves each in turn, and a
    launch costs no allocation (microseconds of host time at B=1).  It
    grows to the largest launch's need and is never freed."""
    import torch
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    floats = gemm_work_floats(_SMS[device], *shapes)
    key = (device, stream_ptr(device))
    work = _WORK.get(key)
    if work is None or work.numel() < floats:
        work = _WORK[key] = torch.empty(floats, dtype=torch.float32,
                                        device=device)
    return work


def stream_ptr(device):
    """The current stream of CUDA ``device`` as an int (PyTorch's raw
    accessor: a Stream object costs microseconds a launch)."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
