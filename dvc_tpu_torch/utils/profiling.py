"""A window of work under ``torch.profiler``: the card's busy and idle
share and each kernel's device time.

:func:`traced` is what ``chip_smoke.py`` prints its ``[trace]`` lines with
and what ``python -m dvc_tpu_torch.tools.profile_step`` summarises a step
with.  Device activity is read from the profiler's CUDA events; where it
recorded none (the CPU, or a machine whose profiler cannot trace the
card) the result says so and no host time stands in for it.
"""

from __future__ import annotations

import contextlib

import torch


def device_spans(events, label):
    """((start, end) of the host range ``label``, the sorted (start, end,
    name) of the device activities among the profiler's ``events``), in
    us.  A device event that is a user annotation (the profiler's GPU
    shadow of a ``record_function`` range such as ``Optimizer.step#...``,
    which spans the gaps between that range's kernels) is no activity: it
    is left out by its flag or, where the profiler has none, by a name
    that a host event also bears (no kernel or copy is named as a host
    op)."""
    from torch.autograd import DeviceType
    win = next(e.time_range for e in events if e.name == label
               and e.device_type == DeviceType.CPU)
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False)
                   and e.name not in host)
    return (win.start, win.end), spans


def summarize(window, spans):
    """The window's (start, end) and its device ``spans`` (as
    :func:`device_spans` gives them) as ``window_ms``, ``busy_ms`` (the
    union of the spans inside the window), ``idle`` (the share of the
    window in which no span ran), ``activities`` and ``per_name`` ({name:
    [device ms, launches]})."""
    start, end = window
    busy, covered, per_name = 0.0, start, {}
    for t0, t1, name in spans:
        busy += max(min(t1, end) - max(t0, covered), 0.0)
        covered = max(covered, min(t1, end))
        ms, n = per_name.get(name, (0.0, 0))
        per_name[name] = [ms + (t1 - t0) / 1e3, n + 1]
    return {'window_ms': (end - start) / 1e3, 'busy_ms': busy / 1e3,
            'idle': 1 - busy / (end - start), 'activities': len(spans),
            'per_name': per_name}


def trace(label, fn):
    """``fn()`` under ``torch.profiler`` (:func:`traced`)."""
    with traced(label) as result:
        fn()
    return result


@contextlib.contextmanager
def traced(label, trace_file=None):
    """The body under ``torch.profiler``: the device time of each kernel as
    a share of the body's host-clock window, and the share of that window
    in which no kernel or copy ran on the card.  Yields a dict that gets
    ``window_ms``, ``busy_ms``, ``idle``, ``activities`` and ``per_name``
    ({name: [device ms, launches]}); it stays empty when the profiler saw
    no device activity.  ``trace_file``: where to write the Chrome trace
    (JSON)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    result = {}
    with profile(activities=activities) as prof:
        with record_function(label):
            yield result
        if cuda:
            torch.cuda.synchronize()
    if trace_file is not None:
        prof.export_chrome_trace(trace_file)
    window, spans = device_spans(prof.events(), label)
    if not spans:
        print('[trace] the profiler recorded no device activity: kernel '
              'shares and idle share not measured')
        return
    result.update(summarize(window, spans))
    window, busy = result['window_ms'], result['busy_ms']
    ms = {n: v[0] for n, v in result['per_name'].items()}
    print(f'[trace] {label} under the profiler: window {window:.3f} ms, '
          f'device busy {busy:.3f} ms, idle share {result["idle"]:.4f}, '
          f'{len(spans)} device activities')
    for name, t in sorted(ms.items(), key=lambda kv: -kv[1])[:8]:
        print(f'[trace]   {t:9.3f} ms  {t / window:.4f} of window  '
              f'{name[:90]}')
    k5 = sum(t for n, t in ms.items() if 'scan_bwd_kernel' in n)
    if k5:
        print(f'[trace]   {k5:9.3f} ms  {k5 / window:.4f} of window  K5 '
              f'(scan_bwd_kernel; its GEMMs below), {k5 / busy:.4f} of the '
              f'device time')
    gemm = {n: t for n, t in ms.items()
            if 'gemm_kernel' in n or 'gemm16_kernel' in n
            or 'split_sum_kernel' in n or 'round_bf16_kernel' in n}
    if gemm:
        outer = sum(t for n, t in gemm.items() if 'true, true>' in n)
        print(f'[trace]   {sum(gemm.values()):9.3f} ms  dsa::gemm in all '
              f'(tables, G . Wc^T, outer sums, split sums); the outer sums\' '
              f'kernels (both operands along the terms) {outer:.3f} ms')
    solve = sum(t for n, t in ms.items() if 'assignment_kernel' in n)
    if solve:
        print(f'[trace]   {solve:9.3f} ms  {solve / window:.4f} of window  '
              f'the assignment solver (assignment_kernel)')
    msda = {d: [v for n, v in result['per_name'].items()
                if f'msda_{d}_kernel' in n] for d in ('fwd', 'bwd')}
    t = {d: sum(v[0] for v in vs) for d, vs in msda.items()}
    n = {d: sum(v[1] for v in vs) for d, vs in msda.items()}
    print(f'[trace]   {t["fwd"] + t["bwd"]:9.3f} ms  msda in all: forward '
          f'(K1/K2) {t["fwd"]:.3f} ms in {n["fwd"]} launches, backward (K3) '
          f'{t["bwd"]:.3f} ms in {n["bwd"]} launches')
