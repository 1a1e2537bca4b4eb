"""A window of work under ``torch.profiler``: the card's busy and idle
share and each kernel's device time; and the timing helpers the port's
measurement tools share.

:func:`traced` is what ``chip_smoke.py`` prints its ``[trace]`` lines with
and what ``python -m dvc_tpu_torch.tools.profile_step`` summarises a step
with; :func:`chrome_spans` reads the same spans back from the Chrome trace
it wrote.  Device activity is read from the profiler's CUDA events; where
it recorded none (the CPU, or a machine whose profiler cannot trace the
card) the result says so and no host time stands in for it.
:func:`two_point_ms` times dependent steps by two loop lengths and
:func:`card_label` names the card a measurement ran on.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import torch

# the Chrome trace's categories of device activity (kernels and copies);
# 'gpu_user_annotation', the device shadow of a host range, is none
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


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


def chrome_spans(trace, label):
    """:func:`device_spans` over a Chrome trace (the loaded JSON that
    ``export_chrome_trace`` writes): the host range ``label`` and the
    kernels, copies and fills, each left out where a host event bears its
    name.  ``label``'s range is None where the trace holds none."""
    events = [e for e in trace.get('traceEvents', ()) if e.get('ph') == 'X']
    host = [e for e in events if e.get('cat') not in DEVICE_CATEGORIES
            and e.get('cat') != 'gpu_user_annotation']
    names = {e['name'] for e in host}
    win = next(((e['ts'], e['ts'] + e['dur']) for e in host
                if e['name'] == label), None)
    spans = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in events
                   if e.get('cat') in DEVICE_CATEGORIES
                   and e['name'] not in names)
    return win, spans


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


def ranked(result, top):
    """The JSON of a :func:`summarize` result: the window, the device's
    busy ms and idle share, and the ``top`` names by device ms
    (``top_ops_ms``: name, total_ms, count)."""
    order = sorted(result['per_name'].items(), key=lambda kv: -kv[1][0])
    return {'window_ms': result['window_ms'],
            'device_busy_ms': result['busy_ms'], 'idle': result['idle'],
            'activities': result['activities'],
            'top_ops_ms': [{'name': name[:120], 'total_ms': ms, 'count': n}
                           for name, (ms, n) in order[:top]]}


def two_point_ms(step, n1, n2, device, carry):
    """ms a step by the JAX tools' two-loop-length protocol: ``carry =
    step(carry)`` n1 times, then n2 times, each once to warm up and once
    timed, and the difference over n2 - n1 steps, so the cost of starting
    and ending a run cancels.  Each step takes the last one's output, so
    the steps are dependent.  On a card the runs are timed by CUDA events
    on the device's current stream; on the CPU by the host clock.  Returns
    (ms, the carry after the last run)."""
    if n2 <= n1:
        raise ValueError(f'two_point_ms: n2 ({n2}) must exceed n1 ({n1})')
    device = torch.device(device)

    def run(k):
        c = carry
        if device.type != 'cuda':
            t0 = time.perf_counter()
            for _ in range(k):
                c = step(c)
            return (time.perf_counter() - t0) * 1e3, c
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record(stream)
        for _ in range(k):
            c = step(c)
        end.record(stream)
        end.synchronize()
        return start.elapsed_time(end), c

    run(n1)
    run(n2)
    t1, _ = run(n1)
    t2, carry = run(n2)
    return (t2 - t1) / (n2 - n1), carry


def card_label(device='cuda'):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them for
    ``device``'s index, or 'cpu'.  Raises where nvidia-smi cannot be
    read: a card's measurement names its card."""
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    index = device.index if device.index is not None else 0
    out = subprocess.run(['nvidia-smi', f'--id={index}',
                          '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip()


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
