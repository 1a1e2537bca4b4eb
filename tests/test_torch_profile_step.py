"""``python -m dvc_tpu_torch.tools.profile_step`` on the CPU, and its
flagship against the JAX benchmark's.

On the CPU the profiler records no device activity: the tool still writes
its Chrome trace and says so in its JSON, listing no operation (host times
do not stand in for device times).  Its options are those of
``__graft_entry__._flagship_opt`` at ``bench.py``'s shapes, key by key, and
its synthetic batch is ``_synthetic_batch``'s with sound.
"""
import json

import numpy as np
import pytest

from dvc_tpu_torch.tools import profile_step

# a narrow flagship: the tool's code path at a CPU test's size
TINY = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
            transformer_ff_dim=32, num_queries=6, vocab_size=20,
            input_encoding_size=16, rnn_size=16, att_hid_size=16,
            max_caption_len=6, feature_dim=16, frame_embedding_num=24,
            gt_proposal_sample_num=3, cap_nheads=2, fusion_heads=4)


@pytest.mark.parametrize('what', ['train', 'eval'])
def test_the_tool_traces_a_step_and_says_the_cpu_has_no_device_plane(
        tmp_path, capsys, what):
    summary = profile_step.main(['--what', what, '--device', 'cpu',
                                 '--steps', '1', '--batch', '2', '--out',
                                 str(tmp_path)], **TINY)
    out = capsys.readouterr().out
    assert json.loads(out[out.index('{'):]) == summary
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == f'profile_step {what} x1' for e in events)
    assert summary['device_activity'] is False
    assert 'no device activity' in summary['note']
    assert 'top_ops_ms' not in summary and 'idle' not in summary
    assert summary['device_name'] == 'cpu'


def test_the_flagship_is_the_jax_benchmarks():
    # imported here, as tests/test_fusion.py does: the module sets
    # XLA_FLAGS when it is imported
    from __graft_entry__ import _flagship_opt
    want = _flagship_opt(frame_embedding_num=200, max_caption_len=20,
                         tpu_mesh_data=1).to_dict()
    got = profile_step.flagship_opt().to_dict()
    assert (got.pop('device'), want.pop('device')) == ('cuda', 'tpu')
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_the_synthetic_batch_is_the_jax_benchmarks():
    from __graft_entry__ import _synthetic_batch
    opt = profile_step.flagship_opt(**TINY)
    want = _synthetic_batch(opt, 3, with_sound=True)
    got = profile_step.synthetic_batch(opt, 3, seed=0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _event(name, device, start, end, annotation=None):
    import types
    from torch.autograd import DeviceType
    ev = types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=getattr(DeviceType, device))
    if annotation is not None:
        ev.is_user_annotation = annotation
    return ev


@pytest.mark.parametrize('flagged', [True, False])
def test_the_profilers_gpu_annotations_are_no_device_activity(flagged):
    """A ``record_function`` range shows on the device too (flagged as a
    user annotation, or in an older profiler only by its host range's
    name); it spans the gaps between its kernels, so it must add neither
    busy time nor an operation."""
    from dvc_tpu_torch.utils.profiling import device_spans, summarize
    events = [
        _event('step', 'CPU', 0.0, 100.0, True),
        _event('Optimizer.step#Adam.step', 'CPU', 40.0, 95.0, True),
        _event('aten::mm', 'CPU', 1.0, 3.0, False),
        _event('Optimizer.step#Adam.step', 'CUDA', 41.0, 96.0,
               True if flagged else None),
        _event('gemm_kernel', 'CUDA', 5.0, 15.0, False),
        _event('adam_kernel', 'CUDA', 50.0, 60.0, False),
        _event('adam_kernel', 'CUDA', 80.0, 90.0, False),
        _event('Memcpy HtoD (Pageable -> Device)', 'CUDA', 95.0, 105.0)]
    window, spans = device_spans(events, 'step')
    assert window == (0.0, 100.0)
    assert [s[2] for s in spans] == ['gemm_kernel', 'adam_kernel',
                                     'adam_kernel',
                                     'Memcpy HtoD (Pageable -> Device)']
    got = summarize(window, spans)
    # the copy counts up to the window's end
    assert got['busy_ms'] == pytest.approx(0.035)
    assert got['idle'] == pytest.approx(0.65)
    assert got['per_name']['adam_kernel'] == [pytest.approx(0.02), 2]
    assert got['activities'] == 4 and got['window_ms'] == 0.1


class _Stop(Exception):
    pass


@pytest.mark.parametrize('argv,want', [
    ([], (200, 20)), (['--frames', '30', '--max-caption-len', '7'], (30, 7))])
def test_frames_and_caption_length_reach_the_options(tmp_path, monkeypatch,
                                                     argv, want):
    """``--frames`` and ``--max-caption-len`` (the JAX tool's options, its
    defaults 200 and 20) set the flagship's T and caption length."""
    seen = []

    def recorded(**overrides):
        opt = flagship_opt(**overrides)
        seen.append((opt.frame_embedding_num, opt.max_caption_len))
        raise _Stop
    flagship_opt = profile_step.flagship_opt
    monkeypatch.setattr(profile_step, 'flagship_opt', recorded)
    with pytest.raises(_Stop):
        profile_step.main(['--device', 'cpu', '--out', str(tmp_path), *argv])
    assert seen == [want]


def _chrome(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'pid': 0, 'tid': 0}


def _listing(root):
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes())
            for p in root.iterdir()}


@pytest.mark.parametrize('saved', [True, False])
def test_summarize_only_reads_the_chrome_trace_back(tmp_path, capsys, saved):
    """``--summarize-only`` ranks a Chrome trace's kernels, copies and fills
    inside the capture's range as ``device_spans`` + ``summarize`` rank the
    same spans (the device shadow of a host range left out), with the keys
    of a live capture, and writes nothing."""
    from dvc_tpu_torch.utils.profiling import device_spans, ranked, summarize
    label = 'profile_step train x2'
    spans = [('gemm_kernel', 'kernel', 5.0, 10.0),
             ('Memset (Device)', 'gpu_memset', 20.0, 2.0),
             ('adam_kernel', 'kernel', 50.0, 10.0),
             ('adam_kernel', 'kernel', 80.0, 10.0),
             ('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', 95.0, 10.0)]
    events = [_chrome(label, 'user_annotation', 0.0, 100.0),
              _chrome('Optimizer.step#Adam.step', 'user_annotation', 40.0,
                      55.0),
              _chrome('aten::mm', 'cpu_op', 1.0, 2.0),
              _chrome('cudaLaunchKernel', 'cuda_runtime', 2.0, 1.0),
              _chrome('Optimizer.step#Adam.step', 'gpu_user_annotation',
                      41.0, 55.0)]
    events += [_chrome(*s) for s in spans]
    with open(tmp_path / 'trace.json', 'w') as f:
        json.dump({'traceEvents': events}, f)
    settings = {'what': 'train', 'steps': 2, 'batch': 16, 'device': 'cuda:0',
                'device_name': 'NVIDIA H100 80GB HBM3'}
    if saved:
        with open(tmp_path / 'capture.json', 'w') as f:
            json.dump({**settings, 'trace_file': 'elsewhere'}, f)
    before = _listing(tmp_path)
    got = profile_step.main(['--summarize-only', '--top', '3', '--out',
                             str(tmp_path)])
    assert _listing(tmp_path) == before
    out = capsys.readouterr().out
    assert json.loads(out[out.index('{'):]) == got

    objs = [_event(label, 'CPU', 0.0, 100.0, True),
            _event('Optimizer.step#Adam.step', 'CPU', 40.0, 95.0, True),
            _event('aten::mm', 'CPU', 1.0, 3.0, False),
            _event('Optimizer.step#Adam.step', 'CUDA', 41.0, 96.0, True)]
    objs += [_event(n, 'CUDA', t, t + d, False) for n, _, t, d in spans]
    want = ranked(summarize(*device_spans(objs, label)), 3)
    assert {k: got[k] for k in want} == want
    assert [op['name'] for op in got['top_ops_ms']] == [
        'adam_kernel', 'gemm_kernel', 'Memcpy HtoD (Pageable -> Device)']
    assert got['idle'] == pytest.approx(1 - 0.037 / 0.1)
    assert got['activities'] == 5
    if not saved:
        settings.update(batch=None, device=None, device_name=None)
    assert got == {**settings, 'trace_file': str(tmp_path / 'trace.json'),
                   'device_activity': True, **want}


def test_summarize_only_gives_the_live_captures_json(tmp_path):
    """On the CPU: a capture, then ``--summarize-only`` on its folder, print
    the same JSON (no device activity, no operations)."""
    live = profile_step.main(['--what', 'eval', '--device', 'cpu', '--steps',
                              '1', '--batch', '2', '--out', str(tmp_path)],
                             **TINY)
    again = profile_step.main(['--summarize-only', '--out', str(tmp_path)])
    assert again == live and live['device_activity'] is False


def test_two_point_ms_differences_two_loop_lengths(monkeypatch):
    """Each loop length runs twice (a warm-up, then timed), each run from
    the given carry, and the ms a step is the timed runs' difference over
    n2 - n1; a loop of n2 <= n1 is refused."""
    from dvc_tpu_torch.utils import profiling
    clock, runs = [100.0], []

    def step(c):
        clock[0] += 0.002 + 0.001 * (c == 0)    # a first step costs more
        runs.append(c)
        return c + 1
    monkeypatch.setattr(profiling.time, 'perf_counter', lambda: clock[0])
    ms, carry = profiling.two_point_ms(step, 2, 5, 'cpu', 0)
    assert ms == pytest.approx(2.0) and carry == 5
    assert runs == [0, 1] + [0, 1, 2, 3, 4] + [0, 1] + [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        profiling.two_point_ms(step, 3, 3, 'cpu', 0)
