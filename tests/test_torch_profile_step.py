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
