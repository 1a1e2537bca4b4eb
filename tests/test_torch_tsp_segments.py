"""The segment half of the port's ``data/video_clips.py`` (groundtruth
tables, clip labels and the TSP clip sampler) against
``dvc_tpu.data.video_clips`` on the same CSVs and seeds: every result
exactly equal, jittered and on the uniform grid."""
import csv
import dataclasses

import numpy as np
import pytest

from dvc_tpu.data import video_clips as jvc
from dvc_tpu_torch.data import video_clips as pvc

COLS = ['action-label', 'temporal-region-label']


def _write_csv(path, n=12, seed=0):
    """Rows of several kinds: plain segments, one past the video's end,
    one starting before 0, one shorter than a clip (dropped), one exactly
    a clip long (a legacy clip-window row), background rows without an
    action label, and category-string labels."""
    rng = np.random.default_rng(seed)
    fields = ['filename', 'fps', 't-start', 't-end', 'video-duration'] + \
        COLS + ['action-name']
    rows = []
    for i in range(n):
        t0 = float(rng.uniform(0, 20))
        rows.append({'filename': f'v_{i % 4:03d}.mp4', 'fps': 30,
                     't-start': t0, 't-end': t0 + float(rng.uniform(1.2, 9)),
                     'video-duration': 30, 'action-label': int(i % 5),
                     'temporal-region-label': int(i % 2),
                     'action-name': ['chop', 'stir', 'fry'][i % 3]})
    rows += [
        {'filename': 'v_end.mp4', 'fps': 25, 't-start': 27.0, 't-end': 40.0,
         'video-duration': 30, 'action-label': 2,
         'temporal-region-label': 1, 'action-name': 'fry'},
        {'filename': 'v_neg.mp4', 'fps': '', 't-start': -2.0, 't-end': 3.0,
         'video-duration': '', 'action-label': 1,
         'temporal-region-label': 1, 'action-name': 'stir'},
        {'filename': 'v_short.mp4', 'fps': 30, 't-start': 5.0,
         't-end': 5.5, 'video-duration': 30, 'action-label': 3,
         'temporal-region-label': 1, 'action-name': 'chop'},
        {'filename': 'v_clip.mp4', 'fps': 30, 't-start': 0.1,
         't-end': 0.1 + 16 / 15, 'video-duration': 30, 'action-label': 4,
         'temporal-region-label': 1, 'action-name': 'chop'},
        {'filename': 'v_bg.mp4', 'fps': 30, 't-start': 2.0, 't-end': 6.0,
         'video-duration': 30, 'action-label': '',
         'temporal-region-label': 0, 'action-name': ''},
    ]
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def _same_segments(a, b):
    assert [dataclasses.astuple(s) for s in a] == \
        [dataclasses.astuple(s) for s in b]


@pytest.mark.parametrize('mapped', [False, True],
                         ids=['numeric', 'label-mapping'])
def test_load_segment_table_matches_jax(tmp_path, mapped):
    path = str(tmp_path / 'gt.csv')
    _write_csv(path)
    cols = ['action-name', 'temporal-region-label'] if mapped else COLS
    maps = [{'chop': 0, 'stir': 1, 'fry': 2}, None] if mapped else None
    kw = dict(clip_len=16, frame_rate=15.0, root_dir='/videos',
              label_mappings=maps)
    got = pvc.load_segment_table(path, cols, **kw)
    want = jvc.load_segment_table(path, cols, **kw)
    _same_segments(got, want)
    names = [s.filename for s in got]
    assert '/videos/v_short.mp4' not in names      # shorter than a clip
    assert '/videos/v_clip.mp4' in names           # exactly a clip long
    end = got[names.index('/videos/v_end.mp4')]
    assert end.t_end == 30.0 and got[names.index('/videos/v_neg.mp4')
                                     ].t_start == 0.0
    assert got[names.index('/videos/v_bg.mp4')].labels[0] == -1


def test_category_labels_without_a_mapping_raise(tmp_path):
    path = str(tmp_path / 'gt.csv')
    _write_csv(path)
    for module in (pvc, jvc):
        with pytest.raises(ValueError, match='label-mapping-jsons'):
            module.load_segment_table(path, ['action-name'])


@pytest.mark.parametrize('jitter', [True, False], ids=['jittered', 'grid'])
@pytest.mark.parametrize('seed', [0, 777])
def test_segment_clip_sampler_matches_jax(tmp_path, jitter, seed):
    """The same (segment, t_start) for every item of two epochs, in the
    driver's orders (a probe of the first items, then a permutation), so
    the RandomState draws line up one for one."""
    path = str(tmp_path / 'gt.csv')
    _write_csv(path, seed=seed)
    segs = [m.load_segment_table(path, COLS) for m in (pvc, jvc)]
    got, want = (m.SegmentClipSampler(s, 16, 15.0, 5, jitter, seed)
                 for m, s in zip((pvc, jvc), segs))
    assert len(got) == len(want) == 5 * len(segs[0])
    order = list(range(8))
    for perm in (np.random.default_rng(seed).permutation(len(got))
                 for _ in range(2)):
        order += list(perm)
    for j in order:
        (gs, gt), (ws, wt) = got.clip_at(int(j)), want.clip_at(int(j))
        assert gt == wt and dataclasses.astuple(gs) == \
            dataclasses.astuple(ws)
        assert gs.t_start - 1e-9 <= gt <= gs.t_end - 16 / 15 + 1e-9


def test_legacy_clip_rows_are_sampled_clips_per_segment_times(tmp_path):
    """A clip-window row (span == clip length) gives the same clip each of
    its ``clips_per_segment`` draws, as in the JAX driver."""
    path = str(tmp_path / 'gt.csv')
    _write_csv(path)
    segs = pvc.load_segment_table(path, COLS)
    k = [s.filename for s in segs].index('v_clip.mp4')
    sampler = pvc.SegmentClipSampler(segs, 16, 15.0, 5, True, 3)
    starts = {sampler.clip_at(k + i * len(segs))[1] for i in range(5)}
    assert len(starts) == 1 and abs(starts.pop() - 0.1) < 1e-9


def test_iou_and_clip_labels_match_jax():
    rng = np.random.default_rng(4)
    starts = rng.uniform(0, 8, 6)
    gt = [(float(t), float(t + d)) for t, d in
          zip(starts, rng.uniform(0.4, 1.6, 6))]      # clip-sized events
    labels = rng.integers(0, 9, len(gt))
    for _ in range(50):
        a, b = (tuple(sorted(rng.uniform(0, 30, 2))) for _ in range(2))
        assert pvc.iou_interval(a, b) == jvc.iou_interval(a, b)
    table = [(30.0, 300, 16, 15.0, 8), (25.0, 200, 8, 15.0, 4)]
    for fps, frames, clip_len, rate, stride in table:
        got = pvc.assign_clip_labels(
            pvc.make_clip_table('v.mp4', fps, frames, clip_len, rate,
                                stride), gt, labels)
        want = jvc.assign_clip_labels(
            jvc.make_clip_table('v.mp4', fps, frames, clip_len, rate,
                                stride), gt, labels)
        assert [dataclasses.astuple(c) for c in got] == \
            [dataclasses.astuple(c) for c in want]
        assert {c.region_label for c in got} == {0, 1}
