"""The port's streaming mode (decode -> TSP features -> PDVC in one
process, ``dvc_tpu_torch/data/streaming.py``):

* ``StreamingFeatureDataset`` against ``dvc_tpu.data.streaming`` on the
  same cv2-written videos and JAX ``.ckpt`` weights (R3D-18, clip_len 4):
  the features and the items, the cache hit, zeros for a video without a
  file;
* ``run_train --streaming_features 1`` for a --debug epoch of a tiny
  recipe on the CPU (no ``.npy`` written), then ``run_eval`` on its run
  folder (the videos featurized again in process) and ``eval_ete``
  (``extract_features`` into files, then ``run_eval`` on them), which
  write the same records.

Tolerances: features rtol 1e-4, atol 2e-5 (tests/test_mvit_converter.py's);
the two evaluations' records exactly (the same extractor weights and
arithmetic, through a file or not).
"""
import json
import os

import numpy as np
import pytest
import yaml

from torch_tsp_env import (STREAM_PDVC, write_jax_ckpt,  # noqa: I100
                           write_stream_env)

from dvc_tpu.data.streaming import StreamingFeatureDataset as JaxStreaming
from dvc_tpu.utils.config import load_config as jax_load_config
from dvc_tpu_torch import eval_ete, run_eval, run_train
from dvc_tpu_torch.data.streaming import StreamingFeatureDataset
from dvc_tpu_torch.utils.config import load_config, parse_opts

pytestmark = pytest.mark.heavy

pytest.importorskip('cv2')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('stream')
    data = write_stream_env(root)
    data['tsp_checkpoint'] = str(root / 'r3d.ckpt')
    write_jax_ckpt(data['tsp_checkpoint'], 'r3d_18', clip_len=4, seed=1)
    return root, data


def test_streaming_dataset_matches_jax(env):
    _, data = env
    over = dict(data, frame_embedding_num=16, max_caption_len=6,
                gt_proposal_sample_num=2)
    jds = JaxStreaming(data['train_caption_file'], data['video_folder'],
                       data['dict_file'], True, jax_load_config(**over))
    ds = StreamingFeatureDataset(data['train_caption_file'],
                                 data['video_folder'], data['dict_file'],
                                 load_config(**over), device='cpu')
    assert ds.keys == jds.keys and len(ds.videos) == 3
    for i, key in enumerate(ds.keys):
        got, want = ds[i], jds[i]
        assert got['feats'].shape == (16, 512)
        np.testing.assert_allclose(got['feats'], want['feats'], **F32)
        assert (got['gt_timestamps'], got['captions']) == \
            (want['gt_timestamps'], want['captions'])
        if key == 'v_missing0000':
            assert not got['feats'].any()
        else:
            assert np.abs(got['feats']).sum() > 0
    assert ds.extractor.videos == 3 and ds.extractor.clips == 6
    # every video is cached: a second pass needs no extractor
    ds.extractor = None
    np.testing.assert_array_equal(ds.load_feats(ds.keys[0]),
                                  ds[0]['feats'])
    ds.refresh()
    with pytest.raises(AttributeError):
        ds.load_feats(ds.keys[0])


def test_streaming_run_trains_and_evaluates(env, tmp_path):
    """run_train's --debug epoch (2 steps at B=2, then validation) with
    the train and val sets on one extractor; run_eval and eval_ete on its
    run folder."""
    root, data = env
    cfg = dict(STREAM_PDVC, id='stream', save_dir=str(tmp_path / 'save'),
               **data)
    path = tmp_path / 'stream.yml'
    path.write_text(yaml.safe_dump(cfg))
    opt = parse_opts(['--cfg_path', str(path), '--debug', '--device', 'cpu'],
                     root=REPO)
    folder, losses = run_train.main(opt)
    assert all(np.isfinite(v) for v in losses.values())
    info = json.load(open(os.path.join(folder, 'info.json')))
    assert info['val_history']['1']['Recall'] >= 0
    assert 'streaming so far: 3 videos, 6 clips' in open(
        os.path.join(folder, 'train.log')).read()
    assert not [f for _, _, files in os.walk(root) for f in files
                if f.endswith('.npy')]

    streamed, scores = run_eval.main(['--eval_save_dir', folder,
                                      '--eval_device', 'cpu'])
    assert np.isfinite(scores['METEOR']) and np.isfinite(scores['soda_c'])
    streamed = json.load(open(streamed))['results']
    # the extraction settings and weights: the run's
    ete, ete_scores = eval_ete.main([
        '--eval_save_dir', folder, '--video-dir', data['video_folder'],
        '--device', 'cpu'])
    features = os.path.join(folder, 'ete_features_stride_8')
    assert sorted(os.listdir(features)) == [
        f'v_stream{v:05d}'[:13] + '.npy' for v in range(3)]
    assert json.load(open(ete))['results'] == streamed
    assert ete_scores == scores
