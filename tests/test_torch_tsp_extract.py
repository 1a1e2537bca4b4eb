"""The port's TSP weight loading, clip decode and extraction driver:

* ``load_tsp_weights`` on ``.pth`` files of tests/torch_mvit_ref.py's
  torchvision-layout MViT (bare, and under ``module.features.`` with TSP
  heads) reproduces that module's features through the port's
  ``FeatureExtractor``; on a JAX ``.ckpt`` the extractor reproduces the
  JAX ``FeatureExtractor``'s features (R(2+1)D-18: the JAX layout of its
  middle widths); each rejection of tests/test_mvit_converter.py has a
  counterpart here, and a VideoResNet's too;
* ``make_clip_table``, ``decode_clip`` and ``ClipBatcher`` against
  ``dvc_tpu.data.video_clips`` on a cv2-written video;
* ``python -m dvc_tpu_torch.extract_features`` against the root
  ``extract_features.py`` on the same video and weights (R3D-18,
  --clip-len 4, as tests/test_extract_features.py), idempotent on a
  second run; ``--released-checkpoint`` without a local file refused.

Tolerances: features rtol 1e-4, atol 2e-5 (tests/test_mvit_converter.py's);
decoded clips exactly (the same cv2 calls).
"""
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mvit_ref import TorchMViT  # noqa: I100
from torch_tsp_env import write_jax_ckpt, write_video

from dvc_tpu.models.tsp import FeatureExtractor as JaxExtractor
from dvc_tpu.models.tsp import mvit_block_specs
from dvc_tpu_torch import extract_features
from dvc_tpu_torch.data import video_clips
from dvc_tpu_torch.models.tsp import (FeatureExtractor, MViTConfig,
                                      load_tsp_weights, make_backbone,
                                      tsp_weights)
from dvc_tpu_torch.models.tsp.mvit_manifest import mvit_v2_s_manifest

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(rtol=1e-4, atol=2e-5)
TINY = MViTConfig(embed_dim=8, depths=(1, 2), heads=(1, 2),
                  temporal_size=4, spatial_size=16, kv_stride0=2,
                  feature_dim=16)


def _torch_mvit(seed=0, cfg=TINY):
    """tests/test_mvit_converter.py::_tiny_torch_model at ``cfg``."""
    specs = [(s.in_ch, s.out_ch, s.heads, s.q_stride, s.kv_stride)
             for s in mvit_block_specs(cfg)]
    tm = TorchMViT(specs, cfg.embed_dim, (2, 4, 4))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return tm.eval()


def _clip(seed=1, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, 4, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize('prefix', ['', 'module.features.'])
def test_pth_of_a_torchvision_layout_mvit(tmp_path, prefix):
    tm = _torch_mvit(seed=3)
    sd = {prefix + k: v for k, v in tm.state_dict().items()}
    if prefix:
        sd['module.fc1.weight'] = torch.randn(5, 16)
        sd['module.fc1.bias'] = torch.randn(5)
        sd['module.fc2.weight'] = torch.randn(2, 16)
        sd['module.fc2.bias'] = torch.randn(2)
    path = str(tmp_path / 'tsp.pth')
    torch.save({'model': sd} if prefix else sd, path)
    w = load_tsp_weights(path, 'mvit_v2_s', TINY)
    assert sorted(w.heads) == (['fc1', 'fc2'] if prefix else [])
    ex = FeatureExtractor('mvit_v2_s', path, clip_len=4, dtype='float32',
                          device='cpu', config=TINY)
    x = _clip(seed=4)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 return_features=True).numpy()
    got = ex.features(x)
    assert got.dtype == torch.float32 and got.shape == (2, 16)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_jax_ckpt_reproduces_the_jax_extractor(tmp_path):
    """A JAX TSPModel .ckpt (R(2+1)D-18, every leaf noise) through the
    port's extractor, and its variables through JAX's (given them, it
    skips its flax init), float32, on the same clips."""
    path = str(tmp_path / 'tsp.ckpt')
    variables = write_jax_ckpt(path, 'r2plus1d_18', clip_len=4)
    x = np.random.default_rng(5).standard_normal(
        (2, 4, 112, 112, 3)).astype(np.float32)
    ref = np.asarray(JaxExtractor(
        'r2plus1d_18', clip_len=4, dtype='float32',
        variables=variables).features(jnp.asarray(x)))
    ex = FeatureExtractor('r2plus1d_18', path, clip_len=4, dtype='float32',
                          device='cpu')
    assert ex.model.mid_layout == 'conv'
    np.testing.assert_allclose(ex.features(x).numpy(), ref, **F32)


def _full_mvit(prefix='', with_head=False):
    return {prefix + k: np.zeros(s, np.float32)
            for k, s in mvit_v2_s_manifest(with_head=with_head).items()}


def _renamed():
    sd = _full_mvit()
    sd['blocks.2.attn.project.weight'] = sd.pop(
        'blocks.2.attn.project.0.weight')
    return sd


def _drifted():
    sd = _full_mvit()
    sd['blocks.3.attn.rel_pos_h'] = np.zeros((55, 96), np.float32)
    return sd


def _leftover():
    sd = dict(_torch_mvit().state_dict())
    sd['blocks.0.attn.mystery.weight'] = torch.zeros(3)
    return sd


def _resnet_missing():
    sd = dict(make_backbone('r3d_18').state_dict())
    del sd['layer3.1.conv2.1.running_var']
    return sd


BIGGER = MViTConfig(embed_dim=8, depths=(1, 2), heads=(1, 2),
                    temporal_size=4, spatial_size=32, kv_stride0=2,
                    feature_dim=16)
REJECTED = {
    # test_mvit_converter_rejects_non_mvit
    'non_mvit': (lambda: {'stem.0.weight': np.zeros((45, 3, 1, 7, 7))},
                 'mvit_v2_s', None, 'conv_proj'),
    # test_mvit_converter_rejects_shape_mismatch
    'shape_mismatch': (lambda: _torch_mvit().state_dict(), 'mvit_v2_s',
                       BIGGER, 'rel_pos'),
    # test_mvit_converter_rejects_leftover_tensors
    'leftover': (_leftover, 'mvit_v2_s', TINY, 'unconsumed'),
    # test_mvit_manifest_rejects_layout_drift (a renamed tensor, a table
    # of the wrong length)
    'manifest_rename': (_renamed, 'mvit_v2_s', None, 'golden manifest'),
    'manifest_shape': (_drifted, 'mvit_v2_s', None, 'golden manifest'),
    # the VideoResNets: no stem, a missing statistic
    'non_resnet': (lambda: _torch_mvit().state_dict(), 'r3d_18', None,
                   'stem'),
    'resnet_missing': (_resnet_missing, 'r3d_18', None,
                       'layer3.1.conv2.1.running_var: missing'),
}


@pytest.mark.parametrize('case', sorted(REJECTED))
def test_load_tsp_weights_rejects(tmp_path, case):
    make, backbone, cfg, match = REJECTED[case]
    path = str(tmp_path / 'bad.pth')
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in make().items()}, path)
    with pytest.raises(ValueError, match=match):
        load_tsp_weights(path, backbone, cfg)


def test_manifest_accepts_the_exact_layout_with_tsp_prefix():
    """test_mvit_manifest_accepts_exact_layout_with_tsp_prefix: a
    full-size TSP fine-tune (features. prefix + fc1) passes and splits;
    torchvision's own head.* is ignored."""
    sd = _full_mvit('features.', with_head=True)
    sd['fc1.weight'] = np.zeros((200, 768), np.float32)
    sd['fc1.bias'] = np.zeros((200,), np.float32)
    w = tsp_weights(sd, 'mvit_v2_s')
    assert set(w.heads) == {'fc1'}
    assert tuple(w.features['blocks.15.mlp.3.weight'].shape) == (768, 3072)
    assert not any(k.startswith('head.') for k in w.features)


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    pytest.importorskip('cv2')
    root = tmp_path_factory.mktemp('extract')
    vid_dir = root / 'videos'
    vid_dir.mkdir()
    write_video(vid_dir / 'v_extract0001.mp4', n_frames=120, seed=3)
    ckpt = str(root / 'r3d.ckpt')
    write_jax_ckpt(ckpt, 'r3d_18', clip_len=4, seed=2)
    return root, str(vid_dir), ckpt


def test_decode_matches_jax(video):
    from dvc_tpu.data import video_clips as jvc
    _, vid_dir, _ = video
    path = os.path.join(vid_dir, 'v_extract0001.mp4')
    assert video_clips.video_metadata(path) == jvc.video_metadata(path)
    fps, n, _ = video_clips.video_metadata(path)
    for clip_len, stride in ((4, 16), (16, 8)):
        got = video_clips.make_clip_table(path, fps, n, clip_len, 15, stride)
        want = jvc.make_clip_table(path, fps, n, clip_len, 15, stride)
        assert [(c.t_start, c.t_end) for c in got] == \
            [(c.t_start, c.t_end) for c in want] and got
    for backbone in ('r3d_18', 'mvit_v2_s'):
        spec = video_clips.BACKBONE_INPUT[backbone]
        np.testing.assert_array_equal(
            video_clips.decode_clip(path, 1.3, 4, 15, **spec),
            jvc.decode_clip(path, 1.3, 4, 15, **spec))
    clips = video_clips.make_clip_table(path, fps, n, 4, 15, 16)
    got = list(video_clips.ClipBatcher(clips, 3, 4, 15, 'r3d_18'))
    want = list(jvc.ClipBatcher(clips, 3, 4, 15, 'r3d_18'))
    assert [g[1] for g in got] == [w[1] for w in want] == [3, 1]
    for (gx, gn, _), (wx, _, _) in zip(got, want):
        # the JAX batch pads the last one with zero clips to a static shape
        assert gx.shape == (gn, 4, 112, 112, 3)
        np.testing.assert_array_equal(gx, wx[:gn])


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        'extract_features_mod', os.path.join(REPO, 'extract_features.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_extract_features_driver_matches_jax(video, capsys):
    root, vid_dir, ckpt = video
    flags = ['--video-dir', vid_dir, '--backbone', 'r3d_18', '--clip-len',
             '4', '--frame-rate', '15', '--stride', '16', '--batch-size',
             '2', '--dtype', 'float32', '--local-checkpoint', ckpt]
    jax_out, out = str(root / 'jax_features'), str(root / 'features')
    old = sys.argv
    try:
        sys.argv = ['extract_features.py', *flags, '--output-dir', jax_out]
        _jax_driver().main()
    finally:
        sys.argv = old
    port = flags + ['--output-dir', out, '--device', 'cpu']
    written = extract_features.main(port)
    assert written == [os.path.join(out, 'v_extract0001.npy')]
    got = np.load(written[0])
    want = np.load(os.path.join(jax_out, 'v_extract0001.npy'))
    assert got.dtype == np.float32 and got.shape == want.shape == (4, 512)
    np.testing.assert_allclose(got, want, **F32)
    # idempotent: the second run skips the video
    assert extract_features.main(port) == []
    assert 'already computed: v_extract0001' in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(written[0]), got)


def test_released_checkpoint_needs_a_local_file(tmp_path):
    with pytest.raises(SystemExit, match='--local-checkpoint'):
        extract_features.main(['--video-dir', str(tmp_path), '--output-dir',
                               str(tmp_path / 'out'), '--released-checkpoint',
                               'r2plus1d_34-tsp_on_activitynet'])
