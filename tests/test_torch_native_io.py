"""The port's binding of the native feature-IO library
(``dvc_tpu_torch/data/native_io.py``) against the JAX package's binding of
the same library (``dvc_tpu/data/native_io.py``, built with ``make -C
native``) and against its own numpy versions: ``load_npy`` (f4, f8, a
Fortran-ordered file the library refuses, a 1-D file), ``resize_feature``
('nearest' with exact halves, 3 -> 5 and 2 -> 3 rows, where numpy's
half-to-even would differ, and 'linear') and ``load_batch`` (a missing
file and a file of the wrong width included), every comparison exact; the
port's ``DenseCaptionDataset`` against JAX's at an odd
``frame_embedding_num`` (halves on every other row); a failed build
raises with the compiler's log.
"""
import json
import os
import subprocess

import numpy as np
import pytest

from dvc_tpu.data import native_io as jax_native_io
from dvc_tpu.data.dataset import DenseCaptionDataset as JaxDataset
from dvc_tpu_torch.data import DenseCaptionDataset, native_io
from dvc_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def jax_lib():
    """The JAX binding's library, built as tests/test_native_io.py builds
    it."""
    if not jax_native_io.available():
        subprocess.run(['make', '-C', os.path.join(ROOT, 'native')],
                       check=True, capture_output=True)
        jax_native_io._TRIED = False
        jax_native_io._LIB = None
    assert jax_native_io.available(), 'the JAX binding needs its library'


def _files(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((17, 5))
    paths = {'f4': x.astype(np.float32), 'f8': x,
             'fortran': np.asfortranarray(x.astype(np.float32)),
             '1d': x[:, 0].astype(np.float32)}
    for name, arr in paths.items():
        np.save(tmp_path / f'{name}.npy', arr)
    return {name: str(tmp_path / f'{name}.npy') for name in paths}


@pytest.mark.parametrize('name', ['f4', 'f8', 'fortran', '1d'])
def test_load_npy_matches_the_jax_binding_and_numpy(tmp_path, name):
    path = _files(tmp_path)[name]
    calls = native_io.calls
    got = native_io.load_npy(path)
    assert native_io.calls == calls + 1
    want = jax_native_io.load_npy(path)
    ref = native_io.load_npy_ref(path)
    if name == 'fortran':          # refused: the dataset reads it with np.load
        assert got is None and want is None and ref is None
        return
    assert got.dtype == np.float32 and got.shape == want.shape == ref.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('rows,new,method', [
    (3, 5, 'nearest'), (2, 3, 'nearest'), (13, 25, 'nearest'),
    (37, 100, 'nearest'), (100, 37, 'nearest'), (1, 7, 'nearest'),
    (5, 1, 'nearest'), (37, 100, 'linear'), (3, 5, 'linear'),
    (100, 37, 'linear'), (1, 7, 'linear'), (12, 12, 'linear')])
def test_resize_feature_matches_the_jax_binding_and_numpy(rows, new, method):
    x = np.random.default_rng(rows * 1000 + new).standard_normal(
        (rows, 8)).astype(np.float32)
    got = native_io.resize_feature(x, new, method)
    np.testing.assert_array_equal(got, jax_native_io.resize_feature(
        x, new, method))
    np.testing.assert_array_equal(got, native_io.resize_feature_ref(
        x, new, method))


def test_nearest_rounds_halves_away_from_zero():
    """3 rows to 5: x = 0, 0.5, 1, 1.5, 2 takes rows 0, 1, 1, 2, 2 (numpy's
    half-to-even would take 0, 0, 1, 2, 2)."""
    x = np.arange(3, dtype=np.float32)[:, None]
    assert native_io.resize_feature(x, 5)[:, 0].tolist() == [0, 1, 1, 2, 2]
    assert native_io.resize_feature_ref(x, 5)[:, 0].tolist() == [0, 1, 1, 2, 2]
    assert x[np.round(np.arange(5) / 2).astype(int), 0].tolist() == [
        0, 0, 1, 2, 2]


@pytest.mark.parametrize('rescale,method', [(True, 'nearest'),
                                            (True, 'linear'),
                                            (False, 'nearest')])
def test_load_batch_matches_the_jax_binding_and_numpy(tmp_path, rescale,
                                                      method):
    rng = np.random.default_rng(2)
    paths = []
    for i, rows in enumerate((3, 10, 31, 2, 40)):
        p = tmp_path / f'v{i}.npy'
        np.save(p, rng.standard_normal((rows, 4)).astype(
            np.float32 if i % 2 else np.float64))
        paths.append(str(p))
    np.save(tmp_path / 'wide.npy', np.ones((6, 5), np.float32))
    paths += [str(tmp_path / 'missing.npy'), str(tmp_path / 'wide.npy')]
    got = native_io.load_batch(paths, 25, 4, rescale, method)
    want = jax_native_io.load_batch(paths, 25, 4, rescale, method)
    ref = native_io.load_batch_ref(paths, 25, 4, rescale, method)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert got[2].tolist() == [3, 10, 31, 2, 40, 0, 0]


def test_dataset_matches_jax_at_an_odd_frame_count(tmp_path):
    """frame_embedding_num 25 over 13-row files (x = i / 2: a half on every
    other row) and 7-row ones; one Fortran-ordered file read by np.load in
    both packages."""
    rng = np.random.default_rng(5)
    feats = tmp_path / 'features'
    feats.mkdir()
    words = ['alpha', 'beta', 'gamma']
    vocab = tmp_path / 'vocab.json'
    vocab.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    anno = {}
    for v, rows in enumerate((13, 7, 13, 40)):
        key = f'v_odd{v:08d}'
        x = rng.standard_normal((rows, 6)).astype(np.float32)
        np.save(feats / f'{key}.npy', np.asfortranarray(x) if v == 2 else x)
        anno[key] = {'duration': 30.0, 'timestamps': [[1.0, 5.0]],
                     'sentences': ['alpha beta']}
    (tmp_path / 'anno.json').write_text(json.dumps(anno))
    opt = load_config(visual_feature_type='tsp', feature_dim=6,
                      frame_embedding_num=25, invalid_video_json=[],
                      vocab_size=len(words))
    args = (str(tmp_path / 'anno.json'), str(feats), str(vocab))
    port = DenseCaptionDataset(*args, opt)
    jax_ds = JaxDataset(*args, False, opt)
    calls = native_io.calls
    for i in range(len(port)):
        got, want = port[i]['feats'], jax_ds[i]['feats']
        assert got.shape == (25, 6)
        np.testing.assert_array_equal(got, want)
    # each video read (the Fortran file refused, then read by np.load) and
    # resized through the library
    assert native_io.calls - calls == 2 * len(port)


def test_a_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    monkeypatch.setattr(native_io, 'BUILD_ROOT', str(tmp_path))
    monkeypatch.setattr(native_io, 'CXX_FLAGS',
                        native_io.CXX_FLAGS + ('-fno-such-flag',))
    with pytest.raises(RuntimeError, match='no-such-flag'):
        native_io.build()
