"""Port parity of the serving path's host-side data helpers: the port's
``resize_feature`` equals the JAX package's with its native library built
(exactly: both call the library of ``native/feature_io.cpp``), and its
``Translator`` is the same shared class.

The library rounds exact halves away from zero; the JAX package's numpy
path, taken where the library is not built, rounds them to even.  The port
always takes the library (ROADMAP C); the two rules agree at the served
length T = 200, where no position falls on a half (199 is prime)."""
import json
import os
import subprocess

import numpy as np
import pytest

from dvc_tpu.data import native_io
from dvc_tpu.data.dataset import resize_feature as jax_resize
from dvc_tpu.data.vocabulary import Translator as JaxTranslator
from dvc_tpu_torch.data import Translator, resize_feature


@pytest.fixture(scope='module')
def jax_native_lib():
    """The JAX package's native library, built as tests/test_native_io.py
    builds it."""
    if not native_io.available():
        subprocess.run(['make', '-C', os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), 'native')],
            check=True, capture_output=True)
        native_io._TRIED = False
        native_io._LIB = None
    assert native_io.available()


@pytest.mark.parametrize('method', ['nearest', 'linear'])
@pytest.mark.parametrize('orig,new', [(3, 5), (150, 200), (333, 200),
                                      (80, 200), (1, 4), (7, 1), (24, 24)])
def test_resize_feature_matches_jax(orig, new, method, jax_native_lib):
    """(3, 5) puts rows at half-integer positions (rounded away from
    zero)."""
    feats = np.random.default_rng(orig).standard_normal(
        (orig, 6)).astype(np.float32)
    got = resize_feature(feats, new, method)
    want = jax_resize(feats, new, method)
    assert got.shape == (new, 6) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_served_length_has_no_half_positions():
    """Resizing any length to T = 200 never lands on a half, so numpy's and
    the native library's rounding rules pick the same rows there."""
    for orig in range(2, 1001):
        x = np.arange(200) * (orig - 1) / 199
        np.testing.assert_array_equal(np.round(x), np.floor(x + 0.5))


def test_translator_matches_jax(tmp_path):
    words = ['a', 'cut', 'onion']
    path = tmp_path / 'vocab.json'
    path.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    got, want = Translator(str(path), 3), JaxTranslator(str(path), 3)
    for ids in ([2, 1, 3, 0, 2], [0, 1], [3, 3, 3]):
        assert got.rtranslate(ids) == want.rtranslate(ids)
    np.testing.assert_array_equal(got.translate('Cut a red onion.', 8),
                                  want.translate('Cut a red onion.', 8))
