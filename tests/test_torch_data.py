"""Port parity of the serving path's host-side data helpers: the port's
``resize_feature`` equals the JAX package's numpy path (exactly: both index
and lerp in numpy), and its ``Translator`` is the same shared class.

The JAX package also has an optional native resize (``native/``, built by
``make -C native``) that rounds exact halves away from zero where numpy
rounds them to even.  The port follows numpy; the two agree at the served
length T = 200, where no position falls on a half (199 is prime)."""
import json

import numpy as np
import pytest

from dvc_tpu.data import native_io
from dvc_tpu.data.dataset import resize_feature as jax_resize
from dvc_tpu.data.vocabulary import Translator as JaxTranslator
from dvc_tpu_torch.data import Translator, resize_feature


@pytest.mark.parametrize('method', ['nearest', 'linear'])
@pytest.mark.parametrize('orig,new', [(3, 5), (150, 200), (333, 200),
                                      (80, 200), (1, 4), (7, 1), (24, 24)])
def test_resize_feature_matches_jax(orig, new, method, monkeypatch):
    """(3, 5) puts rows at half-integer positions (round half to even)."""
    monkeypatch.setattr(native_io, 'available', lambda: False)
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
