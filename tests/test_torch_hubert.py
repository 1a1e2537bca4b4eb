"""HuBERT in the port, held to ``transformers`` and to the JAX package,
with no download: a tiny random ``transformers.HubertConfig`` (2 layers,
hidden 32, 16-channel convs, a positional kernel of 16 in 4 groups).

- ``models/hubert.py::Hubert`` loaded from ``HubertModel``'s state_dict
  (``strict=True``; the weight norm in either spelling): the last hidden
  state within 1e-5 x max|ref| in f32, from 400 samples (the conv stack's
  minimum) up.
- ``data/audio.py::HubertExtractor`` (its model read from the folder that
  ``save_pretrained`` writes) against the JAX ``HubertExtractor`` with
  ``_model`` preset to that ``HubertModel``, on the same stereo 44.1 kHz
  ``.wav`` files and segments (one shorter than 400 samples at 16 kHz):
  features within 1e-5 relative, the same cache, zeros for a corrupt file.
- ``FusionDataset``'s live-audio route against JAX's, with a metadata CSV
  (clip windows) and without one (uniform windows).
"""
import os
import wave

os.environ.setdefault('USE_TF', '0')       # transformers without TensorFlow

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

from dvc_tpu.data.audio import HubertExtractor as JaxExtractor  # noqa: E402
from dvc_tpu.data.fusion_dataset import FusionDataset as JaxFusion  # noqa: E402
from dvc_tpu_torch.data import FusionDataset  # noqa: E402
from dvc_tpu_torch.data.audio import HUBERT_DIM, HubertExtractor  # noqa: E402
from dvc_tpu_torch.models.hubert import Hubert, HubertConfig  # noqa: E402
from dvc_tpu_torch.utils.config import load_config  # noqa: E402

pytestmark = pytest.mark.heavy

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16,) * 7,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """(transformers HubertModel in eval mode, with every parameter noisy;
    the folder save_pretrained wrote it to)."""
    torch.manual_seed(0)
    model = transformers.HubertModel(transformers.HubertConfig(**TINY)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    folder = tmp_path_factory.mktemp('hubert')
    model.save_pretrained(str(folder), safe_serialization=False)
    return model, str(folder)


def port_model(model, rename=False):
    sd = dict(model.state_dict())
    if rename:       # the spelling of torch.nn.utils.weight_norm
        conv = 'encoder.pos_conv_embed.conv.'
        for old, new in (('weight_g', 'original0'), ('weight_v', 'original1')):
            sd[conv + old] = sd.pop(f'{conv}parametrizations.weight.{new}')
    port = Hubert(HubertConfig(**TINY), device='cpu')
    port.load_state_dict(sd, strict=True)
    return port


@pytest.mark.parametrize('samples', [400, 401, 1000, 3219, 16000])
@pytest.mark.parametrize('rename', [False, True])
def test_hubert_matches_transformers(reference, samples, rename):
    model, _ = reference
    port = port_model(model, rename)
    x = torch.from_numpy(np.random.default_rng(samples).standard_normal(
        (2, samples)).astype(np.float32))
    with torch.no_grad():
        want = model(x).last_hidden_state
        got = port(x)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_hubert_config_reads_the_layout_and_refuses_the_other(reference,
                                                              tmp_path):
    _, folder = reference
    c = HubertConfig.from_json(os.path.join(folder, 'config.json'))
    assert (c.hidden_size, c.conv_dim, c.num_conv_pos_embeddings) == (
        32, (16,) * 7, 16)
    assert sorted(Hubert(c, device='cpu').state_dict()) == sorted(
        reference[0].state_dict())
    for bad in (dict(feat_extract_norm='layer'),
                dict(do_stable_layer_norm=True)):
        with pytest.raises(ValueError, match='hubert-base layout'):
            HubertConfig(**TINY, **bad)


def write_wav(path, seconds, sr=44100, seed=0):
    """A stereo 16-bit wave of ``seconds``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    data = np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                     0.2 * rng.standard_normal(len(t))], -1)
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(data, -1, 1) * 32767).astype('<i2').tobytes())


def test_extractor_matches_jax(reference, tmp_path):
    model, folder = reference
    audio = tmp_path / 'a.wav'
    write_wav(audio, 3.0)
    (tmp_path / 'bad.wav').write_bytes(b'RIFF not a wave')
    # a segment of 0.01 s (160 samples at 16 kHz, padded to 400), two of
    # one length (one pass), and others
    segments = [(0.0, 1.0), (0.5, 1.5), (1.0, 3.0), (2.0, 2.01), (0.25, 1.9)]
    jax_ex = JaxExtractor(cache_dir=str(tmp_path / 'jax_cache'))
    jax_ex._model = model
    port = HubertExtractor(cache_dir=str(tmp_path / 'cache'),
                           model_name=folder, device='cpu')
    want = jax_ex.extract(str(audio), segments, 'vid')
    got = port.extract(str(audio), segments, 'vid')
    assert got.shape == want.shape == (len(segments), 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(np.load(tmp_path / 'cache' / 'vid.npy'), got)
    # the cache answers a second call; the model is not called
    port._model = None
    port.model_name = str(tmp_path / 'nowhere')
    np.testing.assert_array_equal(port.extract(str(audio), segments, 'vid'),
                                  got)
    for ex in (jax_ex, port):
        zeros = ex.extract(str(tmp_path / 'bad.wav'), segments, 'bad')
        np.testing.assert_array_equal(
            zeros, np.zeros((len(segments), HUBERT_DIM), np.float32))
    # a hub name with no local folder raises: nothing is downloaded
    with pytest.raises(FileNotFoundError, match='not in the repository'):
        HubertExtractor(device='cpu').extract(str(audio), segments[:1])


@pytest.mark.parametrize('with_csv', [True, False])
def test_fusion_dataset_live_audio_matches_jax(reference, tmp_path,
                                               with_csv):
    """Three videos: two with a .wav and a .mp4 name of it (one with a
    metadata row in the CSV), one with no audio (zeros); no sound cache."""
    import json
    model, folder = reference
    feats, audio = tmp_path / 'features', tmp_path / 'audio'
    feats.mkdir()
    audio.mkdir()
    words = ['alpha', 'beta']
    vocab = tmp_path / 'vocab.json'
    vocab.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    rng = np.random.default_rng(0)
    anno, rows = {}, ['filename,fps,video-frames']
    for v, (n, seconds, ext) in enumerate(((6, 4.0, '.wav'),
                                           (5, 3.0, '.mp4'),
                                           (4, 2.0, None))):
        key = f'v_aud{v:08d}'
        np.save(feats / f'{key}.npy',
                rng.standard_normal((n, 8)).astype(np.float32))
        if ext:
            write_wav(audio / f'{key}.wav', seconds, seed=v)
            if ext == '.mp4':      # a wave under another of the names
                os.replace(audio / f'{key}.wav', audio / f'{key}.mp4')
        anno[key] = {'duration': seconds, 'timestamps': [[0.0, 1.0]],
                     'sentences': ['alpha beta']}
        if v == 0:
            rows.append(f'/videos/{key}.mp4,30,{int(seconds * 30)}')
    (tmp_path / 'anno.json').write_text(json.dumps(anno))
    csv_path = tmp_path / 'meta.csv'
    csv_path.write_text('\n'.join(rows) + '\n')
    opt = load_config(visual_feature_type='tsp', feature_dim=8,
                      frame_embedding_num=6, invalid_video_json=[],
                      vocab_size=2, sound_feature_folder=None,
                      sound_feature_dim=32, clip_len=16, frame_rate=15,
                      stride=16)
    args = (str(tmp_path / 'anno.json'), str(feats), str(vocab))
    meta = str(csv_path) if with_csv else None
    jax_ex = JaxExtractor(cache_dir=str(tmp_path / 'jax_cache'))
    jax_ex._model = model
    want = JaxFusion(*args, True, opt, audio_folder=str(audio),
                     extractor=jax_ex, metadata_csv=meta)
    got = FusionDataset(*args, opt, audio_folder=str(audio),
                        extractor=HubertExtractor(
                            cache_dir=str(tmp_path / 'cache'),
                            model_name=folder, device='cpu'),
                        metadata_csv=meta, is_training=True)
    key0 = 'v_aud00000000'
    assert (key0 in got.clip_segments) == with_csv
    assert got.segments_for(key0, 6, 4.0) == want.segments_for(key0, 6, 4.0)
    for i in range(len(got)):
        g, w = got[i]['sound'], want[i]['sound']
        assert g.shape == w.shape == (6, 32)
        assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
    assert not got[2]['sound'].any()
    assert sorted(os.listdir(tmp_path / 'cache')) == [
        'v_aud00000000.npy', 'v_aud00000001.npy']
