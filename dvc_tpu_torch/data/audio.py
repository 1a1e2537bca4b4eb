"""HuBERT sound features of the fusion model (the port's copy of
``dvc_tpu/data/audio.py``; reference ``NewModel.py:99-138``, ``get_mfcc``).

For each clip segment of a video: slice the waveform at ``floor(t * sr)``,
take the mono mean, resample to 16 kHz with ``np.interp``, pad to 400
samples (the conv stack's minimum), run HuBERT-base
(:class:`dvc_tpu_torch.models.hubert.Hubert`, on the card unless the
caller asks for the CPU, under ``torch.no_grad()``) and mean-pool its last
layer to one 768-d vector.  A video's features are cached as
``<cache_dir>/<key>.npy``; a video whose audio cannot be loaded gets zeros.

``model_name`` is a local folder holding a Hugging Face HuBERT
``config.json`` and ``pytorch_model.bin``.  Nothing is downloaded: a hub
name with no such folder raises.  The model loads at the first video that
needs it.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

HUBERT_SR = 16000
HUBERT_DIM = 768
MIN_SAMPLES = 400              # the conv stack's receptive field
# segments of one length run together, at most this many a forward pass
SEGMENTS_A_PASS = 16


class HubertExtractor:
    def __init__(self, cache_dir: str | None = None,
                 model_name: str = 'facebook/hubert-base-ls960',
                 device='cuda'):
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.model_name = model_name
        self.device = torch.device(device)
        self._model = None

    def _load_model(self):
        if self._model is None:
            from ..models.hubert import Hubert, HubertConfig
            config = os.path.join(self.model_name, 'config.json')
            weights = os.path.join(self.model_name, 'pytorch_model.bin')
            if not (os.path.isfile(config) and os.path.isfile(weights)):
                raise FileNotFoundError(
                    f'HuBERT weights: {self.model_name!r} is not a folder '
                    'holding config.json and pytorch_model.bin.  Real '
                    'HuBERT weights are not in the repository and are '
                    'never downloaded: point model_name at a local copy')
            model = Hubert(HubertConfig.from_json(config), device='cpu')
            model.load_state_dict(torch.load(weights, map_location='cpu',
                                             weights_only=True), strict=True)
            self._model = model.to(self.device)
            for p in self._model.parameters():
                p.requires_grad_(False)
        return self._model

    def _cache_path(self, video_key: str):
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f'{video_key}.npy')

    def extract(self, audio_path: str, segments, video_key: str | None = None
                ) -> np.ndarray:
        """segments: [(t_start, t_end), ...] seconds.  Returns
        (len(segments), 768) float32; zeros when the audio fails to load."""
        cache = self._cache_path(video_key) if video_key else None
        if cache and os.path.exists(cache):
            feats = np.load(cache)
            if feats.shape[0] == len(segments):
                return feats.astype(np.float32)
        try:
            waveform, sr = self._load_audio(audio_path)
        except Exception:
            return np.zeros((len(segments), HUBERT_DIM), np.float32)

        model = self._load_model()
        cuts = []
        for t0, t1 in segments:
            s, e = math.floor(t0 * sr), math.floor(t1 * sr)
            cut = waveform[:, s:e].mean(axis=0, keepdims=True)
            cut = self._resample(cut, sr, HUBERT_SR).astype(np.float32)[0]
            if len(cut) < MIN_SAMPLES:
                cut = np.pad(cut, (0, MIN_SAMPLES - len(cut)))
            cuts.append(cut)
        # segments of one length in one pass (no padding between them)
        out = [None] * len(cuts)
        by_length = {}
        for i, cut in enumerate(cuts):
            by_length.setdefault(len(cut), []).append(i)
        with torch.no_grad():
            for idx in by_length.values():
                for j in range(0, len(idx), SEGMENTS_A_PASS):
                    part = idx[j:j + SEGMENTS_A_PASS]
                    x = torch.from_numpy(np.stack([cuts[i] for i in part]))
                    h = model(x.to(self.device)).mean(dim=1).cpu().numpy()
                    for i, row in zip(part, h):
                        out[i] = row
        feats = np.stack(out).astype(np.float32)
        if cache:
            np.save(cache, feats)
        return feats

    @staticmethod
    def _load_audio(path):
        """Waveform as (channels, samples) float numpy + sample rate."""
        try:
            import torchaudio
            w, sr = torchaudio.load(path)
            return w.numpy(), sr
        except Exception:
            import wave
            with wave.open(path, 'rb') as f:
                sr = f.getframerate()
                n = f.getnframes()
                data = np.frombuffer(f.readframes(n), np.int16)
                data = data.reshape(-1, f.getnchannels()).T
                return data.astype(np.float32) / 32768.0, sr

    @staticmethod
    def _resample(wave: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
        if sr == target_sr:
            return wave
        n_out = int(round(wave.shape[-1] * target_sr / sr))
        if n_out <= 1 or wave.shape[-1] <= 1:
            return np.zeros((wave.shape[0], max(n_out, 1)), np.float32)
        x_old = np.arange(wave.shape[-1]) / sr
        x_new = np.arange(n_out) / target_sr
        return np.stack([np.interp(x_new, x_old, ch) for ch in wave])
