"""Dataset of the audio-visual fusion model (port of
``dvc_tpu/data/fusion_dataset.py``, numpy only; reference
``NewDataset.py``).

A :class:`DenseCaptionDataset` whose samples also carry per-clip sound
features: read from the ``<sound_feature_folder>/<13-char id>.npy`` cache
(the reference's HuBERT cache), or zeros where a video has none (the
reference's fallback for missing audio).  The port does not extract sound
features itself.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .dataset import DenseCaptionDataset, collate, resize_feature

HUBERT_DIM = 768


class FusionDataset(DenseCaptionDataset):
    """DenseCaptionDataset + per-video sound features."""

    def __init__(self, anno_file, feature_folder, translator_json, opt,
                 seed: int = 0):
        super().__init__(anno_file, feature_folder, translator_json, opt,
                         seed)
        self.sound_feature_folder = opt.sound_feature_folder
        # dim of the zero fallback for missing audio: --sound_feature_dim,
        # else that of any cached file, else HuBERT's 768
        self.sound_dim = int(opt.sound_feature_dim or 0)
        if not self.sound_dim and self.sound_feature_folder:
            for p in glob.glob(os.path.join(self.sound_feature_folder,
                                            '*.npy'))[:1]:
                self.sound_dim = int(np.load(p, mmap_mode='r').shape[1])
        self.sound_dim = self.sound_dim or HUBERT_DIM

    def load_sound(self, key: str, n_clips: int) -> np.ndarray:
        if self.sound_feature_folder:
            p = os.path.join(self.sound_feature_folder, key[:13] + '.npy')
            if os.path.exists(p):
                return np.load(p).astype(np.float32)
        return np.zeros((n_clips, self.sound_dim), np.float32)

    def __getitem__(self, idx: int):
        s = super().__getitem__(idx)
        n_clips = s['feats'].shape[0]
        sound = self.load_sound(s['key'], n_clips)
        if sound.shape[1] != self.sound_dim:
            raise ValueError(
                f'sound features for {s["key"]} are {sound.shape[1]}-d but '
                f'the run expects {self.sound_dim} (set --sound_feature_dim)')
        if sound.shape[0] != n_clips:
            sound = resize_feature(sound, n_clips, 'nearest')
        s['sound'] = sound.astype(np.float32)
        return s


def fusion_collate(samples, T: int, G: int, Lc: int):
    batch, meta = collate(samples, T, G, Lc)
    D = samples[0]['sound'].shape[1]
    sound = np.zeros((len(samples), T, D), np.float32)
    for b, s in enumerate(samples):
        L = min(len(s['sound']), T)
        sound[b, :L] = s['sound'][:L]
    batch['sound_tensor'] = sound
    return batch, meta


class FusionBatchLoader:
    """Shuffling batch iterator; ``skip_keys`` holds the videos already
    visited in this epoch, skipped after a restart (reference
    newTrain.py:289-306)."""

    def __init__(self, dataset: FusionDataset, batch_size: int, shuffle: bool,
                 opt, seed: int = 0, skip_keys: set | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.T = opt.frame_embedding_num
        self.G = opt.gt_proposal_sample_num
        self.Lc = opt.max_caption_len
        self.drop_last = shuffle
        self.skip_keys = skip_keys or set()

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.skip_keys:
            order = np.array([i for i in order
                              if self.ds.keys[i] not in self.skip_keys],
                             np.int64)
        nb = (len(order) // self.batch_size if self.drop_last else
              (len(order) + self.batch_size - 1) // self.batch_size)
        for i in range(nb):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            if len(idxs) == 0:
                return
            if len(idxs) < self.batch_size:
                # repeat the last sample to keep the static batch shape
                idxs = np.concatenate(
                    [idxs, np.repeat(idxs[-1:], self.batch_size - len(idxs))])
            samples = [self.ds[int(j)] for j in idxs]
            yield fusion_collate(samples, self.T, self.G, self.Lc)
