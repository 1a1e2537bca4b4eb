"""Dataset of the audio-visual fusion model (port of
``dvc_tpu/data/fusion_dataset.py``; reference ``NewDataset.py``).

A :class:`DenseCaptionDataset` whose samples also carry per-clip sound
features, found in this order (``load_sound``): the
``<sound_feature_folder>/<13-char id>.npy`` cache (the reference's HuBERT
cache); else, given an ``audio_folder`` and an ``extractor``
(:class:`dvc_tpu_torch.data.audio.HubertExtractor`), HuBERT features of
the video's ``.mp4``/``.wav``/``.mkv``/``.webm`` file, extracted per clip
segment and cached; else zeros (the reference's fallback for missing
audio).

Clip segments come from the TSP metadata or clip CSV of the split
(``metadata_csv``, else ``--train_csv_filename`` / ``--valid_csv_filename``)
joined to the annotations by 13-char id as the reference joins them
(NewDataset.py:54-108): a metadata CSV (filename, fps, video-frames) is
expanded to clip windows with the eval-dataset formula
(eval_video_dataset_2.py:91-115); a labeled clip CSV (clip-t-start /
t-start rows) is used row for row.  Without a CSV the segments are uniform
windows over the video.
"""

from __future__ import annotations

import csv
import glob
import os

import numpy as np

from ..parallel.mesh import rows
from .audio import HUBERT_DIM, HubertExtractor
from .dataset import (DenseCaptionDataset, collate, collate_rows,
                      resize_feature)
from .video_clips import make_clip_table

AUDIO_EXTENSIONS = ('.mp4', '.wav', '.mkv', '.webm')


def load_clip_segments_csv(path: str, clip_len: int = 16,
                           frame_rate: float = 15.0, stride: int = 16):
    """CSV -> {13-char id: [(t_start, t_end), ...]}: a video metadata table
    (filename, fps, video-frames) expanded to clip windows (reference
    eval_video_dataset_2.py:91-115), or a labeled clip table whose rows
    carry ``clip-t-start`` / ``t-start`` (untrimmed_video_dataset_2.py:
    75-86)."""
    segments: dict = {}
    clip_len_sec = clip_len / float(frame_rate)
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        key13 = os.path.splitext(os.path.basename(r['filename']))[0][:13]
        if 'video-frames' in r and r.get('video-frames'):
            clips = make_clip_table(
                r['filename'], float(r['fps']),
                int(float(r['video-frames'])), clip_len, frame_rate, stride)
            segments.setdefault(key13, []).extend(
                (c.t_start, c.t_end) for c in clips)
        else:
            t0 = float(r.get('clip-t-start') or r.get('t-start') or 0.0)
            segments.setdefault(key13, []).append((t0, t0 + clip_len_sec))
    return segments


class FusionDataset(DenseCaptionDataset):
    """DenseCaptionDataset + per-video sound features.  ``is_training``
    picks the split's clip CSV."""

    def __init__(self, anno_file, feature_folder, translator_json, opt,
                 seed: int = 0, audio_folder: str | None = None,
                 extractor: HubertExtractor | None = None,
                 metadata_csv: str | None = None, is_training: bool = False):
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
        self.audio_folder = audio_folder
        self.extractor = extractor
        if metadata_csv is None:
            metadata_csv = getattr(opt, 'train_csv_filename' if is_training
                                   else 'valid_csv_filename', None)
        self.clip_segments = {}
        if metadata_csv and os.path.exists(metadata_csv):
            self.clip_segments = load_clip_segments_csv(
                metadata_csv, clip_len=int(opt.clip_len or 16),
                frame_rate=float(opt.frame_rate or 15),
                stride=int(opt.stride or 16))

    def segments_for(self, key13: str, n_clips: int, duration: float):
        """Per-clip (start, end) windows: the CSV's (reference
        NewDataset.py:104-108; cut, or its last repeated, to ``n_clips``),
        else uniform."""
        segs = self.clip_segments.get(key13)
        if segs:
            return segs[:n_clips] if len(segs) >= n_clips else (
                segs + [segs[-1]] * (n_clips - len(segs)))
        return [(i * duration / n_clips, (i + 1) * duration / n_clips)
                for i in range(n_clips)]

    def load_sound(self, key: str, n_clips: int,
                   duration: float) -> np.ndarray:
        key13 = key[:13]
        if self.sound_feature_folder:
            p = os.path.join(self.sound_feature_folder, key13 + '.npy')
            if os.path.exists(p):
                return np.load(p).astype(np.float32)
        if self.extractor and self.audio_folder:
            for ext in AUDIO_EXTENSIONS:
                ap = os.path.join(self.audio_folder, key13 + ext)
                if os.path.exists(ap):
                    return self.extractor.extract(
                        ap, self.segments_for(key13, n_clips, duration),
                        key13)
        return np.zeros((n_clips, self.sound_dim), np.float32)

    def __getitem__(self, idx: int):
        s = super().__getitem__(idx)
        n_clips = s['feats'].shape[0]
        sound = self.load_sound(s['key'], n_clips, s['duration'])
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
    newTrain.py:289-306).  ``part`` (rank, ranks): each global batch is
    formed as in one process and only the rank's rows (``parallel.rows``)
    are collated, with the global batch's ``meta['keys']``."""

    def __init__(self, dataset: FusionDataset, batch_size: int, shuffle: bool,
                 opt, seed: int = 0, skip_keys: set | None = None,
                 part=(0, 1)):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.rows = rows(batch_size, *part)
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
            yield collate_rows(self.ds, idxs, self.rows, fusion_collate,
                               self.T, self.G, self.Lc)
