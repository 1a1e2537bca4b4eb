"""Streaming decode -> TSP features -> PDVC (port of
``dvc_tpu/data/streaming.py``): no ``.npy`` round trip.

The reference's end-to-end path writes features to disk between the
backbone and PDVC (``ete/eval.py:144-194`` runs the extractor, writes
per-video ``.npy`` files, then reads them back).
:class:`StreamingFeatureDataset` is a :class:`DenseCaptionDataset` whose
``load_feats`` decodes the video's clips (cv2, host) and runs the TSP
backbone (the device) at load time.  The loaders' worker thread
(``PrefetchLoader`` / ``DevicePrefetchLoader``) calls it, so a video's
decode and backbone run while the trainer steps on the batch before;
within a video the extractor's own decode thread works a clip batch
ahead of the backbone.

With a frozen backbone the features are deterministic, so an in-memory
LRU cache keeps repeated epochs at feature-file speed; ``cache_size=0``
(or :meth:`~StreamingFeatureDataset.refresh` after a backbone update)
re-extracts every time.
"""

from __future__ import annotations

import collections
import glob
import os

import numpy as np

from .dataset import FEATURE_SPECS, DenseCaptionDataset, resize_feature

VIDEO_EXTS = ('.mp4', '.mkv', '.webm', '.avi')


def index_videos(video_dir: str) -> dict:
    """Map 13-char video key -> file path (reference file naming:
    ``<video_id>.mp4`` with YouTube-style ids)."""
    table = {}
    for p in sorted(glob.glob(os.path.join(video_dir, '*'))):
        if p.lower().endswith(VIDEO_EXTS):
            table[os.path.splitext(os.path.basename(p))[0][:13]] = p
    return table


class StreamingFeatureDataset(DenseCaptionDataset):
    """DenseCaptionDataset over raw videos: features come from the TSP
    backbone at load time instead of ``.npy`` files.  ``extractor``
    (shared between a run's train and val sets) defaults to one built from
    ``opt`` (``backbone_tsp``, ``tsp_checkpoint``, ``clip_len``,
    ``extraction_dtype``) on ``device``.  An annotation without a readable
    video gets (100, feature_dim) zeros, as a missing feature file does."""

    def __init__(self, anno_file: str, video_dir: str, translator_json: str,
                 opt, seed: int = 0, extractor=None, cache_size: int = 4096,
                 device='cuda'):
        super().__init__(anno_file, video_dir, translator_json, opt,
                         seed=seed)
        self.videos = index_videos(video_dir)
        if extractor is None:
            from ..models.tsp import FeatureExtractor
            extractor = FeatureExtractor(
                opt.backbone_tsp, opt.tsp_checkpoint or None,
                clip_len=opt.clip_len, dtype=opt.extraction_dtype,
                device=device)
        self.extractor = extractor
        self.frame_rate = opt.frame_rate
        self.stride = opt.stride
        self.clip_batch_size = opt.in_batch_size
        self._cache_size = cache_size
        self._cache: collections.OrderedDict = collections.OrderedDict()
        vf = opt.visual_feature_type
        vf = vf[0] if isinstance(vf, (list, tuple)) else vf
        self._spec = FEATURE_SPECS.get(vf, FEATURE_SPECS['tsp_mvit'])

    def refresh(self):
        """Drop cached features (call after a backbone weight update)."""
        self._cache.clear()

    def _extract(self, key: str) -> np.ndarray:
        zeros = np.zeros((100, self.opt.feature_dim), np.float32)
        path = self.videos.get(key[:13])
        if path is None:
            return zeros
        from .video_clips import video_metadata
        try:
            fps, n_frames, _ = video_metadata(path)
        except IOError:
            return zeros
        feats = self.extractor.extract_video(
            path, fps, n_frames, frame_rate=self.frame_rate,
            stride=self.stride, batch_size=self.clip_batch_size)
        return feats if len(feats) else zeros

    def load_feats(self, key: str) -> np.ndarray:
        opt = self.opt
        k = key[:13]
        feats = self._cache.get(k)
        if feats is None:
            feats = self._extract(key)
            if self._cache_size:
                self._cache[k] = feats
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(k)
        if bool(opt.data_norm):
            feats = ((feats - self._spec['mean'])
                     / np.sqrt(self._spec['var'])).astype(np.float32)
        if opt.data_rescale:
            if feats.shape[0] != opt.frame_embedding_num:
                feats = resize_feature(feats, opt.frame_embedding_num,
                                       opt.sample_method)
        else:
            feats = feats[::opt.feature_sample_rate]
        if feats.shape[1] != opt.feature_dim:
            raise ValueError(f'feature_dim mismatch: {feats.shape[1]} != '
                             f'{opt.feature_dim}')
        return feats
