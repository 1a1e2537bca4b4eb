"""Feature-mode dataset and static-shape collation (port of
``dvc_tpu/data/dataset.py``; reference ``data/video_dataset.py``).

Per-video ``.npy`` features are read and rescaled to
``frame_embedding_num`` rows by the native library (``native_io``, built at
first use), as the JAX dataset reads them where that library is built.
Gt events are subsampled to ``gt_proposal_sample_num``, captions
tokenized, and a batch collated to static shapes: video (B, T, C), gt
(B, G, 2), captions (B, G, Lc), with masks.  :class:`BatchLoader`
shuffles and batches a dataset, as the JAX ``BatchLoader`` does in one
process.  A missing feature file degrades to zeros, and invalid-video
lists filter keys, as in the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..parallel.mesh import rows
from ..parallel.multihost import host_shard_order
from . import native_io
from .vocabulary import Translator

# per-type feature dims / normalization / filename patterns
# (reference get_feats, video_dataset.py:337-383); the port reads .npy only
FEATURE_SPECS = {
    'c3d': dict(dim=500, mean=-0.001915027447565527, var=1.9239444588254049,
                path=lambda folder, key: os.path.join(folder, key[0:13] + '.npy')),
    'resnet': dict(dim=2048, mean=0.41634243404998694, var=0.2569392081183313,
                   path=lambda folder, key: os.path.join(folder, key[2:13] + '_resnet.npy')),
    'bn': dict(dim=1024, mean=0.8945046635916155, var=3.6579982046018844,
               path=lambda folder, key: os.path.join(folder, key[2:13] + '_bn.npy')),
    'i3d_rgb': dict(dim=1024, mean=0., var=1.,
                    path=lambda folder, key: os.path.join(folder, key[:13] + '_rgb.npy')),
    'i3d_flow': dict(dim=1024, mean=0., var=1.,
                     path=lambda folder, key: os.path.join(folder, key[:13] + '_flow.npy')),
    'tsp': dict(dim=512, mean=0., var=1.,
                path=lambda folder, key: os.path.join(folder, key[0:13] + '.npy')),
    'tsp_mvit': dict(dim=768, mean=0., var=1.,
                     path=lambda folder, key: os.path.join(folder, key[0:13] + '.npy')),
    'vggish': dict(dim=128, mean=0., var=1.,
                   path=lambda folder, key: os.path.join(folder, key[0:13] + '.npy')),
}


def read_feature_file(path: str, feat_dim: int, mean=0., var=1.,
                      data_norm=False):
    """Load one ``.npy`` feature file as f32 through the native library (a
    file whose format it refuses, Fortran-ordered or not f4/f8, with
    ``np.load``, as the JAX dataset does); (100, feat_dim) zeros when
    missing."""
    if os.path.exists(path):
        feats = native_io.load_npy(path)
        if feats is None:
            feats = np.load(path)
    else:
        feats = np.zeros((100, feat_dim), np.float32)
    if data_norm:
        feats = (feats - mean) / np.sqrt(var)
    return feats.astype(np.float32)


def resize_feature(feats: np.ndarray, new_size: int,
                   method: str = 'nearest') -> np.ndarray:
    """Temporal rescale of (T, C) features to ``new_size`` rows by the
    native library: 'nearest' takes row round(x), halves rounded away from
    zero, 'linear' lerps rows floor(x) and floor(x) + 1, at
    x = i * (T - 1) / (new_size - 1) (``native_io.resize_feature_ref`` is
    the same in numpy)."""
    return native_io.resize_feature(feats, new_size, method)


class DenseCaptionDataset:
    """PropSeqDataset equivalent (reference video_dataset.py:183-293)."""

    def __init__(self, anno_file: str, feature_folder, translator_json: str,
                 opt, seed: int = 0):
        with open(anno_file) as f:
            self.anno = json.load(f)
        self.translator = Translator(translator_json, opt.vocab_size)
        self.keys = list(self.anno.keys())
        for json_path in opt.invalid_video_json:
            with open(json_path) as f:
                invalid = json.load(f)
            self.keys = [k for k in self.keys if k[:13] not in invalid]
        self.feature_folder = feature_folder
        self.opt = opt
        self.rng = np.random.default_rng(seed)
        self.max_caption_len = opt.max_caption_len
        self.gt_proposal_sample_num = opt.gt_proposal_sample_num

    def __len__(self):
        return len(self.keys)

    def load_feats(self, key: str) -> np.ndarray:
        opt = self.opt
        vf_types = opt.visual_feature_type
        if not isinstance(vf_types, (list, tuple)):
            vf_types, folders = [vf_types], [self.feature_folder]
        else:
            folders = self.feature_folder
            if len(folders) != len(vf_types):
                raise ValueError('one feature folder per feature type')
        parts = []
        for vf_type, folder in zip(vf_types, folders):
            spec = FEATURE_SPECS[vf_type]
            # zero-pad dim for a missing file: the configured total dim when
            # a single feature type is used, else the type's own dim
            pad_dim = opt.feature_dim if len(vf_types) == 1 else spec['dim']
            feats = read_feature_file(
                spec['path'](folder, key), pad_dim, spec['mean'],
                spec['var'], data_norm=bool(opt.data_norm))
            if opt.data_rescale:
                if feats.shape[0] != opt.frame_embedding_num:
                    feats = resize_feature(feats, opt.frame_embedding_num,
                                           opt.sample_method)
            else:
                feats = feats[::opt.feature_sample_rate]
            parts.append(feats)
        out = np.concatenate(parts, axis=-1)
        if out.shape[1] != opt.feature_dim:
            raise ValueError(f'feature_dim mismatch: {out.shape[1]} != '
                             f'{opt.feature_dim}')
        return out

    def kept_events(self, n: int) -> set:
        """The gt events of a video with n that the sample keeps: a random
        subsample to the static budget, order-preserving (reference
        video_dataset.py:276-282, applied in train and eval), drawn from
        the dataset's rng where n exceeds the budget."""
        g = min(n, self.gt_proposal_sample_num)
        return (set(self.rng.choice(n, g, replace=False).tolist()) if n > g
                else set(range(n)))

    def skip(self, idx: int):
        """Draw what ``self[idx]`` draws and load nothing: a rank that
        collates other rows of a global batch keeps the rng where the
        one-process run has it."""
        self.kept_events(len(self.anno[str(self.keys[idx])]['timestamps']))

    def __getitem__(self, idx: int):
        key = str(self.keys[idx])
        feats = self.load_feats(key)
        entry = self.anno[key]
        captions = entry['sentences']
        gt_timestamps = entry['timestamps']
        action_labels = entry.get('action_labels', [0] * len(gt_timestamps))

        n = len(gt_timestamps)
        keep = self.kept_events(n)
        captions = [captions[i] for i in range(n) if i in keep]
        gt_timestamps = [gt_timestamps[i] for i in range(n) if i in keep]
        action_labels = [action_labels[i] for i in range(n) if i in keep]
        cap_ids = [self.translator.translate(s, self.max_caption_len)
                   for s in captions]
        return dict(feats=feats, gt_timestamps=gt_timestamps,
                    labels=action_labels, cap_ids=cap_ids,
                    duration=entry['duration'], captions=captions, key=key)


def collate(samples, T: int, G: int, Lc: int):
    """Static-shape collation (reference collate_fn, video_dataset.py:15-149).
    T/G/Lc: static pads for frames / gt events / caption length.  Returns
    (batch, meta); meta holds the video keys, their durations (s), their
    gt timestamps and their captions."""
    B = len(samples)
    C = samples[0]['feats'].shape[1]
    video = np.zeros((B, T, C), np.float32)
    vmask = np.zeros((B, T), bool)
    vlen = np.zeros((B, 3), np.float32)
    boxes = np.zeros((B, G, 2), np.float32)
    gmask = np.zeros((B, G), bool)
    labels = np.zeros((B, G), np.int64)
    caps = np.zeros((B, G, Lc), np.int64)
    cmask = np.zeros((B, G, Lc), bool)
    keys, durations, raw_ts, raw_caps = [], [], [], []
    for b, s in enumerate(samples):
        f = s['feats']
        L = min(len(f), T)
        video[b, :L] = f[:L]
        vmask[b, :L] = True
        dur = float(s['duration'])
        g = min(len(s['gt_timestamps']), G)
        vlen[b] = [L, dur, g]
        for j in range(g):
            ts = s['gt_timestamps'][j]
            boxes[b, j] = [(ts[1] + ts[0]) / (2 * dur), (ts[1] - ts[0]) / dur]
            gmask[b, j] = True
            labels[b, j] = s['labels'][j]
            ids = s['cap_ids'][j][:Lc]
            caps[b, j, :len(ids)] = ids
            cmask[b, j, :len(ids)] = True
        keys.append(s['key'])
        durations.append(dur)
        raw_ts.append(s['gt_timestamps'])
        raw_caps.append(s.get('captions'))
    batch = {
        'video_tensor': video, 'video_mask': vmask, 'video_length': vlen,
        'gt_boxes': boxes, 'gt_boxes_mask': gmask,
        'gt_labels': labels.astype(np.int32),
        'cap_tensor': caps.astype(np.int32), 'cap_mask': cmask,
    }
    return batch, {'keys': keys, 'durations': durations,
                   'raw_timestamps': raw_ts, 'raw_captions': raw_caps}


def collate_rows(ds, idxs, part: slice, collate_fn, T: int, G: int,
                 Lc: int):
    """The rows ``part`` of the global batch of samples ``idxs``, collated
    by ``collate_fn``; the other rows are only drawn (``ds.skip``), so the
    dataset's rng moves as in the one-process run.  ``meta`` is the
    collated rows', but ``meta['keys']`` the global batch's (the visited
    videos of a restart)."""
    samples = []
    for j, i in enumerate(idxs):
        if part.start <= j < part.stop:
            samples.append(ds[int(i)])
        else:
            ds.skip(int(i))
    batch, meta = collate_fn(samples, T, G, Lc)
    meta['keys'] = [str(ds.keys[int(i)]) for i in idxs]
    return batch, meta


class BatchLoader:
    """Shuffling static-pad batch iterator over a
    :class:`DenseCaptionDataset` (the JAX ``BatchLoader``: the same batches
    in the same order for the same seed).  Epoch e's order is a permutation
    drawn from ``seed + 1000003 * e``; call :meth:`set_epoch` each epoch (a
    loader that never has advances its epoch on each pass).  ``drop_last``
    (default: ``shuffle``) drops a short last batch; otherwise the last
    sample is repeated to the static batch size, and ``meta['n_real']``
    says how many are real.

    ``process_index`` / ``process_count``: the JAX loader's per-host split
    (``parallel.host_shard_order``: each host its strided slice of the
    epoch, batches of ``batch_size`` from it).  ``part`` (rank, ranks):
    each global batch of ``batch_size`` is formed as in one process and
    only the rank's rows ``parallel.rows`` are collated, the JAX data
    mesh's ``P('data')`` split."""

    def __init__(self, dataset: DenseCaptionDataset, batch_size: int,
                 shuffle: bool, opt, drop_last: bool | None = None,
                 seed: int = 0, process_index: int | None = None,
                 process_count: int | None = None, part=(0, 1)):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._epoch_pinned = False
        self.process_index = process_index
        self.process_count = process_count
        self.rows = rows(batch_size, *part)
        self.T = opt.frame_embedding_num
        self.G = opt.gt_proposal_sample_num
        self.Lc = opt.max_caption_len
        self.drop_last = shuffle if drop_last is None else drop_last

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)
        self._epoch_pinned = True

    def _per_host(self) -> bool:
        return self.process_count not in (None, 1) \
            or self.process_index is not None

    def __len__(self):
        n = len(self.ds)
        if self._per_host():
            n = len(host_shard_order(n, 0, False, self.seed,
                                     self.process_index, self.process_count))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch = self.epoch
        if not self._epoch_pinned:
            self.epoch += 1
        if self._per_host():
            order = host_shard_order(len(self.ds), epoch, self.shuffle,
                                     self.seed, self.process_index,
                                     self.process_count)
        else:
            order = np.arange(len(self.ds))
            if self.shuffle:
                np.random.default_rng(
                    self.seed + 1000003 * epoch).shuffle(order)
        for i in range(len(self)):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            n_real = len(idxs)
            if n_real < self.batch_size:
                # repeat the last sample to keep the static batch shape
                idxs = np.concatenate(
                    [idxs, np.repeat(idxs[-1:], self.batch_size - n_real)])
            batch, meta = collate_rows(self.ds, idxs, self.rows, collate,
                                       self.T, self.G, self.Lc)
            meta['n_real'] = n_real
            yield batch, meta
