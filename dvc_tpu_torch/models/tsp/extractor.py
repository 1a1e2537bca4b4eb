"""Reusable TSP feature extractor: a backbone, its weights and the clip
forward (port of ``dvc_tpu/models/tsp/extractor.py``; reference: the
model setup of
``video_backbone/TSP/extract_features/extract_features.py:203-231``).

Shared by ``python -m dvc_tpu_torch.extract_features`` (per-video
``.npy`` files) and the streaming datasets (``data/streaming.py``), which
featurize videos while PDVC trains or evaluates.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .backbones import MViTConfig
from .convert import load_tsp_weights, tsp_weights
from .model import init_backbone_, make_backbone

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@contextlib.contextmanager
def full_float32():
    """cuDNN's convolutions and cuBLAS's matmuls in true float32 for the
    block (both may take TF32 otherwise): ``--dtype float32`` means what
    it means in the JAX package."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


class FeatureExtractor:
    """A TSP backbone in feature-extraction mode.

    ``features(x)`` maps a (B, clip_len, H, W, 3) float batch of decoded
    clips (host numpy or a tensor, channels-last as the decoder gives it)
    to (B, feat_dim) float32 clip features on ``device``: the clips are
    uploaded in float32, cast to ``dtype`` and permuted to (B, 3, T, H, W)
    on the device.  Under bfloat16 the weights are cast too (inference
    only).  Weights: ``checkpoint`` (a ``.pth`` or JAX ``.ckpt``,
    :func:`~.convert.load_tsp_weights`), else ``state_dict`` (one for
    :func:`~.convert.tsp_weights`), else random ones of seed 0.  ``config``
    sizes an MViT other than MViTv2-S.

    ``decode_seconds`` and ``backbone_seconds`` add up the host time
    spent decoding clips (the decode thread) and in the backbone up to
    the features' copy to the host (the caller's thread);
    ``videos`` and ``clips`` count what :meth:`extract_video` did.
    """

    def __init__(self, backbone: str, checkpoint: str | None = None,
                 clip_len: int = 16, dtype: str = 'bfloat16',
                 device='cuda', config: MViTConfig | None = None,
                 state_dict=None):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('FeatureExtractor: no CUDA device (pass '
                               "device='cpu' for the CPU)")
        if dtype not in DTYPES:
            raise ValueError(f'dtype {dtype!r}: one of {sorted(DTYPES)}')
        self.backbone = backbone
        self.clip_len = clip_len
        self.dtype = dtype
        if checkpoint or state_dict is not None:
            w = (load_tsp_weights(checkpoint, backbone, config) if checkpoint
                 else tsp_weights(state_dict, backbone, config))
            with torch.device('meta'):
                model = make_backbone(backbone, config, w.mid_layout)
            model.load_state_dict(w.features, strict=True, assign=True)
        else:
            with torch.device('meta'):
                model = make_backbone(backbone, config)
            model.to_empty(device='cpu')
            init_backbone_(model, torch.Generator().manual_seed(0))
        self.model = model.to(self.device, DTYPES[dtype]).eval()
        self.feat_dim = model.feature_size
        self.decode_seconds = self.backbone_seconds = 0.0
        self.videos = self.clips = 0

    def precision(self):
        """The numeric context of the forward: true float32 on the card
        under ``dtype`` float32 (:func:`full_float32`)."""
        if self.dtype == 'float32' and self.device.type == 'cuda':
            return full_float32()
        return contextlib.nullcontext()

    def features(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        with torch.inference_mode(), self.precision():
            x = x.to(self.device, torch.float32, non_blocking=True)
            feats = self.model(x.to(DTYPES[self.dtype])
                               .permute(0, 4, 1, 2, 3))
        return feats.float()

    def extract_video(self, filename: str, fps: float, video_frames: int,
                      frame_rate: float = 15, stride: int = 16,
                      batch_size: int = 32) -> np.ndarray:
        """Decode and featurize one whole video -> (n_clips, feat_dim)
        float32 numpy (the per-video loop of ``extract_features``).  A
        worker thread decodes (and, on the card, pins) the next batches
        while the backbone runs on this one; each batch's features come
        back to the host in one synchronising copy."""
        from ...data.prefetch import PrefetchLoader
        from ...data.video_clips import ClipBatcher, make_clip_table
        clips = make_clip_table(filename, fps, video_frames, self.clip_len,
                                frame_rate, stride)
        if not clips:
            return np.zeros((0, self.feat_dim), np.float32)
        batcher = ClipBatcher(clips, batch_size, self.clip_len, frame_rate,
                              self.backbone)
        pin = self.device.type == 'cuda'

        def decoded():
            it = iter(batcher)
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                if item is None:
                    return
                x = torch.from_numpy(item[0])
                if pin:
                    x = x.pin_memory()
                self.decode_seconds += time.perf_counter() - t0
                yield x

        feats = []
        for x in PrefetchLoader(decoded()):
            t0 = time.perf_counter()
            feats.append(self.features(x).cpu().numpy())
            self.backbone_seconds += time.perf_counter() - t0
        self.videos += 1
        self.clips += len(clips)
        return np.concatenate(feats)
