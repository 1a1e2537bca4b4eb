"""Clip-level video pipeline: metadata, clip tables, decoding, and the
segment tables and clip sampler of TSP training (the port's copy of
``dvc_tpu/data/video_clips.py``, numpy code that draws the same numbers).

Reference: ``video_backbone/TSP/extract_features/eval_video_dataset.py``,
``video_backbone/untrimmed_video_dataset_2.py``, and
``generate_metadata_csv.py``.  Videos are virtually resampled to a target
``frame_rate``; fixed-length windows (``clip_len`` frames) are taken every
``stride`` resampled frames; each clip is decoded, resized and normalized
with the Kinetics statistics.

Decoding uses OpenCV, imported where a video is opened; frames are
produced channels-last float32, and the extractor permutes them to the
backbones' (B, 3, T, H, W) on the device.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

KINETICS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
KINETICS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)

# per-backbone eval transforms (reference extract_features.py:78-94)
BACKBONE_INPUT = {
    'r2plus1d_34': dict(resize=(128, 171), crop=(112, 112)),
    'r2plus1d_18': dict(resize=(128, 171), crop=(112, 112)),
    'r3d_18': dict(resize=(128, 171), crop=(112, 112)),
    'mvit_v2_s': dict(resize=(224, 224), crop=(224, 224)),
}


def video_metadata(path: str):
    """(fps, num_frames, duration_s) via cv2 (replaces
    ``generate_metadata_csv.py``'s read_video_timestamps)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f'cannot open video: {path}')
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return float(fps), n, n / fps if fps else 0.0


def resample_video_idx(num_frames: int, original_fps: float, new_fps: float):
    """Frame indices selecting a new_fps stream
    (reference untrimmed_video_dataset_2.py:250-259)."""
    step = float(original_fps) / new_fps
    idxs = np.floor(np.arange(num_frames) * step).astype(np.int64)
    return idxs


@dataclass
class Clip:
    filename: str
    fps: float
    t_start: float
    t_end: float
    action_label: int = -1
    region_label: int = -1


def make_clip_table(filename: str, fps: float, video_frames: int,
                    clip_len: int = 16, frame_rate: float = 15.0,
                    stride: int = 16):
    """Uniform clip windows over the resampled stream
    (reference untrimmed_video_dataset_2.py:200-230)."""
    total_resampled = int(video_frames * (float(frame_rate) / fps))
    frame_idxs = resample_video_idx(total_resampled, fps, frame_rate)
    clip_len_sec = clip_len / frame_rate
    starts = frame_idxs[np.arange(0, max(len(frame_idxs) - clip_len + 1, 0),
                                  stride)] / fps
    return [Clip(filename, fps, float(t), float(t) + clip_len_sec)
            for t in starts]


def iou_interval(a, b):
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = min(max(a[1], b[1]) - min(a[0], b[0]),
                (a[1] - a[0]) + (b[1] - b[0]))
    return inter / (union + 1e-8)


def assign_clip_labels(clips, gt_segments, action_labels,
                       iou_threshold: float = 0.6):
    """Label clips by >= 0.6 IoU with gt segments (reference
    untrimmed_video_dataset_2.py:219-237): matched clips carry the
    segment's action label and foreground region label; others are
    background (region 0) with ignored action (-1)."""
    for c in clips:
        c.action_label = -1
        c.region_label = 0
        for seg, lab in zip(gt_segments, action_labels):
            if iou_interval((c.t_start, c.t_end), tuple(seg)) >= iou_threshold:
                c.action_label = int(lab)
                c.region_label = 1
                break
    return clips


@dataclass
class Segment:
    """One row of a TSP groundtruth CSV (reference
    ``video_backbone/TSP/data/yc2/yc2_train_tsp_groundtruth.csv``):
    a temporal segment of an untrimmed video, carrying one label per
    label column (-1 = missing, e.g. background segments have no
    action label)."""
    filename: str
    fps: float
    t_start: float
    t_end: float
    labels: tuple = ()


def load_segment_table(csv_filename: str, label_columns,
                       clip_len: int = 16, frame_rate: float = 15.0,
                       root_dir: str = '', label_mappings=None):
    """Parse a TSP groundtruth CSV into cleaned ``Segment`` rows.

    Reference ``train/untrimmed_video_dataset.py:104-132``:
    * t-end clamped to video-duration, t-start clamped to 0;
    * segments shorter than ``clip_len`` frames at ``frame_rate`` dropped;
    * ``root_dir`` prepended to filenames;
    * labels mapped through ``label_mappings`` (category string -> int id,
      reference train.py:134-138) when given, else parsed numerically;
      missing/empty labels -> -1 (ignore_index).

    A legacy clip-window CSV (one row per fixed clip, span == clip
    length) passes as segments with no room to jitter: the sampler then
    draws each row ``clips_per_segment`` times an epoch, the same clip
    each time, as the JAX driver does.
    """
    with open(csv_filename) as f:
        rows = list(csv.DictReader(f))
    label_mappings = label_mappings or [None] * len(label_columns)
    min_len_sec = clip_len / float(frame_rate)
    segments, dropped = [], 0
    for r in rows:
        t_start = max(float(r.get('t-start', 0) or 0), 0.0)
        t_end = float(r.get('t-end', 0) or 0)
        dur = r.get('video-duration')
        if dur not in (None, ''):
            t_end = min(t_end, float(dur))
        # keep segments with >= clip_length frames (reference :110-116);
        # the epsilon keeps exactly-clip-length rows (legacy clip-window
        # CSVs) through float roundoff
        if (t_end - t_start) < min_len_sec - 1e-9:
            dropped += 1
            continue
        labels = []
        for col, mapping in zip(label_columns, label_mappings):
            raw = r.get(col)
            if raw is None or raw == '':
                labels.append(-1)
            elif mapping is not None:
                labels.append(int(mapping.get(raw, -1)))
            else:
                try:
                    labels.append(int(float(raw)))
                except ValueError:
                    raise ValueError(
                        f'label column {col!r} holds category strings '
                        f'({raw!r}); pass --label-mapping-jsons')
        segments.append(Segment(
            filename=os.path.join(root_dir, r['filename']),
            fps=float(r.get('fps', 30) or 30),
            t_start=t_start, t_end=t_end, labels=tuple(labels)))
    if dropped:
        print(f'<load_segment_table>: removed {dropped}='
              f'{100 * dropped / max(len(rows), 1):.2f}% of {len(rows)} '
              f'segments shorter than clip_length={clip_len} frames at '
              f'frame_rate={frame_rate} fps')
    return segments


class SegmentClipSampler:
    """Samples fixed-length clips from segment rows — the reference's
    training input regime (``train/untrimmed_video_dataset.py:66-78``).

    One epoch = ``len(segments) * clips_per_segment`` items, item ``idx``
    drawing from segment ``idx % len(segments)``.  With
    ``temporal_jittering`` the in-segment position ratio is drawn
    uniformly at random per item (train) from the sampler's own
    ``np.random.RandomState(seed)``, one draw a ``clip_at`` call, so a
    seed gives the JAX sampler's sequence; otherwise it is the fixed
    ``linspace(0, 1, clips_per_segment)[idx // len(segments)]`` grid
    (validation)."""

    def __init__(self, segments, clip_len: int = 16,
                 frame_rate: float = 15.0, clips_per_segment: int = 5,
                 temporal_jittering: bool = True, seed: int = 42):
        self.segments = list(segments)
        self.clip_len = clip_len
        self.frame_rate = float(frame_rate)
        self.clips_per_segment = clips_per_segment
        self.temporal_jittering = temporal_jittering
        self.rng = np.random.RandomState(seed=seed)
        self.uniform_sampling = np.linspace(0, 1, clips_per_segment)

    def __len__(self):
        return len(self.segments) * self.clips_per_segment

    def clip_at(self, idx: int):
        """(segment, clip_t_start) for dataset item ``idx``."""
        seg = self.segments[idx % len(self.segments)]
        clip_len_sec = self.clip_len / self.frame_rate
        if self.temporal_jittering:
            ratio = self.rng.uniform()
        else:
            ratio = self.uniform_sampling[idx // len(self.segments)]
        t = seg.t_start + ratio * (seg.t_end - seg.t_start - clip_len_sec)
        return seg, float(t)


def decode_clip(path: str, t_start: float, clip_len: int, frame_rate: float,
                resize=(224, 224), crop=(224, 224), flip=False,
                crop_offset=None):
    """Decode ``clip_len`` frames at ``frame_rate`` starting at ``t_start``
    seconds; resize, crop, normalize.  Returns (T, H, W, 3) f32.

    ``crop_offset=None`` center-crops (eval transform); an explicit
    ``(y0, x0)`` implements RandomCrop with the caller drawing the offset
    (reference train transform, ``TSP/train/train.py:155-177``: Resize ->
    RandomHorizontalFlip -> Normalize -> RandomCrop; flip/crop order
    commutes distributionally for a uniform offset).

    Missing frames at the end of the video are repeated (same effect as the
    reference's torchvision decode + pad)."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f'cannot open video: {path}')
    fps = cap.get(cv2.CAP_PROP_FPS) or frame_rate
    frames = []
    step = fps / frame_rate
    base = t_start * fps
    pos = int(round(base))
    cap.set(cv2.CAP_PROP_POS_FRAMES, pos)
    cur = pos
    want = [int(round(base + i * step)) for i in range(clip_len)]
    ok_any = False
    for target in want:
        while cur <= target:
            ok, frame = cap.read()
            if not ok:
                frame = None
                break
            cur += 1
        if frame is None:
            break
        ok_any = True
        f = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        f = cv2.resize(f, (resize[1], resize[0]))
        frames.append(f)
    cap.release()
    if not ok_any:
        frames = [np.zeros((resize[0], resize[1], 3), np.uint8)]
    while len(frames) < clip_len:
        frames.append(frames[-1])
    x = np.stack(frames[:clip_len]).astype(np.float32) / 255.0
    H, W = x.shape[1:3]
    ch, cw = crop
    if crop_offset is None:
        y0, x0 = (H - ch) // 2, (W - cw) // 2   # center crop (eval)
    else:
        y0, x0 = crop_offset                    # RandomCrop (train)
    x = x[:, y0:y0 + ch, x0:x0 + cw]
    if flip:
        x = x[:, :, ::-1]
    return (x - KINETICS_MEAN) / KINETICS_STD


class ClipBatcher:
    """Batches a video's clips for feature extraction: (clips (n, T, H, W,
    3) f32, n, the batch's ``Clip`` rows).  The last batch holds the clips
    that are left (the JAX copy pads it to ``batch_size`` with zero clips
    for its static shapes; here they would only cost backbone time)."""

    def __init__(self, clips, batch_size: int, clip_len: int,
                 frame_rate: float, backbone: str = 'mvit_v2_s',
                 flip=False):
        self.clips = clips
        self.batch_size = batch_size
        self.clip_len = clip_len
        self.frame_rate = frame_rate
        spec = BACKBONE_INPUT[backbone]
        self.resize, self.crop = spec['resize'], spec['crop']
        self.flip = flip

    def __iter__(self):
        for i in range(0, len(self.clips), self.batch_size):
            chunk = self.clips[i:i + self.batch_size]
            xs = [decode_clip(c.filename, c.t_start, self.clip_len,
                              self.frame_rate, self.resize, self.crop,
                              self.flip) for c in chunk]
            yield np.stack(xs), len(xs), chunk
