"""Model-specific video preprocessing and cached-clip loading: the port's
copy of the JAX package's ``data/video_io.py``.

- ``VIDEO_TRANSFORMS``: the published torchvision Kinetics-400 transform
  of each backbone (resize, center crop, rescale, normalize);
- ``apply_transform``: uint8 (T, H, W, 3) frames to the normalized float32
  clip, with torchvision's exact uint8 tensor resize;
- ``load_clips``, ``ClipDataset`` (lazy, one ``.npy`` per clip in the
  channels-last cache layout (T, H, W, 3)), ``ArrayClips`` (in memory) and
  ``prefetch_batches``, the ordered, bounded, re-raising batch iterator
  that the video evaluation streams through.

Left out until a video decoder is on the machine with the card: decoding
(``decode_video``), ``preprocess_video_dir``, ``check_video_integrity`` and
the cv2 resize backend.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Batch = Tuple[np.ndarray, np.ndarray]


@dataclass(frozen=True)
class VideoTransform:
    """Published torchvision VideoClassification transform parameters."""
    resize: Tuple[int, int]     # (H, W) before the crop; (s, -1) = short side
    crop: Tuple[int, int]
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


KINETICS_MEAN = (0.43216, 0.394666, 0.37645)
KINETICS_STD = (0.22803, 0.22145, 0.216989)

# per-model transforms (torchvision weights enums' published configs;
# reference video/preprocess.py:32-48)
VIDEO_TRANSFORMS = {
    "ResNet": VideoTransform((128, 171), (112, 112), KINETICS_MEAN,
                             KINETICS_STD),
    "S3D": VideoTransform((256, 256), (224, 224), KINETICS_MEAN,
                          KINETICS_STD),
    "MViT-v1": VideoTransform((256, -1), (224, 224),
                              (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "MViT-v2": VideoTransform((256, -1), (224, 224),
                              (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)),
    "Swin-T": VideoTransform((256, -1), (224, 224),
                             (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "Swin-S": VideoTransform((256, -1), (224, 224),
                             (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def _resize_dims(h: int, w: int, resize) -> Tuple[int, int]:
    """Target dims as torchvision's F.resize computes them: in short-side
    mode the long side is int(size * long / short), truncated."""
    if resize[1] != -1:
        return resize
    size = resize[0]
    short, long = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)


def _resize_torch(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """torchvision's uint8 tensor resize: to float, bilinear (no antialias,
    half-pixel centers), rounded and clamped back to uint8."""
    t = torch.from_numpy(frames).permute(0, 3, 1, 2).float()
    r = F.interpolate(t, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return r.round_().clamp_(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).numpy()


def apply_transform(frames: np.ndarray, tf: VideoTransform) -> np.ndarray:
    """uint8 (T, H, W, 3) -> normalized float32 (T, crop H, crop W, 3)."""
    _, h, w, _ = frames.shape
    new_h, new_w = _resize_dims(h, w, tf.resize)
    resized = _resize_torch(frames, new_h, new_w)
    ch, cw = tf.crop
    # torchvision's center_crop rounds the offsets
    top = int(round((new_h - ch) / 2.0))
    left = int(round((new_w - cw) / 2.0))
    out = resized[:, top:top + ch, left:left + cw].astype(np.float32) / 255.0
    return ((out - np.asarray(tf.mean, np.float32))
            / np.asarray(tf.std, np.float32))


def load_clips(cache_dir: str, labels: Sequence[str],
               frame_stride: int = 1, num_threads: int = 8) -> np.ndarray:
    """Cached clips -> (N, T // stride, H, W, 3) float32."""
    paths = [os.path.join(cache_dir, f"{label}.npy") for label in labels]
    probe = np.load(paths[0])[::frame_stride]
    out = np.zeros((len(paths), *probe.shape), dtype=np.float32)
    out[0] = probe

    def fill(i):
        out[i] = np.load(paths[i])[::frame_stride]

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(fill, range(1, len(paths))))
    return out


class ClipDataset:
    """Lazy cached-clip access (reference VideoDataset,
    video/load_data.py:20-61): one ``.npy`` read per lookup, every
    ``frame_stride``-th frame."""

    def __init__(self, cache_dir: str, labels: Sequence[str], y: np.ndarray,
                 frame_stride: int = 1):
        self.cache_dir = cache_dir
        self.labels = list(labels)
        self.y = y
        self.stride = frame_stride

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        x = np.load(os.path.join(self.cache_dir,
                                 f"{self.labels[i]}.npy"))[::self.stride]
        return x, self.y[i]

    def example(self) -> np.ndarray:
        """(1, T, H, W, 3) shape and dtype probe."""
        return self[0][0][None]

    def batch(self, idx: Sequence[int]) -> Batch:
        xs = np.stack([self[i][0] for i in idx])
        return xs, self.y[np.asarray(idx)]


class ArrayClips:
    """In-memory clips with the ClipDataset interface."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        self.x = x
        self.y = y

    def __len__(self) -> int:
        return self.x.shape[0]

    def example(self) -> np.ndarray:
        return self.x[:1]

    def batch(self, idx: Sequence[int]) -> Batch:
        idx = np.asarray(idx)
        return self.x[idx], self.y[idx]


def prefetch_batches(dataset, index_matrix, num_workers: int = 4,
                     prefetch: int = 2) -> Iterator[Batch]:
    """Ordered batches ``dataset.batch(row)`` for each row of
    ``index_matrix``, assembled by ``num_workers`` threads ahead of the
    consumer. At most ``prefetch`` finished batches wait and at most
    ``prefetch + num_workers`` loads are in flight, so host memory is
    O((prefetch + num_workers) x batch) whatever the dataset's size. A
    worker's exception is raised to the consumer, never a short epoch."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()

    def producer():
        try:
            pending: deque = deque()
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for row in index_matrix:
                    pending.append(pool.submit(dataset.batch, row))
                    if len(pending) > prefetch + num_workers:
                        q.put(pending.popleft().result())  # backpressure
                while pending:
                    q.put(pending.popleft().result())
        except BaseException as exc:  # handed to the consumer, raised there
            q.put(exc)
        finally:
            q.put(stop)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
