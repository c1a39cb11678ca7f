"""Host-side input pipeline (counterpart of the JAX package's
``data/pipeline.py``): shuffled full batches, each epoch skipping the last
batch as the reference engine does, and one batch copied ahead to the
device from pinned host memory.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  skip_last: bool = True) -> np.ndarray:
    """Shuffled index matrix (num_batches, batch_size) for one epoch.

    With skip_last (the reference's behavior), num_batches =
    ceil(n / batch_size) - 1 and every batch is full.
    """
    perm = rng.permutation(n)
    if skip_last:
        nb = max(math.ceil(n / batch_size) - 1, 0)
    else:
        nb = n // batch_size
    return perm[:nb * batch_size].reshape(nb, batch_size)


def prefetch_batches(x: np.ndarray, y: np.ndarray, index_matrix: np.ndarray,
                     device: torch.device
                     ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (x_batch, y_batch) on ``device`` for each row of
    ``index_matrix``.

    On a CUDA device each batch is gathered into one of two pinned host
    buffers and copied on a side stream, one batch ahead of the one
    yielded, so the copy of batch i + 1 overlaps the step on batch i; the
    consuming stream waits for a batch's copy before it is yielded, and a
    buffer is refilled only after its previous copy has finished. On the
    CPU the gathered arrays are yielded as they are.
    """
    if device.type != "cuda":
        for idx in index_matrix:
            yield torch.from_numpy(x[idx]), torch.from_numpy(y[idx])
        return
    if not len(index_matrix):
        return
    bs = index_matrix.shape[1]
    buffers = [tuple(torch.empty((bs,) + a.shape[1:],
                                 dtype=torch.from_numpy(a[:0]).dtype,
                                 pin_memory=True) for a in (x, y))
               for _ in range(2)]
    copied: List[Optional[torch.cuda.Event]] = [None, None]
    side = torch.cuda.Stream(device)

    def put(i):
        slot = i % 2
        if copied[slot] is not None:
            copied[slot].synchronize()
        hx, hy = buffers[slot]
        np.take(x, index_matrix[i], axis=0, out=hx.numpy())
        np.take(y, index_matrix[i], axis=0, out=hy.numpy())
        with torch.cuda.stream(side):
            batch = (hx.to(device, non_blocking=True),
                     hy.to(device, non_blocking=True))
            copied[slot] = torch.cuda.Event()
            copied[slot].record(side)
        return batch, copied[slot]

    ahead = put(0)
    for i in range(len(index_matrix)):
        (bx, by), done = ahead
        if i + 1 < len(index_matrix):
            ahead = put(i + 1)
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        bx.record_stream(consumer)
        by.record_stream(consumer)
        yield bx, by


def chunked(n: int, chunk: int) -> Sequence[Tuple[int, int]]:
    """[(start, size)] covering range(n) in fixed chunks (last may be
    short)."""
    return [(s, min(chunk, n - s)) for s in range(0, n, chunk)]


def pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad axis 0 to ``size`` (for fixed-size eval chunks)."""
    if arr.shape[0] == size:
        return arr
    pad = np.zeros((size - arr.shape[0], *arr.shape[1:]), dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
