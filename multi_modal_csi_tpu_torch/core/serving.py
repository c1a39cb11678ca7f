"""Serving CSI and video models: the JAX package's serving contract
(``core/export.py:99-107``, ``:151-189``; ``train/loop.py:238-242``) around
an eager PyTorch model.

- Every float32 parameter and persistent buffer (BatchNorm running stats
  included) is cast once to the serving dtype.
- The input is cast to the serving dtype in the forward.
- Logits come back as float32.
- A request of any number of samples (CSI windows, video clips) is split
  into batches of the serving batch; the last is zero-padded, and the
  padding is cut from the output along the model's output batch axis
  (from the model table, never guessed from sizes).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..runners.csi import CSI_MODELS
from ..runners.video import video_spec
from ..train.loop import cast_for_serving
from .config import resolve_serving_batch, resolve_serving_dtype
from .device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
__all__ = ["CSIServer", "VideoServer", "cast_for_serving"]


class _Server:
    """Ragged requests of samples of ``sample_dims`` dims each through one
    model, in the serving dtype and batch of ``model_key``."""

    sample_dims = 0
    sample_name = "sample"

    def __init__(self, model_key: str, model: nn.Module, batch_axis: int, *,
                 batch: Optional[int], dtype: str,
                 device: Optional[Union[str, torch.device]]):
        self.model_key = model_key
        self.device = resolve_device(device)
        self.dtype = _DTYPES[resolve_serving_dtype(dtype, model_key)]
        self.batch = resolve_serving_batch(model_key, batch)
        self.batch_axis = batch_axis
        self.model = cast_for_serving(model.to(self.device).eval(),
                                      self.dtype)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One batch on the server's device: cast in, f32 logits out."""
        return self.model(x.to(self.device).to(self.dtype)).float()

    @torch.no_grad()
    def __call__(self, samples: Union[np.ndarray, torch.Tensor]
                 ) -> torch.Tensor:
        """Logits for ``samples`` (n, *sample), any n >= 1, as a float32
        tensor on the server's device with n along the batch axis."""
        if isinstance(samples, np.ndarray):
            samples = torch.from_numpy(samples)
        if samples.dim() != 1 + self.sample_dims or samples.shape[0] == 0:
            raise ValueError(
                f"a request is a non-empty array of {self.sample_name}s with "
                f"{1 + self.sample_dims} dims, got {tuple(samples.shape)}")
        outs = []
        for start in range(0, samples.shape[0], self.batch):
            chunk = samples[start:start + self.batch].to(self.device)
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (pad,) + tuple(chunk.shape[1:]))])
            out = self.forward(chunk)
            if pad:
                out = out.narrow(self.batch_axis, 0, self.batch - pad)
            outs.append(out)
        return torch.cat(outs, dim=self.batch_axis)


class CSIServer(_Server):
    """Answers ragged requests of CSI windows (n, length, channels) with
    one model.

    ``model`` is a port model for ``model_key`` (from
    ``runners.csi.build_model`` or with carried-over weights); the server
    moves it to ``device`` (the card unless told otherwise), casts it, and
    puts it in eval mode.
    """

    sample_dims = 2
    sample_name = "window"

    def __init__(self, model_key: str, model: nn.Module, *,
                 batch: Optional[int] = None, dtype: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        if model_key not in CSI_MODELS:
            raise KeyError(f"unknown model {model_key!r}; ported: "
                           f"{sorted(CSI_MODELS)}")
        super().__init__(model_key, model, CSI_MODELS[model_key].batch_axis,
                         batch=batch, dtype=dtype, device=device)


class VideoServer(_Server):
    """Answers ragged requests of video clips (n, T, H, W, 3), in the JAX
    cache layout, with one video model (MViT serves in bf16 at batch 2).

    ``model`` is a port model for ``model_key`` (from
    ``runners.video.build_video_model``, or loaded with
    ``load_video_pretrained``) built for the requests' clip size.
    """

    sample_dims = 4
    sample_name = "clip"

    def __init__(self, model_key: str, model: nn.Module, *,
                 batch: Optional[int] = None, dtype: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        video_spec(model_key)
        super().__init__(model_key, model, 0, batch=batch, dtype=dtype,
                         device=device)

