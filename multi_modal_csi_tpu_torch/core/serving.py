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
- int8 serving (``quant``, ``core/quantize.py``), in the order of JAX's
  ``core/export.py:71-86``: after the cast, the calibration samples
  (``calib``, split into serving batches, fed as given: float32, not cast)
  run through the model while it records, and the hooked weights are
  quantized in place, their scales float32. ``w8a8`` needs ``calib``;
  ``w8`` without it discovers the hooked layers with one zero sample. A
  quantized server holds int8 weights or raises: it never serves float
  when int8 is asked.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..runners.csi import CSI_MODELS
from ..runners.video import video_spec
from ..train.loop import cast_for_serving
from .config import (CSI_CHANNELS, Config, resolve_quant,
                     resolve_serving_batch, resolve_serving_dtype)
from .device import resolve_device
from .quantize import quantize_for_serving

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Samples = Union[np.ndarray, torch.Tensor]
__all__ = ["CSIServer", "VideoServer", "cast_for_serving"]


class _Server:
    """Ragged requests of samples of ``sample_dims`` dims each through one
    model, in the serving dtype and batch of ``model_key``."""

    sample_dims = 0
    sample_name = "sample"

    def __init__(self, model_key: str, model: nn.Module, batch_axis: int, *,
                 batch: Optional[int], dtype: str,
                 device: Optional[Union[str, torch.device]],
                 quant: Optional[str], calib: Optional[Samples],
                 calib_stat: str, sample_shape: Tuple[int, ...]):
        self.model_key = model_key
        self.device = resolve_device(device)
        self.dtype = _DTYPES[resolve_serving_dtype(dtype, model_key)]
        self.batch = resolve_serving_batch(model_key, batch)
        self.batch_axis = batch_axis
        self.model = cast_for_serving(model.to(self.device).eval(),
                                      self.dtype)
        self.quant = resolve_quant(quant, model_key)
        if self.quant is not None:
            self._quantize(calib, calib_stat, sample_shape)

    def _quantize(self, calib: Optional[Samples], stat: str,
                  sample_shape: Tuple[int, ...]) -> None:
        if calib is None:
            if self.quant != "w8":
                raise ValueError(
                    f"{self.quant} serving of {self.model_key} needs calib "
                    f"samples to calibrate the activation scales")
            calib = torch.zeros((1, *sample_shape))
        calib = torch.as_tensor(calib)
        batches = (calib[i:i + self.batch].to(self.device)
                   for i in range(0, calib.shape[0], self.batch))
        quantize_for_serving(self.model, batches, mode=self.quant, stat=stat)
        if not any(p.dtype == torch.int8 for p in self.model.parameters()):
            raise ValueError(f"{self.quant} serving of {self.model_key}: no "
                             f"weight of the model was quantized")

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
    puts it in eval mode. ``quant`` is None, "none", "auto" (the model's
    ``QUANT_DEFAULTS``), "w8" or "w8a8"; ``calib`` an array of windows
    (n, length, channels); ``calib_stat`` "amax" or "p999". ``w8`` without
    ``calib`` discovers with one zero window of the full width (3000, 270).
    """

    sample_dims = 2
    sample_name = "window"

    def __init__(self, model_key: str, model: nn.Module, *,
                 batch: Optional[int] = None, dtype: str = "auto",
                 device: Optional[Union[str, torch.device]] = None,
                 quant: Optional[str] = None, calib: Optional[Samples] = None,
                 calib_stat: str = "amax"):
        if model_key not in CSI_MODELS:
            raise KeyError(f"unknown model {model_key!r}; ported: "
                           f"{sorted(CSI_MODELS)}")
        super().__init__(model_key, model, CSI_MODELS[model_key].batch_axis,
                         batch=batch, dtype=dtype, device=device,
                         quant=quant, calib=calib, calib_stat=calib_stat,
                         sample_shape=(Config().data.length, CSI_CHANNELS))


class VideoServer(_Server):
    """Answers ragged requests of video clips (n, T, H, W, 3), in the JAX
    cache layout, with one video model, in its serving dtype and batch
    (``core/config.py``: ResNet bf16 at 64, S3D bf16 at 32, MViT bf16 at
    2, Swin f32 at 2).

    ``model`` is a port model for ``model_key`` (from
    ``runners.video.build_video_model``, or loaded with
    ``load_video_pretrained``) built for the requests' clip size.
    ``quant``, ``calib`` (clips) and ``calib_stat`` as for ``CSIServer``;
    ``--quant auto`` is w8a8 for ResNet and S3D and leaves MViT and Swin
    unquantized. ``w8`` without ``calib`` discovers with one zero clip of
    the model's clip size. ResNet's and S3D's convs and Linears are
    hooked; MViT's and Swin's Linears are, their patchify convs are not.
    """

    sample_dims = 4
    sample_name = "clip"

    def __init__(self, model_key: str, model: nn.Module, *,
                 batch: Optional[int] = None, dtype: str = "auto",
                 device: Optional[Union[str, torch.device]] = None,
                 quant: Optional[str] = None, calib: Optional[Samples] = None,
                 calib_stat: str = "amax"):
        video_spec(model_key)
        super().__init__(model_key, model, 0, batch=batch, dtype=dtype,
                         device=device, quant=quant, calib=calib,
                         calib_stat=calib_stat,
                         sample_shape=(*model.backbone.clip, 3))

