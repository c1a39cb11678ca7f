"""Device resolution for the port's entry points, and the precision of
its f32 cuDNN calls on the card."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    an entry point never carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device


@contextlib.contextmanager
def cudnn_f32() -> Iterator[None]:
    """Run cuDNN's float32 convolutions and LSTMs in full f32 while the
    block runs: its TF32 flag off (PyTorch's default is on, which keeps
    TF32's 10-bit mantissa in both), restored after. The port's f32
    convolutions and its f32 ``torch.lstm`` run inside it, and so does the
    backward of its training steps; bf16 is unaffected, as the flag only
    concerns f32. Scoped, so that importing the port changes no global
    setting, and around each call, because an exported program records no
    backend flag."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous
