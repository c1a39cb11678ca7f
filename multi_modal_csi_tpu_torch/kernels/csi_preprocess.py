"""CSI amplitude and phase from the real and imaginary parts: the port of
the JAX package's preprocessing kernel (``kernels/csi_preprocess.py::
amplitude_phase``, K5).

``amplitude_phase`` launches the hand-written CUDA kernel
``csrc/csi_preprocess.cu`` on CUDA tensors, computing the amplitude and the
phase in one pass, and takes the plain version
``amplitude_phase_reference`` only for CPU tensors. The source's header
says what bounds the kernel on an H100 and what its design does about it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build, check_launch, count_launch

NAME = "csi_amplitude_phase"
SOURCE = "csi_preprocess"              # csrc/csi_preprocess.cu


def amplitude_phase_reference(re: torch.Tensor, im: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: sqrt(re * re + im * im) with each product,
    the sum and the root rounded to f32 (the TPU kernel's arithmetic), and
    atan2(im, re).

    The root is taken in f64 and rounded to f32, which gives the correctly
    rounded f32 root: PyTorch's vectorised f32 sqrt on the CPU is not
    (1 ulp off on 0.7% of normal inputs), while numpy's, JAX's and the
    kernel's (``__fsqrt_rn``) are."""
    return (torch.sqrt((re * re + im * im).double()).float(),
            torch.atan2(im, re))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.mmcsi_csi_preprocess
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.dim() < 2 or re.shape != im.shape:
        raise ValueError(f"{NAME} takes re and im of one (..., T, F) shape, "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"{NAME} takes float32 re and im, got {re.dtype} "
                        f"and {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"{NAME} inputs lie on different devices: "
                         f"{re.device}, {im.device}")
    if re.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME} runs on cuda or cpu, not {re.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{NAME} takes contiguous tensors")


def amplitude_phase(re: torch.Tensor, im: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """|CSI| and its phase from the real and imaginary parts.

    re, im: (..., T, F) float32, contiguous, on one device. Returns
    (amp, phase) of the same shape. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    _check(re, im)
    if re.device.type == "cpu":
        return amplitude_phase_reference(re, im)
    amp, phase = torch.empty_like(re), torch.empty_like(re)
    if re.numel():
        with torch.cuda.device(re.device):
            stream = torch.cuda.current_stream(re.device).cuda_stream
            err = _library().mmcsi_csi_preprocess(
                re.data_ptr(), im.data_ptr(), amp.data_ptr(),
                phase.data_ptr(), re.numel(), stream)
        if err != 0:
            raise RuntimeError(f"{NAME} kernel launch failed with CUDA "
                               f"error {err}")
        count_launch(NAME)
        check_launch(NAME, (amp, phase))
    return amp, phase
