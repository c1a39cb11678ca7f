"""Fused inference attention softmax(q k^T / sqrt(D)) v: the port of the JAX
package's THAT-family Pallas kernel (``kernels/flash_attention.py::
flash_attention``, K1).

``flash_attention`` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and takes the plain version,
``flash_attention_reference``, only for CPU tensors. The source's header
says what bounds the kernel on an H100 and what its design does about it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, count_launch

NAME = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1     # cudaErrorInvalidValue


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, step for step the TPU kernel's arithmetic:
    f32 logits times 1/sqrt(D), f32 max/exp/sum, weights rounded to v's
    dtype, f32 P.V, output in q's dtype.

    q: (B, Nq, H, D); k, v: (B, Nk, H, D). Returns (B, Nq, H, D).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - m)
    w = (unnorm / unnorm.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())
    return out.to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with the launcher's C signature set
    (pointers and the stream as c_void_p, sizes as c_int)."""
    lib = build.load(NAME)
    fn = lib.mmcsi_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, N, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per (batch, head).

    q: (B, Nq, H, D); k, v: (B, Nk, H, D), float32 or bfloat16. Returns
    (B, Nq, H, D) in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().mmcsi_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nq, nk, h, d, _DTYPE_CODES[q.dtype], stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        # the sizes are positive here, so the launcher refused the shared
        # memory that K and V of one (batch, head) need
        raise ValueError(f"flash_attention: K and V of one (batch, head) at "
                         f"Nk={nk}, D={d} do not fit in a block's shared "
                         f"memory (227 KB)")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    count_launch(NAME)
    return out
