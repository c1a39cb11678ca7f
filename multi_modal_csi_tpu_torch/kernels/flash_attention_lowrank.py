"""Attention with a low-rank additive bias, softmax(q k^T / sqrt(D) + r s) v:
the port of the JAX package's MViT Pallas kernel
(``kernels/flash_attention.py::flash_attention_lowrank_bias``, K3).

``flash_attention_lowrank_bias`` launches the hand-written CUDA kernel
``csrc/flash_attention_lowrank.cu`` on CUDA tensors and takes its plain
version (``flash_attention_lowrank_bias_reference``) only for CPU tensors.
The source's header says what bounds the kernel on an H100 and what its
design does about it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from . import build, count_launch

NAME = "flash_attention_lowrank_bias"
SOURCE = "flash_attention_lowrank"    # csrc/flash_attention_lowrank.cu
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1     # cudaErrorInvalidValue

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_lowrank_bias_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        r: Optional[torch.Tensor] = None, s: Optional[torch.Tensor] = None,
        return_lse: bool = False) -> Out:
    """Plain PyTorch version, step for step the TPU kernel's arithmetic:
    f32 logits times 1/sqrt(D) plus the f32 bias r @ s, f32 max/exp/sum,
    weights rounded to v's dtype, f32 P.V, output in q's dtype; the row
    log-sum-exp max + log(sum) in f32.

    q: (B, H, Nq, D); k, v: (B, H, Nk, D); r: (B, H, Nq, M); s: (M, Nk).
    Returns (B, H, Nq, D), and with ``return_lse`` also (B, H, Nq).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if r is not None:
        logits = logits + torch.einsum("bhqm,mk->bhqk", r.float(), s.float())
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    w = (unnorm / denom).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom)).squeeze(-1)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library of ``csrc/flash_attention_lowrank.cu`` with its
    launcher's C signature set: q, k, v, r, s, out, lse pointers, then
    B*H, Nq, Nk, D, M and the dtype code as c_int, then the stream."""
    lib = build.load(SOURCE)
    fn = getattr(lib, f"mmcsi_{SOURCE}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, r, s) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{NAME} takes (B, H, N, D) q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, nq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{NAME} shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    nk = k.shape[2]
    if nk == 0:
        raise ValueError(f"{NAME} needs at least one key")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME} takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (r is None) != (s is None):
        raise ValueError(f"{NAME} takes both bias factors r and s or neither")
    tensors = [q, k, v]
    if r is not None:
        if (r.dim() != 4 or r.shape[:3] != (b, h, nq) or s.dim() != 2
                or s.shape != (r.shape[3], nk)):
            raise ValueError(f"{NAME} bias factors must be r (B, H, Nq, M) "
                             f"and s (M, Nk) for q {tuple(q.shape)} and "
                             f"{nk} keys, got r {tuple(r.shape)}, "
                             f"s {tuple(s.shape)}")
        if r.dtype != torch.float32 or s.dtype != torch.float32:
            raise TypeError(f"{NAME} takes float32 bias factors, got "
                            f"{r.dtype}, {s.dtype}")
        tensors += [r, s]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{NAME} inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{NAME} takes contiguous tensors")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME} runs on cuda or cpu, not {q.device}")


def flash_attention_lowrank_bias(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        r: Optional[torch.Tensor] = None, s: Optional[torch.Tensor] = None,
        return_lse: bool = False) -> Out:
    """softmax(q k^T / sqrt(D) + r @ s) v per (batch, head).

    q: (B, H, Nq, D); k, v: (B, H, Nk, D), float32 or bfloat16; r
    (B, H, Nq, M) and s (M, Nk), float32, or both None for no bias. Returns
    (B, H, Nq, D) in q's dtype and, with ``return_lse``, the row
    log-sum-exp (B, H, Nq) in float32. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise (the kernel takes D <= 128).
    """
    _check(q, k, v, r, s)
    if q.device.type == "cpu":
        return flash_attention_lowrank_bias_reference(q, k, v, r, s,
                                                      return_lse)
    b, h, nq, d = q.shape
    nk, m = k.shape[2], 0 if r is None else r.shape[3]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = getattr(_library(), f"mmcsi_{SOURCE}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if r is None else r.data_ptr(),
                None if s is None else s.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b * h, nq, nk, d, m,
                _DTYPE_CODES[q.dtype], stream)
        if err == _CUDA_ERROR_INVALID_VALUE:
            raise ValueError(f"{NAME}: the kernel refused B*H={b * h}, "
                             f"Nq={nq}, Nk={nk}, D={d}, M={m}; it takes "
                             f"D <= {MAX_HEAD_DIM}")
        if err != 0:
            raise RuntimeError(f"{NAME} kernel launch failed with CUDA error "
                               f"{err}")
        count_launch(NAME)
    return (out, lse) if return_lse else out
