"""Fused attention softmax(q k^T / sqrt(D)) v and its backward: the port of
the JAX package's THAT-family Pallas kernels (``kernels/flash_attention.py::
flash_attention``, K1, and ``flash_attention_trainable``, K2).

``flash_attention`` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` and ``flash_attention_backward`` launches
``csrc/flash_attention_bwd.cu`` on CUDA tensors; each takes its plain
version (``flash_attention_reference``,
``flash_attention_backward_reference``) only for CPU tensors.
``flash_attention_trainable`` is the differentiable attention of training:
its forward is K1 and its backward K2. Each source's header says what
bounds the kernel on an H100 and what its design does about it.

K1's source holds two kernels, chosen by q's dtype: bfloat16 (serving)
launches the tensor-core kernel of ``csrc/tc_attention.cuh`` (keys streamed
in tiles, so any Nk; D <= 128), float32 (training) the CUDA-core kernel
that stages one (batch, head)'s K and V in shared memory. K2's float32
instantiation (training) is two kernels of the tensor-core backward body
``csrc/tc_attention_bwd.cuh`` (a query pass, then dK/dV; D <= 128), its
bfloat16 one the CUDA-core kernel of ``csrc/flash_attention_bwd.cu``. A
CUDA call that its instantiation refuses raises; it never runs the other
one.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import build, count_launch

NAME = "flash_attention"
BWD_NAME = "flash_attention_backward"
BWD_SOURCE = "flash_attention_bwd"    # csrc/flash_attention_bwd.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1     # cudaErrorInvalidValue
# a block's shared memory on an H100, the launchers' limit (kMaxSharedBytes)
MAX_SHARED_BYTES = 232448
_WARPS = 8                        # kWarps of the CUDA-core kernels
# the tensor-core kernels' head-dim limit (csrc/tc_attention.cuh:
# 16 * kMaxSteps): K1 in bf16, K2 in f32
TC_MAX_HEAD_DIM = 128


def forward_fits(nk: int, d: int, dtype: torch.dtype) -> bool:
    """Whether K1's launcher takes Nk keys of head dim D in ``dtype``, term
    for term its limit (``csrc/flash_attention.cu``). bfloat16: the
    tensor-core kernel streams the keys, so any Nk, and takes D <= 128.
    float32: ``smem_bytes(nk, d)``, f32 K at the odd row stride D | 1, V,
    one weight row and one query row per warp, within the block's shared
    memory."""
    if dtype == torch.bfloat16:
        return d <= TC_MAX_HEAD_DIM
    need = 4 * (nk * (d | 1) + nk * d + _WARPS * nk + _WARPS * d)
    return need <= MAX_SHARED_BYTES


def backward_fits(nq: int, nk: int, d: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether K2's launcher takes Nq queries and Nk keys of head dim D in
    ``dtype``: its entry check ``smem_bytes(nq, nk, d)``
    (``csrc/flash_attention_bwd.cu``), term for term, f32 Q and dO, K and
    V at the odd row stride D | 1, three per-query rows and two rows of
    max(Nq, Nk) per warp, within the block's shared memory; float32 also
    D <= 128 (the tensor-core body's spans)."""
    if dtype == torch.float32 and d > TC_MAX_HEAD_DIM:
        return False
    stride = d | 1
    need = 4 * (2 * nq * stride + 2 * nk * stride + 3 * nq
                + 2 * _WARPS * max(nq, nk))
    return need <= MAX_SHARED_BYTES


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


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, step for step the TPU
    kernel's arithmetic (``_bwd_kernel_plain``): the weights recomputed from
    f32 logits times 1/sqrt(D) and kept in f32; dw = dO V^T and
    dl = w (dw - rowsum(dw w)) in f32; dQ = dl K scale and
    dK = dl^T Q scale from the f32 dl; dV = bf(w)^T dO with the weights
    rounded to dO's dtype; all three returned in the inputs' dtypes.

    q, do: (B, Nq, H, D); k, v: (B, Nk, H, D). ``do`` is first cast to q's
    dtype, as the TPU kernel casts it.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = unnorm / unnorm.sum(dim=-1, keepdim=True)
    dw = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", w.to(do.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _library(source: str, tensors: int) -> ctypes.CDLL:
    """The built library of ``csrc/<source>.cu`` with its launcher's C
    signature set: ``tensors`` pointers, then B, Nq, Nk, H, D and the
    dtype code as c_int, then the stream (pointers and the stream as
    c_void_p)."""
    lib = build.load(source)
    fn = getattr(lib, f"mmcsi_{source}")
    fn.argtypes = [ctypes.c_void_p] * tensors + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           what: str = NAME) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what} takes (B, N, H, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{what} shapes disagree: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError(f"{what} needs at least one key")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what} inputs lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")


def _launch(source: str, name: str, tensors, q: torch.Tensor, nk: int,
            refused: str) -> None:
    """Launch ``csrc/<source>.cu`` on q's device and current stream, raise
    on a refused launch (ValueError saying what the launcher ``refused``)
    and count a launched one under ``name``."""
    b, nq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(_library(source, len(tensors)), f"mmcsi_{source}")(
            *(t.data_ptr() for t in tensors), b, nq, nk, h, d,
            _DTYPE_CODES[q.dtype], stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        # the sizes are positive here, so the launcher refused what its
        # instantiation cannot take
        raise ValueError(f"{name} at Nq={nq}, Nk={nk}, D={d}, {q.dtype}: "
                         f"{refused}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(name)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v per (batch, head).

    q: (B, Nq, H, D); k, v: (B, Nk, H, D), float32 or bfloat16. Returns
    (B, Nq, H, D) in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel of their dtype (``forward_fits`` says which
    shapes it takes) or raise.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    out = torch.empty_like(q)
    if out.numel():
        _launch(NAME, NAME, (q, k, v, out), q, k.shape[1],
                f"the bfloat16 kernel takes D <= {TC_MAX_HEAD_DIM}"
                if q.dtype == torch.bfloat16 else
                "K and V of one (batch, head) do not fit in a block's "
                "shared memory (227 KB)")
    return out


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of softmax(q k^T / sqrt(D)) v for the output gradient
    ``do``, recomputing the weights (nothing saved by the forward).

    q, do: (B, Nq, H, D); k, v: (B, Nk, H, D), float32 or bfloat16. ``do``
    may have any layout and float dtype: it is made contiguous in q's
    dtype. Gradients come back in the inputs' dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise (float32: the
    query pass, then the dK/dV pass, into an f32 work buffer of the rows'
    LSE and delta).
    """
    _check(q, k, v, BWD_NAME)
    if do.shape != q.shape or do.device != q.device:
        raise ValueError(f"{BWD_NAME}: do {tuple(do.shape)} on {do.device} "
                         f"does not match q {tuple(q.shape)} on {q.device}")
    do = do.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, do)
    b, nq, h, _ = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    work = torch.empty((2, b * h, nq) if q.dtype == torch.float32 else (0,),
                       dtype=torch.float32, device=q.device)
    if dq.numel():
        _launch(BWD_SOURCE, BWD_NAME, (q, k, v, do, dq, dk, dv, work), q,
                k.shape[1], "Q, dO, K and V of one (batch, head) do not fit "
                "in a block's shared memory (227 KB), or float32 at D > "
                f"{TC_MAX_HEAD_DIM}")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward; saves q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward(*ctx.saved_tensors, do)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Differentiable ``flash_attention``: the forward launches K1 and the
    backward K2 (their plain versions for CPU tensors). Takes and returns
    what ``flash_attention`` does."""
    return _FlashAttention.apply(q, k, v)
