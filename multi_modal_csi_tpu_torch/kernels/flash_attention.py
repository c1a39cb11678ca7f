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

K1's source launches one of the two bodies of ``csrc/tc_attention.cuh``,
chosen by q's dtype: bfloat16 (serving) the bf16 tensor-core kernel,
float32 (training) the f32 body, its products as 3xTF32 on the tensor
cores; both stream the keys in tiles, so any Nk, and take D <= 128. Their
launches count apart, ``flash_attention`` (bf16) and
``flash_attention_f32``. K2 in either dtype is two kernels of the
tensor-core backward body ``csrc/tc_attention_bwd.cuh``: a query pass
(dQ, and each row's LSE and delta into an f32 work buffer), then the
dK/dV pass, which reads them; float32 forms every product as 3xTF32,
bfloat16 on bf16 ``mma.sync``. Both stream their tiles, so any Nq and Nk,
and take D <= 128. Their launches count apart too,
``flash_attention_backward`` (f32) and ``flash_attention_backward_bf16``.
A CUDA call that the launcher refuses raises; nothing else runs in its
place. K1 is the custom op ``mmcsi::flash_attention`` (the package's
docstring says why); K2, which only training runs, is not.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import build, check_launch, count_launch, define_op, uses_op

NAME = "flash_attention"
F32_NAME = "flash_attention_f32"    # K1's f32 launches, counted apart
BWD_NAME = "flash_attention_backward"
BWD_BF16_NAME = "flash_attention_backward_bf16"  # K2's bf16 launches
BWD_SOURCE = "flash_attention_bwd"    # csrc/flash_attention_bwd.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CUDA_ERROR_INVALID_VALUE = 1     # cudaErrorInvalidValue
# the tensor-core kernels' head-dim limit (csrc/tc_attention.cuh:
# 16 * kMaxSteps): K1 and K2 in both dtypes
TC_MAX_HEAD_DIM = 128


def forward_fits(nk: int, d: int, dtype: torch.dtype) -> bool:
    """Whether K1's launcher takes Nk keys of head dim D in ``dtype``, its
    limit (``csrc/flash_attention.cu``): both tensor-core bodies stream
    the keys, so any Nk, and take D <= 128."""
    return d <= TC_MAX_HEAD_DIM


def backward_fits(nq: int, nk: int, d: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether K2's launcher takes Nq queries and Nk keys of head dim D in
    ``dtype`` (``csrc/flash_attention_bwd.cu``): D <= 128 at any Nq and Nk
    in both dtypes, as its tensor-core kernels stream their tiles (each
    pass's shared memory depends on the span alone)."""
    return d <= TC_MAX_HEAD_DIM


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


def flash_attention_backward_sums(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version's f32 dQ, dK and dV before their cast to the
    inputs' dtypes (``flash_attention_backward_reference`` says how they
    are formed); ``do`` is in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = unnorm / unnorm.sum(dim=-1, keepdim=True)
    dw = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", w.to(do.dtype).float(), dof)
    return dq, dk, dv


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, step for step the TPU kernel's
    arithmetic (``_bwd_kernel_plain``): the weights recomputed from f32
    logits times 1/sqrt(D) and kept in f32; dw = dO V^T and
    dl = w (dw - rowsum(dw w)) in f32; dQ = dl K scale and
    dK = dl^T Q scale from the f32 dl; dV = bf(w)^T dO with the weights
    rounded to dO's dtype; all three returned in the inputs' dtypes.

    q, do: (B, Nq, H, D); k, v: (B, Nk, H, D). ``do`` is first cast to q's
    dtype, as the TPU kernel casts it.
    """
    dq, dk, dv = flash_attention_backward_sums(q, k, v, do.to(q.dtype))
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
    if uses_op(q.device):
        return torch.ops.mmcsi.flash_attention(q, k, v)
    return flash_attention_reference(q, k, v)


def _flash_attention_launch(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """K1's launch on q's device (the op's CUDA implementation)."""
    out = torch.empty_like(q)
    if out.numel():
        _launch(NAME, NAME if q.dtype == torch.bfloat16 else F32_NAME,
                (q, k, v, out), q, k.shape[1],
                f"the tensor-core kernels take D <= {TC_MAX_HEAD_DIM}")
    return out


define_op("flash_attention(Tensor q, Tensor k, Tensor v) -> Tensor",
          _flash_attention_launch,
          lambda q, k, v: flash_attention_reference(q, k, v).contiguous(),
          lambda q, k, v: torch.empty_like(q))


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of softmax(q k^T / sqrt(D)) v for the output gradient
    ``do``, recomputing the weights (nothing saved by the forward).

    q, do: (B, Nq, H, D); k, v: (B, Nk, H, D), float32 or bfloat16. ``do``
    may have any layout and float dtype: it is made contiguous in q's
    dtype. Gradients come back in the inputs' dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernels of their dtype (the
    query pass, then the dK/dV pass, with an f32 work buffer of the rows'
    LSE and delta between them; ``backward_fits`` says which shapes they
    take) or raise.
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
    work = torch.empty((2, b * h, nq), dtype=torch.float32, device=q.device)
    if dq.numel():
        name = BWD_NAME if q.dtype == torch.float32 else BWD_BF16_NAME
        _launch(BWD_SOURCE, name, (q, k, v, do, dq, dk, dv, work), q,
                k.shape[1],
                f"the tensor-core kernels take D <= {TC_MAX_HEAD_DIM}")
        check_launch(name, (dq, dk, dv))
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
