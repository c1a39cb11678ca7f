"""Attention with a low-rank additive bias, softmax(q k^T / sqrt(D) + r s) v,
and its flash backward: the port of the JAX package's MViT Pallas kernels
(``kernels/flash_attention.py::flash_attention_lowrank_bias``, K3, and
``flash_attention_lowrank_bias_trainable``, K4).

``flash_attention_lowrank_bias`` launches the hand-written CUDA kernel
``csrc/flash_attention_lowrank.cu`` on CUDA tensors and takes its plain
version (``flash_attention_lowrank_bias_reference``) only for CPU tensors.
``flash_attention_lowrank_bias_backward`` launches the two kernels of
``csrc/flash_attention_lowrank_bwd.cu`` (dQ/dR, then dK/dV/dS; each
wrapper, ``lowrank_backward_dq`` and ``lowrank_backward_dkv``, counts its
own launches) and takes ``flash_attention_lowrank_bias_backward_reference``
only for CPU tensors. Both kernels of both dtypes run on the tensor cores
and take D <= 128 and M <= 128. In float32 (MViT training's default)
every product, the bias included, is 3xTF32: dQ/dR on the query pass with
the bias of ``csrc/tc_attention_bwd.cuh`` (queries as the rows; the
forward's LSE and delta read once a row; dQ and dR written once, in
place), dK/dV/dS on its key-major body (f32 partials per split of the
query range). In bfloat16 both run on that header's bf16 bodies, the same
decompositions with bf16 products for the head dim (dQ/dR: S, dP and dQ,
dl split into bf16 hi + lo; dK/dV/dS: S^T, dP^T, dV and dK, w and dl
split likewise) and the bias, dR and dS as 3xTF32. A CUDA call that its
instantiation refuses raises; it never runs another kernel.
``flash_attention_lowrank_bias_trainable`` is the differentiable
attention of MViT's training: K3 forward, K4 backward. Each
source's header says what bounds its kernels on an H100 and what their
design does about it.

K3's source holds two kernels, chosen by q's dtype, both bodies of
``csrc/tc_attention.cuh`` on the tensor cores with one online-softmax pass
over the keys: bfloat16 (serving) runs the bf16 body (bf16 products, the
bias as 3xTF32), float32 (training's forward) the f32 body (QK^T and P.V
as 3xTF32, so at f32 precision; the bias as this module's plain version
forms it, one f32 FMA chain per logit; the weights never rounded). Both
take D <= 128 and M <= 128 (``lowrank_fits``). A CUDA call that its
instantiation refuses raises; it never runs the other one. K3 is the
custom op ``mmcsi::flash_attention_lowrank_bias`` (the package's
docstring says why); K4, which only training runs, is not.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from . import build, check_launch, count_launch, define_op, uses_op

NAME = "flash_attention_lowrank_bias"
SOURCE = "flash_attention_lowrank"    # csrc/flash_attention_lowrank.cu
DQ_NAME = "flash_attention_lowrank_bias_backward_dq"
DKV_NAME = "flash_attention_lowrank_bias_backward_dkv"
BWD_SOURCE = "flash_attention_lowrank_bwd"  # its csrc/ .cu
MAX_HEAD_DIM = 128
MAX_BIAS_RANK = 128       # factor columns of both kernels (kMaxRank)
QUERY_TILE = 32           # query rows per tile of the dK/dV/dS bodies
WAVE_SHARE = 0.9          # the dK/dV/dS grid's least share of busy SMs
                          # over its waves
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


def lowrank_fits(d: int, m: int) -> bool:
    """Whether the kernels of both dtypes take a head dim ``d`` and ``m``
    bias factor columns (0: no bias)."""
    return 0 < d <= MAX_HEAD_DIM and 0 <= m <= MAX_BIAS_RANK


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
    CUDA tensors launch the kernel of their dtype or raise. Both kernels
    run on the tensor cores in one online-softmax pass and take D <= 128
    and M <= 128: bfloat16 with bf16 products and the bias as 3xTF32,
    float32 with QK^T and P.V as 3xTF32 (f32 precision) and the bias as
    the plain version's f32 GEMM forms it.
    """
    _check(q, k, v, r, s)
    if not uses_op(q.device):
        return flash_attention_lowrank_bias_reference(q, k, v, r, s,
                                                      return_lse)
    out, lse = torch.ops.mmcsi.flash_attention_lowrank_bias(q, k, v, r, s)
    return (out, lse) if return_lse else out


def _lowrank_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    r: Optional[torch.Tensor], s: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's launch on q's device (the op's CUDA implementation): the
    output and the row LSE."""
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
                             f"D <= {MAX_HEAD_DIM} and M <= {MAX_BIAS_RANK}")
        if err != 0:
            raise RuntimeError(f"{NAME} kernel launch failed with CUDA error "
                               f"{err}")
        count_launch(NAME)
    return out, lse


def _lowrank_plain(q, k, v, r, s):
    out, lse = flash_attention_lowrank_bias_reference(q, k, v, r, s, True)
    return out.contiguous(), lse.contiguous()


define_op("flash_attention_lowrank_bias(Tensor q, Tensor k, Tensor v, "
          "Tensor? r, Tensor? s) -> (Tensor, Tensor)", _lowrank_launch,
          _lowrank_plain,
          lambda q, k, v, r, s: (torch.empty_like(q), q.new_empty(
              q.shape[:3], dtype=torch.float32)))


# ---------------------------------------------------------------------- #
# K4: the flash backward
# ---------------------------------------------------------------------- #

def _tile_wdl(q, k, v, r, s, do, lse, delta):
    """The TPU kernels' shared step (``_bwd_tile_wdl``) over all of Nq and
    Nk at once: f32 logits times 1/sqrt(D) plus the f32 bias r @ s,
    w = exp(logits - lse) kept in f32, dw = dO V^T and
    dl = w (dw - delta) in f32. Returns the f32 q and dO, w, dl, scale."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, dof = q.float(), do.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * scale
    if r is not None:
        logits = logits + torch.einsum("bhqm,mk->bhqk", r.float(), s.float())
    w = torch.exp(logits - lse[..., None])
    dw = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    dl = w * (dw - delta[..., None])
    return qf, dof, w, dl, scale


def lowrank_backward_dq_reference(q, k, v, r, s, do, lse, delta):
    """Plain version of the dQ/dR kernel (``_tiled_bwd_dq_kernel``):
    dQ = (dl K) scale in q's dtype, dR = dl S^T in f32 (None without a
    bias). ``do`` is in q's dtype; lse and delta are (B, H, Nq) f32."""
    _, _, _, dl, scale = _tile_wdl(q, k, v, r, s, do, lse, delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", dl, k.float()) * scale
    dr = None if r is None else torch.einsum("bhqk,mk->bhqm", dl, s.float())
    return dq.to(q.dtype), dr


def lowrank_backward_dkv_reference(q, k, v, r, s, do, lse, delta):
    """Plain version of the dK/dV/dS kernel (``_tiled_bwd_dkv_kernel``):
    dV = w^T dO with the unrounded f32 weights, dK = (dl^T Q) scale, both
    in the inputs' dtypes, and dS = R^T dl summed over (B, H) in f32 (None
    without a bias)."""
    qf, dof, w, dl, scale = _tile_wdl(q, k, v, r, s, do, lse, delta)
    dk = torch.einsum("bhqk,bhqd->bhkd", dl, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", w, dof)
    ds = None if r is None else torch.einsum("bhqm,bhqk->mk", r.float(), dl)
    return dk.to(k.dtype), dv.to(v.dtype), ds


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in f32, from the forward's output as it was
    returned and dO before its cast (the TPU backward's ``:569-570``)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_lowrank_bias_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        r: Optional[torch.Tensor], s: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """Plain version of K4, step for step the TPU backward's arithmetic:
    delta from ``out`` and dO in f32, dO cast to q's dtype, then the two
    kernels' plain versions. Returns (dQ, dK, dV, dR, dS)."""
    delta = _delta(out, do)
    do = do.to(q.dtype)
    dq, dr = lowrank_backward_dq_reference(q, k, v, r, s, do, lse, delta)
    dk, dv, ds = lowrank_backward_dkv_reference(q, k, v, r, s, do, lse, delta)
    return dq, dk, dv, dr, ds


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built library of ``csrc/flash_attention_lowrank_bwd.cu`` with
    its two launchers' C signatures set: q, k, v, r, s, dO, lse, delta and
    the output pointers (dQ, dR; or the dK, dV, dS partials), then B*H, Nq,
    Nk, D, M (and the splits) and the dtype code as c_int, then the
    stream; and the dK/dV/dS kernel's keys per block (D, M, dtype code)."""
    lib = build.load(BWD_SOURCE)
    dq = getattr(lib, f"mmcsi_{BWD_SOURCE}_dq")
    dq.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    dkv = getattr(lib, f"mmcsi_{BWD_SOURCE}_dkv")
    dkv.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    keys = getattr(lib, f"mmcsi_{BWD_SOURCE}_dkv_keys")
    keys.argtypes = [ctypes.c_int] * 3
    dq.restype = dkv.restype = keys.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bwd_launch(kernel: str, name: str, tensors, ints, q) -> None:
    """Call the launcher ``kernel`` on q's device and current stream, raise
    on a refused launch and count a launched one under ``name``."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(_bwd_library(), f"mmcsi_{BWD_SOURCE}_{kernel}")(
            *(_ptr(t) for t in tensors), *ints, _DTYPE_CODES[q.dtype], stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: the kernel refused the sizes (B*H, Nq, "
                         f"Nk, D, M...) {ints}; it takes D <= {MAX_HEAD_DIM}"
                         f" and M <= {MAX_BIAS_RANK}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    count_launch(name)


def dkv_keys(d: int, m: int, dtype: torch.dtype) -> int:
    """Keys per block of the dK/dV/dS kernel of ``dtype`` at head dim
    ``d`` and ``m`` bias factor columns, as the C entry reports it (128,
    or 64 where two warps share a key strip; 0 for sizes it refuses)."""
    return _bwd_library().mmcsi_flash_attention_lowrank_bwd_dkv_keys(
        d, m, _DTYPE_CODES[dtype])


def dkv_splits(key_blocks: int, nq: int, sms: int) -> int:
    """How many blocks share the query tiles of one (b h, key block) in
    the dK/dV/dS kernel (either dtype: one block of the tensor-core body
    an SM at MViT's widths), given ``key_blocks`` blocks over B*H and the
    keys, at most one a query tile of QUERY_TILE rows: the fewest whose
    blocks keep at least WAVE_SHARE of the ``sms`` SMs busy over their
    waves, else the best share."""
    best, best_share = 1, 0.0
    for splits in range(1, -(-nq // QUERY_TILE) + 1):
        blocks = key_blocks * splits
        share = blocks / (-(-blocks // sms) * sms)
        if share >= WAVE_SHARE:
            return splits
        if share > best_share:
            best, best_share = splits, share
    return best


def lowrank_backward_dq(q, k, v, r, s, do, lse, delta):
    """(dQ, dR) of K4's first kernel: dQ in q's dtype, dR f32 (None
    without a bias). ``do`` contiguous in q's dtype; lse and delta
    (B, H, Nq) f32. CPU tensors take the plain version; the kernel of
    either dtype (the tensor-core query pass with the bias) refuses
    M > 128 (ValueError)."""
    if q.device.type == "cpu":
        return lowrank_backward_dq_reference(q, k, v, r, s, do, lse, delta)
    b, h, nq, d = q.shape
    nk, m = k.shape[2], 0 if r is None else r.shape[3]
    dq = torch.empty_like(q)
    dr = None if r is None else torch.empty_like(r)
    _bwd_launch("dq", DQ_NAME, (q, k, v, r, s, do, lse, delta, dq, dr),
                (b * h, nq, nk, d, m), q)
    check_launch(DQ_NAME, (dq, dr))
    return dq, dr


def lowrank_backward_dkv(q, k, v, r, s, do, lse, delta):
    """(dK, dV, dS) of K4's second kernel: dK and dV in the inputs'
    dtypes, dS (M, Nk) f32 summed over (B, H) (None without a bias). The
    kernel writes f32 partials per split of the query range, summed here
    over the splits and (B, H) in a fixed order. CPU tensors take the
    plain version; the kernel of either dtype refuses M > 128
    (ValueError)."""
    if q.device.type == "cpu":
        return lowrank_backward_dkv_reference(q, k, v, r, s, do, lse, delta)
    b, h, nq, d = q.shape
    nk, m = k.shape[2], 0 if r is None else r.shape[3]
    keys = dkv_keys(d, m, q.dtype)
    # no keys: sizes the kernel refuses, which its launch reports
    splits = dkv_splits(b * h * -(-nk // keys), nq,
                        torch.cuda.get_device_properties(
                            q.device).multi_processor_count) if keys else 1
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.empty((splits, b, h, nk, d), **f32)
    dv = torch.empty((splits, b, h, nk, d), **f32)
    ds = None if r is None else torch.empty((splits, b * h, m, nk), **f32)
    _bwd_launch("dkv", DKV_NAME, (q, k, v, r, s, do, lse, delta, dk, dv, ds),
                (b * h, nq, nk, d, m, splits), q)
    check_launch(DKV_NAME, (dk, dv, ds))
    dk, dv = dk.sum(dim=0).to(k.dtype), dv.sum(dim=0).to(v.dtype)
    return dk, dv, None if ds is None else ds.sum(dim=(0, 1))


def _check_backward(q, k, v, r, s, out, lse, do) -> None:
    _check(q, k, v, r, s)
    b, h, nq, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{NAME} backward takes a head dim of at most "
                         f"{MAX_HEAD_DIM}, got {d}")
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"{NAME} backward: out {tuple(out.shape)} "
                         f"{out.dtype} and do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, nq) or lse.dtype != torch.float32:
        raise ValueError(f"{NAME} backward takes the forward's (B, H, Nq) "
                         f"float32 LSE, got {tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (out, lse, do)):
        raise ValueError(f"{NAME} backward inputs lie on different devices")
    if not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError(f"{NAME} backward takes a contiguous out and LSE")


def flash_attention_lowrank_bias_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        r: Optional[torch.Tensor], s: Optional[torch.Tensor],
        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor):
    """(dQ, dK, dV, dR, dS) of ``flash_attention_lowrank_bias`` for the
    output gradient ``do``, from the forward's inputs, its output ``out``
    and its row LSE. delta = rowsum(dO out) is taken in f32 here, and dO
    (any layout and float dtype) is made contiguous in q's dtype. dQ, dK
    and dV come back in the inputs' dtypes, dR (B, H, Nq, M) and dS
    (M, Nk) in f32, or None without a bias. CPU tensors take the plain
    version; CUDA tensors launch the two kernels or raise (D <= 128 and
    M <= 128)."""
    _check_backward(q, k, v, r, s, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_lowrank_bias_backward_reference(
            q, k, v, r, s, out, lse, do)
    delta = _delta(out, do)
    do = do.to(q.dtype).contiguous()
    dq, dr = lowrank_backward_dq(q, k, v, r, s, do, lse, delta)
    dk, dv, ds = lowrank_backward_dkv(q, k, v, r, s, do, lse, delta)
    return dq, dk, dv, dr, ds


class _LowrankAttention(torch.autograd.Function):
    """K3 forward, K4 backward; saves the inputs, the output and the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, r, s):
        out, lse = flash_attention_lowrank_bias(q, k, v, r, s,
                                                return_lse=True)
        ctx.save_for_backward(q, k, v, r, s, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        return flash_attention_lowrank_bias_backward(*ctx.saved_tensors, do)


def flash_attention_lowrank_bias_trainable(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        r: Optional[torch.Tensor] = None,
        s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``flash_attention_lowrank_bias``: the forward
    launches K3 and the backward K4 (their plain versions for CPU tensors).
    Takes and returns what ``flash_attention_lowrank_bias`` does; the
    gradients of r and s exist only when a bias is given."""
    return _LowrankAttention.apply(q, k, v, r, s)
