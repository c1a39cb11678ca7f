"""The matrix products of int8 serving, C = A B^T: the port of the JAX
package's int8 probe kernels (``tools/exp_pallas_int8.py::main``, bodies
``kernel_s8`` and ``kernel_bf16``, P1), whose products its int8 serving runs
(``core/quantize.py::dense_forward`` and ``conv_forward`` there).

- ``int8_matmul(a, b)``: int8 A (M, K) and B (N, K) to int32 (M, N), exact
  (the w8a8 product);
- ``bf16_matmul_f32(a, b)``: bfloat16 A and B to float32 with f32
  accumulation (the w8 product on the dequantised weight, and the
  attention projections').

Both take an optional leading group dimension, A (G, M, K) and B (G, N, K)
to (G, M, N): a grouped convolution is one launch. On CUDA tensors they
launch the hand-written kernel ``csrc/int8_matmul.cu`` or raise; CPU
tensors take the plain versions (``int8_matmul_reference``,
``bf16_matmul_f32_reference``). Launches are counted under
``int8_matmul_s8`` and ``int8_matmul_bf16``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, count_launch

SOURCE = "int8_matmul"                # csrc/int8_matmul.cu
S8_NAME = "int8_matmul_s8"
BF16_NAME = "int8_matmul_bf16"
# |sum| <= 128^2 K must fit in int32 (int8 includes -128)
MAX_K_S8 = (2 ** 31 - 1) // 128 ** 2
_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
_NAMES = {torch.int8: S8_NAME, torch.bfloat16: BF16_NAME}


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_matmul``: the exact int32 product A B^T. On
    the CPU in int32 (PyTorch multiplies int32 matrices there); on the card,
    which has no int32 product, in float64, exact for |sum| < 2^53."""
    if a.device.type == "cpu":
        return a.int() @ b.int().transpose(-1, -2)
    return (a.double() @ b.double().transpose(-1, -2)).to(torch.int32)


def bf16_matmul_f32_reference(a: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bf16_matmul_f32``: the float32 product of the
    bfloat16 values (exact products, f32 sums; not rounded to bf16 as
    ``F.linear`` on bf16 would)."""
    return a.float() @ b.float().transpose(-1, -2)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mmcsi_int8_matmul.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_longlong] * 4
        + [ctypes.c_void_p])
    lib.mmcsi_int8_matmul.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
           what: str) -> None:
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"{what} takes {dtype} operands, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"{what} takes (M, K) and (N, K), or (G, M, K) and "
                         f"(G, N, K), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[-1] != b.shape[-1] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"{what} shapes disagree: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.shape[-1] == 0:
        raise ValueError(f"{what} needs K >= 1")
    if a.device != b.device:
        raise ValueError(f"{what} operands lie on different devices: "
                         f"{a.device}, {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {a.device}")
    if dtype == torch.int8 and a.shape[-1] > MAX_K_S8:
        raise ValueError(f"{what}: K = {a.shape[-1]} above {MAX_K_S8} could "
                         f"overflow the int32 sum")


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch ``csrc/int8_matmul.cu`` on a's device and current stream,
    raise on a refused launch and count a launched one."""
    g, m, k = a.shape
    n = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().mmcsi_int8_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[a.dtype], g, m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"{_NAMES[a.dtype]} kernel launch failed with "
                           f"CUDA error {err} at G={g}, M={m}, N={n}, K={k}")
    count_launch(_NAMES[a.dtype])


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
            what: str, reference) -> torch.Tensor:
    _check(a, b, dtype, what)
    if a.device.type == "cpu":
        return reference(a, b)
    grouped = a.dim() == 3
    a3 = (a if grouped else a[None]).contiguous()
    b3 = (b if grouped else b[None]).contiguous()
    out = torch.empty((a3.shape[0], a3.shape[1], b3.shape[1]),
                      dtype=_OUT_DTYPES[dtype], device=a.device)
    if out.numel():
        _launch(a3, b3, out)
    return out if grouped else out[0]


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A B^T for int8 A (M, K) and B (N, K) as int32 (M, N), exact; or per
    group for A (G, M, K) and B (G, N, K). K is at most ``MAX_K_S8``. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _matmul(a, b, torch.int8, S8_NAME, int8_matmul_reference)


def bf16_matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A B^T for bfloat16 A (M, K) and B (N, K) as float32 (M, N), with f32
    accumulation; or per group for (G, M, K) and (G, N, K). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    return _matmul(a, b, torch.bfloat16, BF16_NAME,
                   bf16_matmul_f32_reference)
