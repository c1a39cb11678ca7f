"""The products of int8 serving: the port of the JAX package's int8 probe
kernels (``tools/exp_pallas_int8.py::main``, bodies ``kernel_s8`` and
``kernel_bf16``, P1), whose products its int8 serving runs
(``core/quantize.py::dense_forward`` and ``conv_forward`` there), with the
activation quantization before them and the rescale after them fused in, as
XLA fuses them around its dot.

The fused path of a quantized layer, two launches:

- ``quantize_columns(x, input_scale, k, stride, dilation, pads, groups)``:
  the prologue. Channels-last x (B, L, C) to the product's A operand (B
  L_out, G, Kp): the columns of a 1-D convolution in the weight's (channel,
  tap) order (a Linear is k = 1), quantized to int8 with the calibrated
  scale (w8a8) or cast to bf16 (w8), zeros at the padded positions and in
  the row pad up to Kp (``padded_width``: a multiple of 16 bytes);
- ``quantize_columns3d(x, input_scale, kernel, stride, pads)``: the
  prologue of a 3-D convolution (a 2-D one is its T = 1, kt = 1 case).
  Channels-last x (B, T, H, W, C) to (B To Ho Wo, Kp) columns in the
  weight's (channel, kt, kh, kw) order, quantized or cast as above, zeros
  at the symmetric padding and in the row pad;
- ``quantized_product(a, b, weight_scale, input_scale, bias, out_dtype,
  k)``: A (M, Ka) or (M, G, Ka), int8 or bf16, times the int8 weight B (N,
  Kb) or (G, N/G, Kb) padded once (``pad_columns``), then
  ``float(sum) * (weight_scale * input_scale) + bias`` cast to out_dtype,
  (M, N). An int8 A takes the int8 x int8 -> int32 product (w8a8), a bf16
  A the bf16 product on the weight widened to bf16 (w8);
- ``quantized_conv3d(a, b, weight_scale, input_scale, bias, out_dtype,
  kernel, stride, pads)``: the implicit conv, the same product and
  epilogue for a 2-D or 3-D conv of C >= ``IMPLICIT_MIN_CHANNELS``
  channels, whose A the kernel reads from the conv window itself. a is the
  activation's codes (B, T, H, W, Cp), ``quantize_columns`` at k = 1 of
  its (B, T H W, C) view (or a bf16 activation as it is), and b the
  weight's tap-major copy (``tap_major``: (N, kt kh kw Cp) with Cp = a's
  width); the output (B, To, Ho, Wo, N).

The bare products, as the TPU kernels compute them:

- ``int8_matmul(a, b)``: int8 A (M, K) and B (N, K) to int32 (M, N), exact;
- ``bf16_matmul_f32(a, b)``: bfloat16 A and B to float32 with f32
  accumulation.

Both take an optional leading group dimension, A (G, M, K) and B (G, N, K)
to (G, M, N).

On CUDA tensors every entry point launches the hand-written kernels of
``csrc/int8_matmul.cu`` or raises; CPU tensors take the plain versions
(``*_reference``), which are the eager chain the kernels replace. Launches
are counted under ``int8_matmul_s8`` and ``int8_matmul_bf16`` (the product
kernel, bare or fused, by its A operand), ``int8_conv3d`` (the implicit
conv, either A), ``int8_quantize_columns`` (the prologue) and
``int8_quantize_columns3d`` (the 3-D prologue).

The fused path's launches are the custom ops ``mmcsi::quantize_columns``,
``mmcsi::quantize_columns3d``, ``mmcsi::quantized_product`` and
``mmcsi::quantized_conv3d`` (the package's docstring says why); the bare
products, which no serving forward reaches, are not.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build, count_launch, define_op, uses_op

SOURCE = "int8_matmul"                # csrc/int8_matmul.cu
S8_NAME = "int8_matmul_s8"
BF16_NAME = "int8_matmul_bf16"
COLUMNS_NAME = "int8_quantize_columns"
COLUMNS3D_NAME = "int8_quantize_columns3d"
CONV3D_NAME = "int8_conv3d"
# the implicit conv's fewest channels: a narrower conv (the stems' C = 3)
# keeps the 3-D prologue's columns, whose window covers W and C together
IMPLICIT_MIN_CHANNELS = 16
# elements of tap-major columns that the implicit conv's plain version
# gathers at a time (whole samples a chunk, at least one): on the card its
# int32 product runs in float64
REFERENCE_ELEMENTS = 2 ** 28
# |sum| <= 128^2 K must fit in int32 (int8 includes -128)
MAX_K_S8 = (2 ** 31 - 1) // 128 ** 2
ROW_ALIGN = 16                        # bytes: the kernel's copy width
TILE_M, TILE_N = 128, 96              # the kernel's output tile
SMS = 132                             # streaming multiprocessors (H100)
MIN_SPLIT_BYTES = 512                 # bytes of A's K a split takes at least
_MODES = {(torch.int8, torch.int8): 0, (torch.bfloat16, torch.bfloat16): 1,
          (torch.bfloat16, torch.int8): 2}
_KINDS = {torch.float32: 1, torch.bfloat16: 2}
_NAMES = {torch.int8: S8_NAME, torch.bfloat16: BF16_NAME}


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #

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


def quantize_activation(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Per-tensor symmetric int8 with a fixed (calibrated) scale:
    clamp(round(x / scale), -127, 127), rounding half to even."""
    q = torch.round(x.float() / scale)
    return q.clamp(-127, 127).to(torch.int8)


def padded_width(k: int, dtype: torch.dtype) -> int:
    """K rounded up to a whole number of ROW_ALIGN bytes of ``dtype``."""
    per = ROW_ALIGN // dtype.itemsize
    return -(-k // per) * per


def pad_columns(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``padded_width``,
    contiguous (a weight is padded once, when it is quantized or loaded)."""
    k = t.shape[-1]
    return F.pad(t, (0, padded_width(k, t.dtype) - k)).contiguous()


def tap_major(weight: torch.Tensor, cp: int) -> torch.Tensor:
    """A 2-D or 3-D conv's int8 weight (N, C, [kt,] kh, kw) as the
    implicit conv's B: (N, kt kh kw Cp) in (tap, channel) order, each tap's
    channels zero-padded to ``cp``, the rows zero-padded to a multiple of
    16 bytes (``pad_columns``), contiguous."""
    c = weight.shape[1]
    w = F.pad(weight.movedim(1, -1), (0, cp - c))
    return pad_columns(w.reshape(w.shape[0], -1))


def tap_major_view(taps: torch.Tensor, shape) -> torch.Tensor:
    """The weight of ``shape`` (N, C, [kt,] kh, kw) as a view of its
    tap-major copy ``taps`` (``tap_major``), which it equals. Cp is C
    padded for int8 codes (w8a8) where the copy is that wide, else for
    bf16 codes (w8): where the two Cp differ, the w8 copy is the narrower
    with two taps or more, and holds the same bytes with one."""
    n, c, *kernel = shape
    taps_n = math.prod(kernel)
    cp = padded_width(c, torch.int8)
    if taps_n * cp > taps.shape[1]:
        cp = padded_width(c, torch.bfloat16)
    w = taps[:, :taps_n * cp].view(n, *kernel, cp)[..., :c]
    return w.movedim(-1, 1)


def quantize_columns_reference(x: torch.Tensor,
                               input_scale: Optional[torch.Tensor],
                               k: int = 1, stride: int = 1,
                               dilation: int = 1,
                               pads: Tuple[int, int] = (0, 0),
                               groups: int = 1) -> torch.Tensor:
    """Plain version of ``quantize_columns``: the activation quantized
    (``quantize_activation``) or cast to bf16, the padded input unfolded
    into (B L_out, G, C/G k) columns in the weight's (channel, tap) order,
    zero-padded to ``padded_width``."""
    xo = (x.to(torch.bfloat16) if input_scale is None
          else quantize_activation(x, input_scale))
    b, _, c = x.shape
    kg = c // groups * k
    if k == 1 and stride == 1 and pads == (0, 0):
        a = xo.reshape(-1, groups, kg)
    else:
        span = (k - 1) * dilation + 1
        cols = F.pad(xo, (0, 0, *pads)).unfold(1, span, stride)
        cols = cols[..., ::dilation]                   # (B, L_out, C, k)
        a = cols.reshape(b * cols.shape[1], groups, kg)
    return F.pad(a, (0, padded_width(kg, xo.dtype) - kg))


def conv3d_output(dims: Tuple[int, int, int], kernel: Tuple[int, int, int],
                  stride: Tuple[int, int, int],
                  pads: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(To, Ho, Wo) of a 3-D convolution of (T, H, W) with symmetric
    padding."""
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(dims, kernel, stride, pads))


def quantize_columns3d_reference(x: torch.Tensor,
                                 input_scale: Optional[torch.Tensor],
                                 kernel: Tuple[int, int, int],
                                 stride: Tuple[int, int, int],
                                 pads: Tuple[int, int, int]) -> torch.Tensor:
    """Plain version of ``quantize_columns3d``: the activation quantized
    (``quantize_activation``) or cast to bf16, zero-padded on T, H and W
    (``F.pad``), unfolded on the three axes in that order into (B To Ho
    Wo, C kt kh kw) columns in the weight's (channel, kt, kh, kw) order,
    zero-padded to ``padded_width``."""
    xo = (x.to(torch.bfloat16) if input_scale is None
          else quantize_activation(x, input_scale))
    pt, ph, pw = pads
    cols = F.pad(xo, (0, 0, pw, pw, ph, ph, pt, pt))
    for axis, (k, s) in enumerate(zip(kernel, stride)):
        cols = cols.unfold(1 + axis, k, s)      # (B, To, Ho, Wo, C, kt, kh, kw)
    kk = x.shape[-1] * math.prod(kernel)
    a = cols.reshape(-1, kk)
    return F.pad(a, (0, padded_width(kk, xo.dtype) - kk))


def quantized_product_reference(a: torch.Tensor, b: torch.Tensor,
                                weight_scale: torch.Tensor,
                                input_scale: Optional[torch.Tensor] = None,
                                bias: Optional[torch.Tensor] = None,
                                out_dtype: torch.dtype = torch.float32, *,
                                k: int) -> torch.Tensor:
    """Plain version of ``quantized_product``, the eager chain: over the
    first ``k`` columns, the int32 product (int8 A) times weight_scale *
    input_scale, or the f32 product of A and the weight as bf16 times
    weight_scale; plus the bias; cast to ``out_dtype``."""
    grouped = b.dim() == 3
    g = b.shape[0] if grouped else 1
    ng = b.shape[-2]
    if grouped:
        a3 = (a if a.dim() == 3 else a[:, None]).transpose(0, 1)[..., :k]
        bb = b[..., :k]
        scale = weight_scale.reshape(g, 1, ng)
    else:
        a3 = (a[:, 0] if a.dim() == 3 else a)[..., :k]
        bb = b[..., :k]
        scale = weight_scale
    if a.dtype == torch.int8:
        y = int8_matmul_reference(a3, bb).float() * (scale * input_scale)
    else:
        y = bf16_matmul_f32_reference(a3, bb.to(torch.bfloat16)) * scale
    if grouped:
        y = y.transpose(0, 1).reshape(-1, g * ng)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def conv3d_columns(a: torch.Tensor, kernel: Tuple[int, int, int],
                   stride: Tuple[int, int, int],
                   pads: Tuple[int, int, int]) -> torch.Tensor:
    """What the implicit conv reads: the codes a (B, T, H, W, Cp),
    zero-padded on T, H and W, unfolded into (B To Ho Wo, kt kh kw Cp)
    columns in (tap, channel) order."""
    pt, ph, pw = pads
    cols = F.pad(a, (0, 0, pw, pw, ph, ph, pt, pt))
    for axis, (k, s) in enumerate(zip(kernel, stride)):
        cols = cols.unfold(1 + axis, k, s)  # (B, To, Ho, Wo, Cp, kt, kh, kw)
    cols = cols.permute(0, 1, 2, 3, 5, 6, 7, 4)
    return cols.reshape(-1, math.prod(kernel) * a.shape[-1])


def quantized_conv3d_reference(a: torch.Tensor, b: torch.Tensor,
                               weight_scale: torch.Tensor,
                               input_scale: Optional[torch.Tensor] = None,
                               bias: Optional[torch.Tensor] = None,
                               out_dtype: torch.dtype = torch.float32,
                               kernel: Tuple[int, int, int] = (1, 1, 1),
                               stride: Tuple[int, int, int] = (1, 1, 1),
                               pads: Tuple[int, int, int] = (0, 0, 0)
                               ) -> torch.Tensor:
    """Plain version of ``quantized_conv3d``: the tap-major columns of
    the codes (``conv3d_columns``) times the tap-major weight with
    ``quantized_product_reference``'s epilogue, a chunk of whole samples
    of at most REFERENCE_ELEMENTS columns at a time; (B, To, Ho, Wo, N)."""
    kernel, stride, pads = tuple(kernel), tuple(stride), tuple(pads)
    dims = conv3d_output(tuple(a.shape[1:4]), kernel, stride, pads)
    k = math.prod(kernel) * a.shape[-1]
    step = max(1, REFERENCE_ELEMENTS // (math.prod(dims) * k))
    outs = [quantized_product_reference(
        conv3d_columns(a[i:i + step], kernel, stride, pads), b, weight_scale,
        input_scale, bias, out_dtype, k=k)
        for i in range(0, a.shape[0], step)]
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.reshape(a.shape[0], *dims, b.shape[0])


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mmcsi_int8_matmul.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 11
        + [ctypes.c_void_p])
    lib.mmcsi_int8_matmul.restype = ctypes.c_int
    lib.mmcsi_int8_columns.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] + [ctypes.c_void_p])
    lib.mmcsi_int8_columns.restype = ctypes.c_int
    lib.mmcsi_int8_columns3d.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)] * 2
        + [ctypes.POINTER(ctypes.c_int)] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_longlong] + [ctypes.c_void_p])
    lib.mmcsi_int8_columns3d.restype = ctypes.c_int
    lib.mmcsi_int8_conv3d.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.POINTER(ctypes.c_int)] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p])
    lib.mmcsi_int8_conv3d.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def split_count(groups: int, m: int, n: int, k_bytes: int) -> int:
    """Splits of K for a product whose output tiles do not fill the card
    twice over: as many as bring it to two blocks per SM, each split at
    least MIN_SPLIT_BYTES of A's K (the launcher takes no more splits than
    its K has ring stages)."""
    tiles = groups * -(-m // TILE_M) * -(-n // TILE_N)
    if tiles >= SMS:
        return 1
    return max(1, min(-(-2 * SMS // tiles), k_bytes // MIN_SPLIT_BYTES))


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
            m: int, n: int, groups: int, k: int, lda: int, a_group: int,
            ldb: int, b_group: int, ldc: int, c_group: int,
            weight_scale: Optional[torch.Tensor] = None,
            input_scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None) -> None:
    """Launch the product kernel on a's device and current stream (strides
    in elements of each operand), raise on a refused launch and count a
    launched one under its A operand's name."""
    ea, eb = a.element_size(), b.element_size()
    k_bytes = max(a.shape[-1], b.shape[-1]) * ea
    splits = split_count(groups, m, n, k_bytes)
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    work = (torch.empty((splits * groups, m, n), dtype=acc, device=a.device)
            if splits > 1 else None)
    kind = 0 if weight_scale is None else _KINDS[out.dtype]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().mmcsi_int8_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(work),
            _ptr(weight_scale), _ptr(input_scale), _ptr(bias),
            int(bias is not None and bias.dtype == torch.bfloat16),
            _MODES[(a.dtype, b.dtype)], kind, groups, splits, m, n, k_bytes,
            a.shape[-1] * ea, lda * ea, a_group * ea, b.shape[-1] * eb,
            ldb * eb, b_group * eb, ldc, c_group, stream)
    if err != 0:
        raise RuntimeError(f"{_NAMES[a.dtype]} kernel launch failed with "
                           f"CUDA error {err} at G={groups}, M={m}, N={n}, "
                           f"K={k}")
    count_launch(_NAMES[a.dtype])


def _check_device(what: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} operands lie on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {kind}")
    return kind


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
    _check_device(what, a, b)
    if dtype == torch.int8 and a.shape[-1] > MAX_K_S8:
        raise ValueError(f"{what}: K = {a.shape[-1]} above {MAX_K_S8} could "
                         f"overflow the int32 sum")


def _aligned(t: torch.Tensor) -> bool:
    """Rows and base that the kernel's 4-byte copies take. The base is read
    from the storage offset (an allocation starts at least 16-byte
    aligned), so that a traced program decides as eager code does; the
    launcher refuses a pointer that no copy divides."""
    size = t.element_size()
    return (t.shape[-1] * size) % 4 == 0 and (t.storage_offset() * size) % 4 == 0


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
            what: str, reference) -> torch.Tensor:
    _check(a, b, dtype, what)
    if a.device.type == "cpu":
        return reference(a, b)
    grouped = a.dim() == 3
    a3 = (a if grouped else a[None]).contiguous()
    b3 = (b if grouped else b[None]).contiguous()
    g, m, k = a3.shape
    n = b3.shape[1]
    out = torch.empty((g, m, n), dtype=torch.int32 if dtype == torch.int8
                      else torch.float32, device=a.device)
    if out.numel():
        if not (_aligned(a3) and _aligned(b3)):
            # rows of K = 270 int8 are 270 bytes: staged at a padded stride
            a3, b3 = pad_columns(a3), pad_columns(b3)
        _launch(a3, b3, out, m=m, n=n, groups=g, k=k, lda=a3.shape[-1],
                a_group=m * a3.shape[-1], ldb=b3.shape[-1],
                b_group=n * b3.shape[-1], ldc=n, c_group=m * n)
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


def direct_operand(x: torch.Tensor) -> Optional[torch.Tensor]:
    """A bf16 activation (..., C) as the (M, C) rows that the product
    reads as they are (the w8 operand): a view of contiguous columns whose
    strides, length and base the kernel's 4-byte copies divide;
    None when it needs the prologue's cast (an f32 activation) or gather
    (rows that no view lays out so)."""
    if x.dtype != torch.bfloat16 or x.dim() < 1 or x.stride(-1) != 1:
        return None
    try:
        rows = x.view(-1, x.shape[-1])
    except RuntimeError:
        return None
    if (rows.stride(0) * 2) % 4 or not _aligned(rows):
        return None
    return rows


def quantize_columns(x: torch.Tensor, input_scale: Optional[torch.Tensor],
                     k: int = 1, stride: int = 1, dilation: int = 1,
                     pads: Tuple[int, int] = (0, 0),
                     groups: int = 1) -> torch.Tensor:
    """The product's A operand from channels-last x (B, L, C), f32 or
    bf16, at any strides: (B L_out, G, Kp) columns of C/G k values in the weight's
    (channel, tap) order, int8 ``clamp(round(x / input_scale), -127,
    127)`` with a (0-d, f32) scale, else bf16 x; zeros at the padded
    positions and up to Kp = ``padded_width``. CPU tensors take the plain
    version; CUDA tensors launch the prologue kernel or raise."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_columns takes f32 or bf16 (B, L, C), got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, length, c = x.shape
    if min(k, stride, dilation, groups) < 1 or c % groups or min(pads) < 0:
        raise ValueError(f"quantize_columns: k={k}, stride={stride}, "
                         f"dilation={dilation}, pads={pads}, groups={groups} "
                         f"for {c} channels")
    lout = _columns_rows(x, k, stride, dilation, pads)
    if lout < 1 or b == 0:
        raise ValueError(f"quantize_columns: no output rows for "
                         f"{tuple(x.shape)}")
    tensors = (x,) if input_scale is None else (x, input_scale)
    _check_device(COLUMNS_NAME, *tensors)
    if not uses_op(x.device):
        return quantize_columns_reference(x, input_scale, k, stride,
                                          dilation, pads, groups)
    return torch.ops.mmcsi.quantize_columns(x, input_scale, k, stride,
                                            dilation, list(pads), groups)


def _columns_rows(x: torch.Tensor, k: int, stride: int, dilation: int,
                  pads) -> int:
    """L_out: windows of span (k - 1) dilation + 1 over the padded
    length."""
    return (x.shape[1] + sum(pads) - (k - 1) * dilation - 1) // stride + 1


def _columns_launch(x: torch.Tensor, input_scale: Optional[torch.Tensor],
                    k: int, stride: int, dilation: int, pads: List[int],
                    groups: int) -> torch.Tensor:
    """The prologue's launch on x's device (the op's CUDA
    implementation)."""
    b, length, c = x.shape
    lout = _columns_rows(x, k, stride, dilation, pads)
    out_dtype = torch.bfloat16 if input_scale is None else torch.int8
    kp = padded_width(c // groups * k, out_dtype)
    strides = (ctypes.c_longlong * 3)(*x.stride())
    scale = None if input_scale is None else input_scale.float().reshape(())
    out = torch.empty((b * lout, groups, kp), dtype=out_dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().mmcsi_int8_columns(
            x.data_ptr(), out.data_ptr(), _ptr(scale), strides,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            b, length, c, lout, k, stride, dilation, pads[0], groups, kp,
            stream)
    if err != 0:
        raise RuntimeError(f"{COLUMNS_NAME} kernel launch failed with CUDA "
                           f"error {err} at x {tuple(x.shape)}, k={k}")
    count_launch(COLUMNS_NAME)
    return out


def _columns_fake(x, input_scale, k, stride, dilation, pads, groups):
    out_dtype = torch.bfloat16 if input_scale is None else torch.int8
    lout = _columns_rows(x, k, stride, dilation, pads)
    return x.new_empty((x.shape[0] * lout, groups,
                        padded_width(x.shape[2] // groups * k, out_dtype)),
                       dtype=out_dtype)


define_op("quantize_columns(Tensor x, Tensor? input_scale, int k, "
          "int stride, int dilation, int[] pads, int groups) -> Tensor",
          _columns_launch,
          lambda x, input_scale, k, stride, dilation, pads, groups:
          quantize_columns_reference(x, input_scale, k, stride, dilation,
                                     tuple(pads), groups),
          _columns_fake)


def quantize_columns3d(x: torch.Tensor, input_scale: Optional[torch.Tensor],
                       kernel: Tuple[int, int, int],
                       stride: Tuple[int, int, int] = (1, 1, 1),
                       pads: Tuple[int, int, int] = (0, 0, 0)
                       ) -> torch.Tensor:
    """The product's A operand for a 3-D convolution of channels-last x
    (B, T, H, W, C), f32 or bf16, at any strides: (B To Ho Wo, Kp) columns
    of C kt kh kw values in the weight's (channel, kt, kh, kw) order, int8
    ``clamp(round(x / input_scale), -127, 127)`` with a (0-d, f32) scale,
    else bf16 x; zeros at the symmetric padding ``pads`` and up to Kp =
    ``padded_width``. A 2-D convolution is the T = 1, kt = 1 case. CPU
    tensors take the plain version; CUDA tensors launch the 3-D prologue
    kernel or raise."""
    if x.dim() != 5 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_columns3d takes f32 or bf16 (B, T, H, W, "
                         f"C), got {x.dtype} {tuple(x.shape)}")
    kernel, stride, pads = tuple(kernel), tuple(stride), tuple(pads)
    if (len(kernel) != 3 or len(stride) != 3 or len(pads) != 3
            or min(kernel + stride) < 1 or min(pads) < 0):
        raise ValueError(f"quantize_columns3d: kernel={kernel}, "
                         f"stride={stride}, pads={pads}")
    b, c = x.shape[0], x.shape[-1]
    dims = conv3d_output(tuple(x.shape[1:4]), kernel, stride, pads)
    if min(dims) < 1 or b == 0 or c == 0:
        raise ValueError(f"quantize_columns3d: no output rows for "
                         f"{tuple(x.shape)} at kernel {kernel}")
    tensors = (x,) if input_scale is None else (x, input_scale)
    _check_device(COLUMNS3D_NAME, *tensors)
    if not uses_op(x.device):
        return quantize_columns3d_reference(x, input_scale, kernel, stride,
                                            pads)
    return torch.ops.mmcsi.quantize_columns3d(x, input_scale, list(kernel),
                                              list(stride), list(pads))


def _columns3d_launch(x: torch.Tensor, input_scale: Optional[torch.Tensor],
                      kernel: List[int], stride: List[int],
                      pads: List[int]) -> torch.Tensor:
    """The 3-D prologue's launch on x's device (the op's CUDA
    implementation)."""
    b, c = x.shape[0], x.shape[-1]
    dims = conv3d_output(tuple(x.shape[1:4]), kernel, stride, pads)
    out_dtype = torch.bfloat16 if input_scale is None else torch.int8
    kp = padded_width(c * math.prod(kernel), out_dtype)
    shape = (ctypes.c_longlong * 5)(*x.shape)
    strides = (ctypes.c_longlong * 5)(*x.stride())
    args = [(ctypes.c_int * 3)(*v) for v in (kernel, stride, pads, dims)]
    scale = None if input_scale is None else input_scale.float().reshape(())
    out = torch.empty((b * math.prod(dims), kp), dtype=out_dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().mmcsi_int8_columns3d(
            x.data_ptr(), out.data_ptr(), _ptr(scale), shape, strides, *args,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            kp, stream)
    if err != 0:
        raise RuntimeError(f"{COLUMNS3D_NAME} kernel launch failed with CUDA "
                           f"error {err} at x {tuple(x.shape)}, kernel "
                           f"{kernel}, stride {stride}")
    count_launch(COLUMNS3D_NAME)
    return out


def _columns3d_fake(x, input_scale, kernel, stride, pads):
    out_dtype = torch.bfloat16 if input_scale is None else torch.int8
    dims = conv3d_output(tuple(x.shape[1:4]), kernel, stride, pads)
    return x.new_empty((x.shape[0] * math.prod(dims),
                        padded_width(x.shape[-1] * math.prod(kernel),
                                     out_dtype)), dtype=out_dtype)


define_op("quantize_columns3d(Tensor x, Tensor? input_scale, int[] kernel, "
          "int[] stride, int[] pads) -> Tensor", _columns3d_launch,
          lambda x, input_scale, kernel, stride, pads:
          quantize_columns3d_reference(x, input_scale, tuple(kernel),
                                       tuple(stride), tuple(pads)),
          _columns3d_fake)


def quantized_product(a: torch.Tensor, b: torch.Tensor,
                      weight_scale: torch.Tensor,
                      input_scale: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32, *,
                      k: int) -> torch.Tensor:
    """A layer's product with its epilogue: A (M, Ka) or (M, G, Ka) from
    ``quantize_columns`` (int8, or bf16; a bf16 A may also be the
    activation itself) times the int8 weight B (N, Kb), or (G, N/G, Kb) for
    a grouped conv; columns past ``k`` (the true K) are zeros on both
    sides. Returns (M, N) ``float(sum) * s + bias`` as ``out_dtype`` (f32
    or bf16), s = weight_scale * input_scale for an int8 A (w8a8) and
    weight_scale for a bf16 A (w8), the product's sum int32 or f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    what = "quantized_product"
    if (a.dtype, b.dtype) not in ((torch.int8, torch.int8),
                                  (torch.bfloat16, torch.int8)):
        raise TypeError(f"{what} takes an int8 or bf16 A and an int8 B, got "
                        f"{a.dtype}, {b.dtype}")
    if (a.dtype == torch.int8) != (input_scale is not None):
        raise ValueError(f"{what}: an int8 A needs the input scale, and only "
                         f"it")
    if out_dtype not in _KINDS:
        raise TypeError(f"{what} writes f32 or bf16, not {out_dtype}")
    groups = b.shape[0] if b.dim() == 3 else 1
    ng = b.shape[-2]
    if (b.dim() not in (2, 3) or a.dim() not in (2, 3)
            or (a.dim() == 3 and a.shape[1] != groups)
            or (a.dim() == 2 and groups != 1)
            or not 1 <= k <= min(a.shape[-1], b.shape[-1])
            or weight_scale.shape != (groups * ng,)
            or (bias is not None and bias.shape != (groups * ng,))):
        raise ValueError(f"{what} shapes disagree: A {tuple(a.shape)}, B "
                         f"{tuple(b.shape)}, k={k}, scale "
                         f"{tuple(weight_scale.shape)}")
    if a.dtype == torch.int8 and k > MAX_K_S8:
        raise ValueError(f"{what}: K = {k} above {MAX_K_S8} could overflow "
                         f"the int32 sum")
    tensors = [a, b, weight_scale] + [t for t in (input_scale, bias)
                                      if t is not None]
    _check_device(what, *tensors)
    if not uses_op(a.device):
        return quantized_product_reference(a, b, weight_scale, input_scale,
                                           bias, out_dtype, k=k)
    return torch.ops.mmcsi.quantized_product(a, b, weight_scale, input_scale,
                                             bias, out_dtype, k)


def _product_launch(a: torch.Tensor, b: torch.Tensor,
                    weight_scale: torch.Tensor,
                    input_scale: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                    k: int) -> torch.Tensor:
    """P1's fused launch on a's device (the op's CUDA implementation): the
    s8 instantiation for an int8 A, the bf16 one for a bf16 A."""
    what = "quantized_product"
    groups = b.shape[0] if b.dim() == 3 else 1
    ng = b.shape[-2]
    m = a.shape[0]
    out = torch.empty((m, groups * ng), dtype=out_dtype, device=a.device)
    if m == 0:
        return out
    if a.stride(-1) != 1 or not b.is_contiguous():
        raise ValueError(f"{what} needs rows of contiguous columns and a "
                         f"contiguous B")
    if bias is not None and bias.dtype not in _KINDS:
        bias = bias.float()
    _launch(a, b, out, m=m, n=ng, groups=groups, k=k, lda=a.stride(0),
            a_group=a.stride(1) if a.dim() == 3 else 0, ldb=b.stride(-2),
            b_group=b.stride(0) if b.dim() == 3 else 0, ldc=groups * ng,
            c_group=ng, weight_scale=weight_scale.float().contiguous(),
            input_scale=(None if input_scale is None
                         else input_scale.float().reshape(())),
            bias=None if bias is None else bias.contiguous())
    return out


define_op("quantized_product(Tensor a, Tensor b, Tensor weight_scale, "
          "Tensor? input_scale, Tensor? bias, ScalarType out_dtype, int k) "
          "-> Tensor", _product_launch,
          lambda a, b, weight_scale, input_scale, bias, out_dtype, k:
          quantized_product_reference(a, b, weight_scale, input_scale, bias,
                                      out_dtype, k=k).contiguous(),
          lambda a, b, weight_scale, input_scale, bias, out_dtype, k:
          a.new_empty((a.shape[0], weight_scale.shape[0]), dtype=out_dtype))


def quantized_conv3d(a: torch.Tensor, b: torch.Tensor,
                     weight_scale: torch.Tensor,
                     input_scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: torch.dtype = torch.float32,
                     kernel: Tuple[int, int, int] = (1, 1, 1),
                     stride: Tuple[int, int, int] = (1, 1, 1),
                     pads: Tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """The implicit conv: a 3-D convolution (a 2-D one is its T = 1, kt = 1
    case) of the codes a (B, T, H, W, Cp) with symmetric zero ``pads``,
    Cp a multiple of 16 bytes of a's type and at least
    IMPLICIT_MIN_CHANNELS, against the int8 tap-major weight b (N, Kb),
    Kb = ``padded_width(kt kh kw Cp)`` (``tap_major``), with
    ``quantized_product``'s epilogue: (B, To, Ho, Wo, N) ``float(sum) * s +
    bias`` as ``out_dtype``, the sum int32 for an int8 a (w8a8, s =
    weight_scale * input_scale) and f32 for a bf16 a (w8, s =
    weight_scale). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    what = "quantized_conv3d"
    if a.dtype not in (torch.int8, torch.bfloat16) or b.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 or bf16 codes and an int8 "
                        f"weight, got {a.dtype}, {b.dtype}")
    if (a.dtype == torch.int8) != (input_scale is not None):
        raise ValueError(f"{what}: int8 codes need the input scale, and only "
                         f"they")
    if out_dtype not in _KINDS:
        raise TypeError(f"{what} writes f32 or bf16, not {out_dtype}")
    kernel, stride, pads = tuple(kernel), tuple(stride), tuple(pads)
    if (a.dim() != 5 or b.dim() != 2 or len(kernel) != 3 or len(stride) != 3
            or len(pads) != 3 or min(kernel + stride) < 1 or min(pads) < 0):
        raise ValueError(f"{what}: codes {tuple(a.shape)}, weight "
                         f"{tuple(b.shape)}, kernel={kernel}, "
                         f"stride={stride}, pads={pads}")
    cp = a.shape[-1]
    if cp < IMPLICIT_MIN_CHANNELS or (cp * a.element_size()) % ROW_ALIGN:
        raise ValueError(f"{what} takes rows of at least "
                         f"{IMPLICIT_MIN_CHANNELS} codes in a multiple of "
                         f"{ROW_ALIGN} bytes, got {cp} {a.dtype}")
    k = math.prod(kernel) * cp
    n = b.shape[0]
    if (b.shape[1] != padded_width(k, torch.int8)
            or weight_scale.shape != (n,)
            or (bias is not None and bias.shape != (n,))):
        raise ValueError(f"{what}: weight {tuple(b.shape)} is not the "
                         f"tap-major copy of {kernel} taps of {cp} codes, or "
                         f"scale {tuple(weight_scale.shape)} disagrees")
    if a.dtype == torch.int8 and k > MAX_K_S8:
        raise ValueError(f"{what}: K = {k} above {MAX_K_S8} could overflow "
                         f"the int32 sum")
    dims = conv3d_output(tuple(a.shape[1:4]), kernel, stride, pads)
    if min(dims) < 1 or a.shape[0] == 0:
        raise ValueError(f"{what}: no output rows for {tuple(a.shape)} at "
                         f"kernel {kernel}")
    tensors = [a, b, weight_scale] + [t for t in (input_scale, bias)
                                      if t is not None]
    _check_device(what, *tensors)
    if not uses_op(a.device):
        return quantized_conv3d_reference(a, b, weight_scale, input_scale,
                                          bias, out_dtype, kernel, stride,
                                          pads)
    return torch.ops.mmcsi.quantized_conv3d(
        a, b, weight_scale, input_scale, bias, out_dtype, list(kernel),
        list(stride), list(pads))


def _conv3d_launch(a: torch.Tensor, b: torch.Tensor,
                   weight_scale: torch.Tensor,
                   input_scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                   kernel: List[int], stride: List[int],
                   pads: List[int]) -> torch.Tensor:
    """The implicit conv's launch on a's device (the op's CUDA
    implementation): mode 0 for int8 codes, mode 2 for bf16."""
    what = "quantized_conv3d"
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} needs contiguous codes and weight")
    dims = conv3d_output(tuple(a.shape[1:4]), kernel, stride, pads)
    n = b.shape[0]
    m = a.shape[0] * math.prod(dims)
    out = torch.empty((a.shape[0], *dims, n), dtype=out_dtype,
                      device=a.device)
    k_bytes = math.prod(kernel) * a.shape[-1] * a.element_size()
    splits = split_count(1, m, n, k_bytes)
    acc = torch.int32 if a.dtype == torch.int8 else torch.float32
    work = (torch.empty((splits, m, n), dtype=acc, device=a.device)
            if splits > 1 else None)
    if bias is not None:
        bias = (bias if bias.dtype in _KINDS else bias.float()).contiguous()
    ws = weight_scale.float().contiguous()
    s = None if input_scale is None else input_scale.float().reshape(())
    shape = (ctypes.c_longlong * 5)(*a.shape)
    args = [(ctypes.c_int * 3)(*v) for v in (kernel, stride, pads, dims)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().mmcsi_int8_conv3d(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(work),
            ws.data_ptr(), _ptr(s), _ptr(bias),
            int(bias is not None and bias.dtype == torch.bfloat16),
            _MODES[(a.dtype, b.dtype)], _KINDS[out_dtype], splits, shape,
            *args, n, b.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"{CONV3D_NAME} kernel launch failed with CUDA "
                           f"error {err} at codes {tuple(a.shape)}, kernel "
                           f"{kernel}, stride {stride}, N={n}")
    count_launch(CONV3D_NAME)
    return out


def _conv3d_fake(a, b, weight_scale, input_scale, bias, out_dtype, kernel,
                 stride, pads):
    dims = conv3d_output(tuple(a.shape[1:4]), kernel, stride, pads)
    return a.new_empty((a.shape[0], *dims, b.shape[0]), dtype=out_dtype)


define_op("quantized_conv3d(Tensor a, Tensor b, Tensor weight_scale, "
          "Tensor? input_scale, Tensor? bias, ScalarType out_dtype, "
          "int[] kernel, int[] stride, int[] pads) -> Tensor", _conv3d_launch,
          lambda a, b, weight_scale, input_scale, bias, out_dtype, kernel,
          stride, pads: quantized_conv3d_reference(
              a, b, weight_scale, input_scale, bias, out_dtype,
              tuple(kernel), tuple(stride), tuple(pads)).contiguous(),
          _conv3d_fake)
