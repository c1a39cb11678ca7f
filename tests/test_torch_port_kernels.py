"""The port's attention kernel module (multi_modal_csi_tpu_torch.kernels.
flash_attention) on the CPU, where it takes its plain version, against the
JAX package's Pallas kernel run in interpret mode.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there. Tolerances: f32 2e-5 absolute, the bound
of tests/test_kernels.py. bf16 2**-7 absolute, one bf16 step for outputs
below 2 in magnitude (these are): both sides round the softmax weights and
the output to bf16, and an f32 sum taken in another order can put a value
on the other side of a rounding step. The largest bf16 error measured on
these inputs was 2**-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.kernels import build
from multi_modal_csi_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_reference)

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
SHAPES = {
    "that-left": ((2, 150, 10, 27), 150),
    "that-right": ((2, 270, 10, 15), 270),
    "ragged": ((3, 64, 10, 15), 64),
    "cross": ((2, 128, 6, 45), 420),
}


def _inputs(shape, nk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, nq, h, d = shape
    q = rng.standard_normal((b, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, nk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, nk, h, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    return ([torch.from_numpy(a).to(tdt) for a in (q, k, v)],
            [jnp.asarray(a).astype(jdt) for a in (q, k, v)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_version_matches_jax_kernel(case, dtype):
    shape, nk = SHAPES[case]
    (q, k, v), (jq, jk, jv) = _inputs(shape, nk, dtype)
    want = np.asarray(jax_flash_attention(jq, jk, jv, interpret=True)
                      .astype(jnp.float32))
    got = flash_attention(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])


def test_cpu_tensors_take_plain_version_without_counting():
    kernels.reset_launch_counts()
    (q, k, v), _ = _inputs((2, 70, 2, 8), 70, "float32")
    got = flash_attention(q, k, v)
    assert torch.equal(got, flash_attention_reference(q, k, v))
    assert kernels.LAUNCH_COUNTS.get("flash_attention", 0) == 0


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "mixed",
                                 "strided", "no-keys"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    (q, k, v), _ = _inputs((2, 70, 2, 8), 70, "float32")
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = k[:, :, :1].contiguous()
    elif bad == "no-keys":
        k, v = k[:, :0].contiguous(), v[:, :0].contiguous()
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v)


def test_kernel_sources_and_build_flags():
    """Every kernel is a csrc/*.cu with plain C launchers, built for
    sm_90a; the library name changes with the source or the flags."""
    launchers = {
        "flash_attention": ["flash_attention"],
        "flash_attention_bwd": ["flash_attention_bwd"],
        "flash_attention_lowrank": ["flash_attention_lowrank"],
        "flash_attention_lowrank_bwd": ["flash_attention_lowrank_bwd_dq",
                                        "flash_attention_lowrank_bwd_dkv"],
        "csi_preprocess": ["csi_preprocess"],
        "int8_matmul": ["int8_matmul"]}
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(
        launchers)
    for stem, names in launchers.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        assert 'extern "C"' in src
        assert all(f"int mmcsi_{name}(" in src for name in names)
        assert build._target(stem).parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build._target("flash_attention") != build._target(
        "flash_attention_bwd")
