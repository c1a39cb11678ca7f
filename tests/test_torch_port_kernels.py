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


def test_kernel_sources_and_build_flags(tmp_path, monkeypatch):
    """Every kernel is a csrc/*.cu with plain C launchers, built for
    sm_90a with ``-I csrc``; the shared headers are tc_attention.cuh, the
    tensor-core bodies of K1's and K3's kernels (mma.sync fed by ldmatrix,
    cp.async copies), and tc_attention_bwd.cuh, which includes it: K4's
    f32 dK/dV/dS body and K2's f32 query pass and dK/dV pass (tf32
    mma.sync); the library name changes with the source, with a header it
    includes, or with the flags."""
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
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
        "tc_attention.cuh", "tc_attention_bwd.cuh"]
    for stem, names in launchers.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        assert 'extern "C"' in src
        assert all(f"int mmcsi_{name}(" in src for name in names)
        assert build._target(stem).parent == build.BUILD_DIR
    header = (build.CSRC / "tc_attention.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "ldmatrix" in header and "cp.async" in header
    for stem in ("flash_attention", "flash_attention_lowrank"):
        src = (build.CSRC / f"{stem}.cu").read_text()
        bf16_case = src[src.index("case 1:"):]
        assert "tc::launch" in bf16_case
        assert build._sources(stem) == [build.CSRC / f"{stem}.cu",
                                         build.CSRC / "tc_attention.cuh"]
    for stem, launcher in (("flash_attention_lowrank_bwd",
                            "tc::launch_bwd_dkv_f32"),
                           ("flash_attention_bwd", "tc::launch_bwd_f32(")):
        bwd = (build.CSRC / f"{stem}.cu").read_text()
        f32_case = bwd[bwd.index("case 0: {"):bwd.index(
            "case 1:", bwd.index("case 0: {"))]
        assert launcher in f32_case
        assert build._sources(stem) == [
            build.CSRC / f"{stem}.cu", build.CSRC / "tc_attention_bwd.cuh",
            build.CSRC / "tc_attention.cuh"]
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    bwd_header = (build.CSRC / "tc_attention_bwd.cuh").read_text()
    assert '#include "tc_attention.cuh"' in bwd_header
    assert "mma3(" in bwd_header and "cp_async" in bwd_header
    assert build._sources("int8_matmul") == [build.CSRC / "int8_matmul.cu"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    command = build._command("flash_attention", "out.so")
    assert command[command.index("-I") + 1] == str(build.CSRC)
    assert build._target("flash_attention") != build._target(
        "flash_attention_bwd")
    # a copy of csrc/: editing a header renames the libraries that include
    # it, directly or through the other header, and no other
    copy = tmp_path / "csrc"
    copy.mkdir()
    for path in build.CSRC.iterdir():
        (copy / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", copy)
    for edited, renamed in (
            ("tc_attention_bwd.cuh", {"flash_attention_bwd",
                                      "flash_attention_lowrank_bwd"}),
            ("tc_attention.cuh", {"flash_attention", "flash_attention_bwd",
                                  "flash_attention_lowrank",
                                  "flash_attention_lowrank_bwd"})):
        before = {stem: build._target(stem) for stem in launchers}
        with open(copy / edited, "a") as f:
            f.write("// edited\n")
        after = {stem: build._target(stem) for stem in launchers}
        assert {stem for stem in launchers
                if before[stem] != after[stem]} == renamed