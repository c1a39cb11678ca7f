#!/usr/bin/env python3
"""Time the ring depths of K4's bf16 dK/dV/dS kernel against each other on
a card.

K4's bfloat16 dK/dV/dS launcher (``csrc/tc_attention_bwd.cuh``,
``launch_bwd_dkv_bf16``) runs the bf16 key-major body with
``kBwdBf16Stages`` query tiles of 32 rows in its ``cp.async`` ring. Its Q
and dO stages take half the bytes of the f32 body's, which leaves room for
a deeper ring at MViT's D = 96. This script builds the body at a span of 6
k-steps of 16 (D = 96) with rings of 2, 3 and 4 stages (``STAGES``) into a
library of its own, in a temporary directory, and at MViT's three training
blocks (batch 2), with and without the bias:

- holds every candidate within ``LOWRANK_BWD_TOL[bfloat16]`` (2^-7 of each
  gradient's largest magnitude) of the plain version;
- checks that the port's kernel gives the bits of the depth its launcher
  picks (``PICKED``);
- prints each candidate's device time a launch (torch.profiler) and its
  sum per MViT-v1 (no bias) and MViT-v2 (bias) bf16 training step.

It also prints ptxas's registers and spills for every candidate. Run it
from the repository root on a machine with one NVIDIA H100 and nvcc:

    python3 probes/k4_bf16_dkv_stages.py

It fails (a non-zero exit) if a candidate does not build or launch, or
disagrees.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from multi_modal_csi_tpu_torch.kernels import build  # noqa: E402
from multi_modal_csi_tpu_torch.kernels import \
    flash_attention_lowrank as lowrank  # noqa: E402

STAGES = (2, 3, 4)
PICKED = 2                  # tc::kBwdBf16Stages
KERNEL = "attention_bwd_dkv_bf16_kernel"


def source() -> str:
    """One C entry launching the bf16 dK/dV/dS body at a span of 6
    k-steps with ``stages`` query tiles in its ring."""
    cases = "".join(
        f"    case {n}: return tc::with_bwd_m_tiles<6>(p.m, "
        f"Launch<{n}>{{p, s}});\n" for n in STAGES)
    return f'''#include "tc_attention_bwd.cuh"

template <int STAGES>
struct Launch {{
  const tc::BwdParamsOf<tc::bf16>& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const {{
    return tc::launch_bwd_dkv_bf16_steps<KS, MT, STAGES>(p, stream);
  }}
}};

extern "C" int probe_k4_bf16_dkv(
    const void* q, const void* k, const void* v, const void* r,
    const void* s_, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, void* ds, int bh, int nq, int nk, int d, int m,
    int splits, int stages, void* stream) {{
  tc::BwdParamsOf<tc::bf16> p = {{}};
  p.q = static_cast<const tc::bf16*>(q);
  p.k = static_cast<const tc::bf16*>(k);
  p.v = static_cast<const tc::bf16*>(v);
  p.dout = static_cast<const tc::bf16*>(dout);
  p.r = static_cast<const float*>(r);
  p.s = static_cast<const float*>(s_);
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.ds = static_cast<float*>(ds);
  p.part = (long long)bh * nk * d;
  p.bh = bh;
  p.heads = 1;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.m = m;
  p.row = d;
  p.splits = splits;
  const int err = tc::bwd_prepare(p);
  if (err != 0 || d <= 80 || d > 96) return err ? err : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {{
{cases}    default: return 1;
  }}
}}
'''


def compile_library(tmp: Path):
    src, lib = tmp / "probe_k4_bf16.cu", tmp / "libprobe_k4_bf16.so"
    src.write_text(source())
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "--split-compile=0", "-I",
         str(build.CSRC), "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    for kernel, line in smoke.ptxas_lines(proc.stdout):
        print(f"ptxas {kernel}: {line}")
    fn = ctypes.CDLL(str(lib)).probe_k4_bf16_dkv
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, args, stages: int):
    """dK, dV (bf16) and dS (f32 or None) from the candidate with
    ``stages`` ring stages, its partials summed as the port sums them."""
    q, k, v, r, s, do, lse, delta = args
    b, h, nq, d = q.shape
    nk, m = k.shape[2], 0 if r is None else r.shape[3]
    keys = lowrank.dkv_keys(d, m, q.dtype)
    splits = lowrank.dkv_splits(
        b * h * -(-nk // keys), nq,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.empty((splits, b, h, nk, d), **f32)
    dv = torch.empty((splits, b, h, nk, d), **f32)
    ds = None if r is None else torch.empty((splits, b * h, m, nk), **f32)
    ptrs = [None if t is None else t.data_ptr()
            for t in (q, k, v, r, s, do, lse, delta, dk, dv, ds)]
    err = fn(*ptrs, b * h, nq, nk, d, m, splits, stages,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{stages} stages at D = {d}, M = {m}: CUDA "
                           f"error {err}")
    return (dk.sum(dim=0).to(k.dtype), dv.sum(dim=0).to(v.dtype),
            None if ds is None else ds.sum(dim=(0, 1)))


def inputs(shape, bias, gen):
    """chip_smoke.py's K4 inputs at ``shape`` in bf16, the LSE and out from
    K3's plain version, delta from out and dO."""
    b, h, nq, nk, d, m = shape
    q, do = (torch.randn((b, h, nq, d), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, nk, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    r = s = None
    if bias:      # the class token's row and column carry 0
        r = torch.randn((b, h, nq, m), generator=gen, device="cuda")
        s = torch.randn((m, nk), generator=gen, device="cuda")
        r[:, :, 0] = 0.0
        s[:, 0] = 0.0
    out, lse = lowrank.flash_attention_lowrank_bias_reference(
        q, k, v, r, s, return_lse=True)
    delta = (do.float() * out.float()).sum(dim=-1)
    return q, k, v, r, s, do, lse, delta


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(smoke.card_line())
    smoke.set_tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        fn = compile_library(Path(tmp))
    tol = smoke.LOWRANK_BWD_TOL[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    steps = {False: [0.0] * len(STAGES), True: [0.0] * len(STAGES)}
    for name, shape in smoke.LOWRANK_BWD_SHAPES.items():
        for bias in (False, True):
            args = inputs(shape, bias, gen)
            want = lowrank.lowrank_backward_dkv_reference(*args)
            port = lowrank.lowrank_backward_dkv(*args)
            row = []
            for i, n in enumerate(STAGES):
                got = launch(fn, args, n)
                for g_name, g, w in zip(("dk", "dv", "ds"), got, want):
                    if w is None:
                        continue
                    err = (g.float() - w.float()).abs().max().item()
                    top = w.float().abs().max().item()
                    smoke.check(err <= tol * top,
                                f"{name} bias={bias} {n} stages {g_name} "
                                f"err {err} > {tol} x {top}")
                if n == PICKED:
                    smoke.check(all(
                        (a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(got, port)),
                        f"{name}: the port's kernel is not {PICKED} stages")
                by_kernel = smoke.kernel_ms(lambda: launch(fn, args, n),
                                            reps=5)
                row.append(sum(t for key, t in by_kernel.items()
                               if KERNEL in key))
                steps[bias][i] += row[-1]
            del args, want, port, got
            print(f"{name}{'+bias' if bias else ''} {shape} bf16, device "
                  f"ms a launch: " + ", ".join(
                      f"{n} stages {t:.4f}" for n, t in zip(STAGES, row)))
    for bias in (False, True):
        print(f"per MViT-v{2 if bias else 1} bf16 step (blocks 0-2): "
              + ", ".join(f"{n} stages {t:.4f}"
                          for n, t in zip(STAGES, steps[bias])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
