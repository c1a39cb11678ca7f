#!/usr/bin/env python3
"""Time the configurations of K1's f32 kernel against each other on a card.

K1's float32 launcher (``csrc/tc_attention.cuh::launch_f32_span``) runs
one configuration of the f32 body at THAT's head dims of 27 and 15 (spans
of two and one k-steps of 16): 4 warps of 16 query rows, 32-key tiles and
registers for 4 blocks an SM. This script builds that configuration and
the other candidates (``CONFIGS``: warps, keys a tile, blocks an SM) at
those spans into a library of their own, in a temporary directory, and
for THAT's three attention shapes at batch 16 (training), 256 and 512
(the evaluation chunk of ``train/loop.py::eval_dataset``):

- holds every candidate within F32_TOL of K1's plain version;
- checks that the port's K1 gives the bits of the configuration its
  launcher picks;
- prints each candidate's device time a launch (torch.profiler), and its
  sum per THAT and THAT_ENCODER step (4 left + 1 right launches).

It also prints ptxas's registers and spills for every candidate. Run it
from the repository root on a machine with one NVIDIA H100 and nvcc:

    python3 probes/k1_f32_configs.py

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
from multi_modal_csi_tpu_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_reference)

# warps, keys a tile, blocks an SM; PICKED is the launcher's at spans <= 32
CONFIGS = ((8, 64, 1), (4, 64, 2), (4, 32, 2), (8, 64, 2), (4, 64, 4),
           (4, 32, 4))
PICKED = (4, 32, 4)
SPANS = (1, 2)              # k-steps of 16: D = 15 and 27
BATCHES = (16, 256, 512)
STEP = ("that-left",) * 4   # and one right launch a training step
RIGHT = {"THAT": "that-right", "THAT_ENCODER": "that-encoder-right"}


def source() -> str:
    """One C entry launching the f32 body at a span in configuration
    ``config`` (an index of CONFIGS), without the bias."""
    cases = "".join(
        f"    case {100 * ks + i}: return tc::launch_f32_steps<{ks}, false, "
        f"{w}, {keys}, {blocks}>(p, s);\n"
        for ks in SPANS for i, (w, keys, blocks) in enumerate(CONFIGS))
    return f'''#include "tc_attention.cuh"

extern "C" int probe_k1_f32(const void* q, const void* k, const void* v,
                            void* out, int batch, int nq, int nk,
                            int heads, int d, int config, void* stream) {{
  tc::ParamsOf<float> p = {{}};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.groups = batch;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.row = heads * d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (100 * tc::prepare_f32<false>(p) + config) {{
{cases}    default: return (int)cudaErrorInvalidValue;
  }}
}}
'''


def compile_library(tmp: Path):
    src, lib = tmp / "probe_k1_f32.cu", tmp / "libprobe_k1_f32.so"
    src.write_text(source())
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "--split-compile=0", "-I",
         str(build.CSRC), "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    for kernel, line in smoke.ptxas_lines(proc.stdout):
        print(f"ptxas {kernel}: {line}")
    fn = ctypes.CDLL(str(lib)).probe_k1_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, q, k, v, config: int) -> torch.Tensor:
    out = torch.empty_like(q)
    b, nq, h, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
             nq, k.shape[1], h, d, config,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"configuration {CONFIGS[config]} at D = {d}: "
                           f"CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(smoke.card_line())
    smoke.set_tf32(False)
    with tempfile.TemporaryDirectory() as tmp:
        fn = compile_library(Path(tmp))
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    times = {}   # (name, batch) -> device ms a launch, by configuration
    for batch in BATCHES:
        for name in smoke.K1_TRAIN_SHAPES:
            shape, nk = smoke.KERNEL_SHAPES[name]
            _, nq, h, d = shape
            q = torch.randn((batch, nq, h, d), generator=gen, device="cuda")
            k, v = (torch.randn((batch, nk, h, d), generator=gen,
                                device="cuda") for _ in range(2))
            want = flash_attention_reference(q, k, v)
            port = flash_attention(q, k, v)
            row = []
            for i, config in enumerate(CONFIGS):
                got = launch(fn, q, k, v, i)
                err = (got - want).abs().max().item()
                smoke.check(err <= smoke.F32_TOL,
                            f"{name}-{batch} {config} err {err}")
                if config == PICKED:
                    smoke.check(torch.equal(got, port),
                                f"{name}-{batch}: the port's K1 is not "
                                f"{PICKED}")
                by_kernel = smoke.kernel_ms(
                    lambda: launch(fn, q, k, v, i))
                row.append(sum(t for key, t in by_kernel.items()
                               if smoke.K1_F32 in key))
            times[(name, batch)] = row
            del q, k, v, want, port, got
            print(f"{name}-{batch} ({batch}, {nq}, {h}, {d}), nk={nk}, "
                  f"device ms a launch: " + ", ".join(
                      f"{c} {t:.4f}" for c, t in zip(CONFIGS, row)))
        for model, right in RIGHT.items():
            names = STEP + (right,)
            print(f"per {model} step at batch {batch}: " + ", ".join(
                f"{c} {sum(times[(n, batch)][i] for n in names):.4f}"
                for i, c in enumerate(CONFIGS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
