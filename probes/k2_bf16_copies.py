#!/usr/bin/env python3
"""Time K2's bf16 kernels with element-by-element and with shifted 4-byte
copies against each other on a card.

At THAT's heads (D = 27 and 15) no copy wider than one bf16 divides D.
K2's bf16 launcher (``csrc/tc_attention_bwd.cuh``, ``launch_bwd_bf16``)
therefore copies as K1's bf16 body does: in aligned pieces from h D - sh
on, the stray positions zeroed in the fragments (``bwd_pick_copy``, "The
bf16 copies of K2"). The other choice is the width that divides D, which
at THAT's heads is one element, copied synchronously (``bwd_prepare``).
This script builds both into a library of its own, in a temporary
directory, and at THAT's training shapes (batch 16, 10 heads, Nq = Nk):

- holds each within ``BWD_TOL[bfloat16]`` (2^-7 of each gradient's largest
  magnitude) of the plain version;
- checks that the port's K2 gives the bits of the shifted copies;
- prints each pass's device time a launch (torch.profiler) and the sum
  per THAT training step (4 left + 1 right launches), beside the port's K2
  at the next D that a 16-byte ``cp.async`` divides (32 and 16: the same
  span of k-steps, so the same products and grid, with the widest copy).

It also prints ptxas's registers and spills. Run it from the repository
root on a machine with one NVIDIA H100 and nvcc:

    python3 probes/k2_bf16_copies.py

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
    flash_attention_backward, flash_attention_backward_reference)

# THAT's left and right streams at the training batch: (B, N, H), THAT's
# D, and the D of the same span that 16-byte copies divide
STREAMS = {"left": ((16, 150, 10), 27, 32), "right": ((16, 270, 10), 15, 16)}
PER_STEP = {"left": 4, "right": 1}
COPIES = {0: "element", 1: "shifted 4-byte"}

SOURCE = '''#include "tc_attention_bwd.cuh"

// K2 in bf16 with the launcher's shifted copies (shifted = 1) or with the
// width that divides D (shifted = 0)
extern "C" int probe_k2_bf16(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* work, int batch, int nq, int nk,
                             int heads, int d, int shifted, void* stream) {
  tc::BwdParamsOf<tc::bf16> p = {};
  p.q = static_cast<const tc::bf16*>(q);
  p.k = static_cast<const tc::bf16*>(k);
  p.v = static_cast<const tc::bf16*>(v);
  p.dout = static_cast<const tc::bf16*>(dout);
  p.bh = batch * heads;
  p.lse = static_cast<float*>(work);
  p.delta = p.lse + (long long)p.bh * nq;
  p.dq = static_cast<tc::bf16*>(dq);
  p.dk_out = static_cast<tc::bf16*>(dk);
  p.dv_out = static_cast<tc::bf16*>(dv);
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.row = heads * d;
  p.splits = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shifted) return tc::launch_bwd_bf16(p, s);
  const int err = tc::bwd_prepare(p);
  return err ? err : tc::launch_bwd_k2(p, p.d, s);
}
'''


def compile_library(tmp: Path):
    src, lib = tmp / "probe_k2_bf16.cu", tmp / "libprobe_k2_bf16.so"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    for kernel, line in smoke.ptxas_lines(proc.stdout):
        print(f"ptxas {kernel}: {line}")
    fn = ctypes.CDLL(str(lib)).probe_k2_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(fn, q, k, v, do, shifted):
    b, n, h, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    work = torch.empty((2, b * h, n), dtype=torch.float32, device=q.device)
    err = fn(*(t.data_ptr() for t in (q, k, v, do, dq, dk, dv, work)), b, n,
             n, h, d, shifted, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{COPIES[shifted]} copies at D = {d}: CUDA "
                           f"error {err}")
    return dq, dk, dv


def passes(fn):
    """Device ms a launch of K2 bf16's query pass and dK/dV pass."""
    times = smoke.kernel_ms(fn)
    return [sum(t for key, t in times.items() if kernel in key)
            for kernel in smoke.K2_PASSES[torch.bfloat16].values()]


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_bf16_copies: no CUDA device available", file=sys.stderr)
        return 1
    print(smoke.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        fn = compile_library(Path(tmp))
    tol = smoke.BWD_TOL[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    step = {}
    for name, ((b, n, h), d, d16) in STREAMS.items():
        runs = []
        for dim in (d, d16):
            q, k, v, do = (torch.randn((b, n, h, dim), generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            want = flash_attention_backward_reference(q, k, v, do)
            port = flash_attention_backward(q, k, v, do)
            cands = {"16-byte": lambda: flash_attention_backward(
                q, k, v, do)} if dim == d16 else {
                COPIES[s]: (lambda s=s: launch(fn, q, k, v, do, s))
                for s in COPIES}
            for label, call in cands.items():
                got = call()
                errs = [((g.float() - w.float()).abs().max()
                         / w.float().abs().max()).item()
                        for g, w in zip(got, want)]
                smoke.check(all(e <= tol for e in errs),
                            f"K2 bf16 {name} D={dim} {label}: {errs}")
                if label == COPIES[1]:
                    smoke.check(all(torch.equal(a, c)
                                    for a, c in zip(got, port)),
                                f"K2 bf16 {name}: the port's bits differ "
                                f"from the shifted copies'")
                runs.append((label, dim, passes(call)))
        for label, dim, (query, dkv) in runs:
            print(f"K2 bf16 {name} ({b}, {n}, {h}, {dim}), {label} copies: "
                  f"query pass {query:.4f} ms, dK/dV pass {dkv:.4f} ms a "
                  f"launch")
            step[label] = step.get(label, 0.0) + PER_STEP[name] * (query
                                                                   + dkv)
    print("K2 bf16 per THAT training step (profiler): " + ", ".join(
        f"{label} copies {ms:.4f} ms" for label, ms in step.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
