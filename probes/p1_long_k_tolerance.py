#!/usr/bin/env python3
"""Read P1's bf16 x int8 product at MLP w8's layer_0 against the exact
product, the readings that set ``chip_smoke.py``'s long-K accumulation
bound (``LONG_K_LAMBDA``), and run the serving and training phases of
``chip_smoke.py`` that take MLP's and CNN-2D's flat input and conv paths.

At K = 810,000 the any-order bound of f32 sums, K 2^-23 sum |a b| an
element, is looser than the product itself. ``chip_smoke.py`` therefore
holds long products to LONG_K_LAMBDA 2^-24 sqrt(K) sum |a b|. This script
builds P1 alone and:

- runs ``chip_smoke.p1_w8_case``, which prints, in units of that bound,
  the kernel's distance from the exact (float64) product, the plain
  version's, and those of an all-zero output and of the kernel's output
  without one split of K or one 64-value stage, and fails unless the
  kernel is within the bound and the three wrong outputs are not;
- serves MLP and CNN-2D in bf16 at batch 256 (``serve_phase``: f32 card
  vs CPU within SERVE_F32_TOL), MLP in w8 (``int8_serve_phase``: the
  fused layer_0 held to the same long-K bound by ``check_fused``), and
  trains MLP in f32 at batch 16 (``train_phase_baseline``).

Run it from the repository root on a machine with one NVIDIA H100 and
nvcc:

    python3 probes/p1_long_k_tolerance.py

It fails (a non-zero exit) if P1 does not build or launch, or a check
fails.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from multi_modal_csi_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("p1_long_k_tolerance: no CUDA device available",
              file=sys.stderr)
        return 1
    print(smoke.card_line())
    build.load("int8_matmul")
    smoke.set_tf32(False)
    smoke.p1_w8_case(torch.Generator(device="cuda").manual_seed(smoke.SEED))

    rng = np.random.default_rng(smoke.SEED)
    requests = [rng.standard_normal((n, smoke.LENGTH, smoke.CHANNELS),
                                    dtype=np.float32)
                for n in smoke.REQUESTS]
    for key in ("MLP", "CNN-2D"):
        smoke.serve_phase(key, requests, lambda n: (n, 54), 0)
    with tempfile.TemporaryDirectory(prefix="p1_long_k_") as work:
        calib = os.path.join(work, "calib.npy")
        np.save(calib, np.random.default_rng(smoke.SEED + 3).standard_normal(
            (smoke.CALIB_WINDOWS, smoke.LENGTH, smoke.CHANNELS),
            dtype=np.float32))
        smoke.int8_serve_phase("MLP", requests, calib, {}, smoke.MLP_BF16,
                               0, lambda n: (n, 54), 0, mode="w8")
    smoke.train_phase_baseline("MLP", smoke.training_data())
    print("p1_long_k_tolerance: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
