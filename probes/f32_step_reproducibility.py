#!/usr/bin/env python3
"""Whether the port's f32 training steps give the same bits run after run
on the card, and what a step costs, with cuDNN's deterministic flag at
PyTorch's default (off) or on (``--deterministic``).

For each model, at full width from seeded weights and inputs: the same
number of steps from the same start twice, each from a fresh model, and
the parameters compared bit for bit (the tensors that differ counted and
the largest difference printed); then a warm-up step and the milliseconds
a step over timed steps (host clock around steps that end in a
synchronize). The CSI models train at batch 16 on (3000, 270) windows,
ResNet3D-18 and S3D at batch 2 on their serving clips, as
``chip_smoke.py`` trains them.

Run it from the root of the repository, off and on in turn in one call
(off, on, on, off) to compare the two on one card:

    PYTHONPATH=. python3 probes/f32_step_reproducibility.py \\
        [--deterministic] [--label NAME] [--models THAT_ENCODER ResNet ...]

It prints one JSON line with the label, the flag, the card and the
figures.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

LENGTH, CHANNELS, BATCH, CLIP_BATCH = 3000, 270, 16, 2
SEED, STEPS, TIMED = 0, 3, 10
CSI = ("THAT_ENCODER", "THAT", "CNN-1D", "CNN-2D", "CLSTM")
VIDEO = ("ResNet", "S3D")


def csi_case(key: str):
    """A fresh model, its step and one seeded batch."""
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS, build_model
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    cfg, spec = Config(), CSI_MODELS[key]
    out = 10 if key == "THAT_ENCODER" else 54
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((BATCH, LENGTH, CHANNELS), dtype=np.float32)
    if key == "THAT_ENCODER":
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, (BATCH, 5))]
    else:
        y = np.zeros((BATCH, out), np.float32)
        y[np.arange(BATCH), rng.integers(0, out, BATCH)] = 1.0
    model = build_model(key, seed=SEED).cuda()
    step = make_train_step(model, adam_like_torch(
        model.parameters(), cfg.nn.lr, spec.weight_decay),
        spec.make_loss(cfg, out))
    return model, step, torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def video_case(key: str):
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.runners.video import (VIDEO_CLIPS,
                                                         build_video_model)
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((CLIP_BATCH, *VIDEO_CLIPS[key], 3),
                            dtype=np.float32)
    y = (rng.random((CLIP_BATCH, 6)) < 0.5).astype(np.float32)
    model = build_video_model(key, 6, seed=SEED).cuda()
    step = make_train_step(model, adam_like_torch(model.parameters(), 1e-4),
                           bce_with_logits, augment=False)
    return model, step, torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def measure(key: str) -> dict:
    case = csi_case if key in CSI else video_case
    states = []
    for _ in range(2):
        model, step, bx, by = case(key)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for _ in range(STEPS):
            step(bx, by, gen)
        torch.cuda.synchronize()
        states.append({k: v.detach().clone()
                       for k, v in model.state_dict().items()})
    differ = [k for k in states[0] if not torch.equal(states[0][k],
                                                       states[1][k])]
    largest = max((float((states[0][k].double() - states[1][k].double())
                         .abs().max()) for k in differ), default=0.0)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(bx, by, gen)                                       # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TIMED):
        step(bx, by, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) / TIMED * 1e3
    tensors = len(states[0])
    del model, step, states
    torch.cuda.empty_cache()
    return {"tensors": tensors, "differ": len(differ),
            "largest_diff": largest, "step_ms": ms}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms only")
    p.add_argument("--models", nargs="*", default=list(CSI + VIDEO))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_step_reproducibility: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from multi_modal_csi_tpu_torch.kernels import build
    with ThreadPoolExecutor(2) as pool:       # THAT's K1 and K2, together
        list(pool.map(build.load, ("flash_attention", "flash_attention_bwd")))
    torch.backends.cuda.matmul.allow_tf32 = False      # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = args.deterministic
    out = {"label": args.label, "deterministic": args.deterministic,
           "card": card, "steps": STEPS,
           "timed": TIMED, "models": {}}
    for key in args.models:
        out["models"][key] = measure(key)
        print(key, out["models"][key], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
