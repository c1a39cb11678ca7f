#!/usr/bin/env python3
"""What the ``mmcsi`` custom ops cost eager serving on the card.

The wrappers of the serving kernels (K1, K3, P1 and both prologues) launch
through ``torch.library`` custom ops, so that an exported program holds
them. Each op call passes through PyTorch's dispatcher and its Python
wrappers before the ctypes launch. This script measures that on a card:

- eager int8 serving of DETR and THAT_ENCODER in w8a8 at batch 256, full
  width, from seeded weights and windows: the launches a forward, windows/s
  with the requests in host memory and already on the card;
- where the tree has the ops, the host microseconds one call takes through
  the op and through the launch function the op wraps, at a small product
  whose kernel takes a few microseconds, so that the host time shows.

Run it with the tree to measure as the import root, so that a parent
commit unpacked beside the repository is measured by the same script:

    PYTHONPATH=<tree> python3 probes/op_dispatch.py [--label NAME]

It prints one JSON line with the label and the figures.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

LENGTH, CHANNELS, BATCH = 3000, 270, 256
REQUESTS = (256, 100, 300)        # ragged requests, as the serving phase
CALIB, SEED, ROUNDS, CALLS = 64, 39, 5, 2000


def serving(key: str) -> dict:
    from multi_modal_csi_tpu_torch import kernels
    from multi_modal_csi_tpu_torch.core.serving import CSIServer
    from multi_modal_csi_tpu_torch.runners.csi import build_model
    rng = np.random.default_rng(SEED)
    calib = rng.standard_normal((CALIB, LENGTH, CHANNELS), dtype=np.float32)
    requests = [rng.standard_normal((n, LENGTH, CHANNELS), dtype=np.float32)
                for n in REQUESTS]
    server = CSIServer(key, build_model(key, seed=SEED), batch=BATCH,
                       dtype="bfloat16", device="cuda", quant="w8a8",
                       calib=calib)
    xb = torch.from_numpy(requests[0]).cuda()
    server.forward(xb)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    server.forward(xb)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCH_COUNTS)
    n = sum(REQUESTS)
    start = time.perf_counter()
    for r in requests:
        server(r).cpu()
    host = n / (time.perf_counter() - start)
    resident = [torch.from_numpy(r).cuda() for r in requests]
    rates = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for r in resident:
            server(r)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - start))
    return {"launches": launches, "host_windows_s": host,
            "card_windows_s": rates}


def dispatch() -> dict:
    """Host us a call: the op against the launch function it wraps."""
    from multi_modal_csi_tpu_torch.kernels import int8_matmul as M
    launch = getattr(M, "_product_launch", None)
    if launch is None:
        return {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randint(-127, 128, (128, 272), dtype=torch.int8, device="cuda",
                      generator=g)
    b = torch.randint(-127, 128, (96, 272), dtype=torch.int8, device="cuda",
                      generator=g)
    ws = torch.rand(96, device="cuda", generator=g)
    s = torch.tensor(0.02, device="cuda")
    bias = torch.rand(96, device="cuda", generator=g)
    calls = {"op": lambda: torch.ops.mmcsi.quantized_product(
                 a, b, ws, s, bias, torch.float32, 270),
             "launch": lambda: launch(a, b, ws, s, bias, torch.float32,
                                      270)}
    out = {}
    with torch.no_grad():
        for rep in range(2):            # op, launch, op, launch
            for name, fn in calls.items():
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                start = time.perf_counter()
                for _ in range(CALLS):
                    fn()
                host = time.perf_counter() - start
                torch.cuda.synchronize()
                out.setdefault(f"{name}_us", []).append(host / CALLS * 1e6)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--label", default="tree")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("op_dispatch.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    result = {"label": args.label, "card": card.strip().splitlines()[0],
              "torch": torch.__version__}
    for key in ("DETR", "THAT_ENCODER"):
        result[key] = serving(key)
        torch.cuda.empty_cache()
    result["dispatch"] = dispatch()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
