"""Serve a CSI model on seeded random requests and report its throughput.

Usage:
  python -m multi_modal_csi_tpu_torch.cli.serve_csi --model THAT \
      [--task activity] [--batch 0] [--dtype auto] [--device cuda] \
      [--requests 256,100,300]

The weights are drawn from a seeded generator; each request is a seeded
numpy array of (n, 3000, 270) float32 windows in host memory.
Prints each request's output shape and the windows per second over all
requests, timed from the host arrays to the logits back on the host. The
first request is answered once untimed, as warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.config import CSI_CHANNELS, Config
from ..core.serving import CSIServer
from ..runners.csi import CSI_MODELS, build_model

SEED = 0


def make_requests(sizes, seed: int, length: int):
    """One (n, length, 270) float32 array of standard normals per size."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, length, CSI_CHANNELS), dtype=np.float32)
            for n in sizes]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, choices=sorted(CSI_MODELS))
    p.add_argument("--task", default="activity",
                   choices=["activity", "identity", "location"])
    p.add_argument("--batch", type=int, default=0,
                   help="serving batch (0 = the model's default, 256)")
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", default="256,100,300",
                   help="comma-separated window counts, one per request")
    args = p.parse_args(argv)

    sizes = [int(n) for n in args.requests.split(",")]
    model = build_model(args.model, args.task, seed=SEED)
    server = CSIServer(args.model, model, batch=args.batch or None,
                       dtype=args.dtype, device=args.device)
    requests = make_requests(sizes, SEED, Config().data.length)
    server(requests[0]).cpu()                                  # warm-up

    start = time.perf_counter()
    shapes = [tuple(server(r).cpu().shape) for r in requests]
    seconds = time.perf_counter() - start
    for n, shape in zip(sizes, shapes):
        print(f"{args.model}: request of {n} windows -> logits {shape}")
    device = (torch.cuda.get_device_name(server.device)
              if server.device.type == "cuda" else "cpu")
    print(f"{args.model} {server.dtype} batch {server.batch} on {device}: "
          f"{sum(sizes) / seconds:.1f} windows/s over {sum(sizes)} windows")


if __name__ == "__main__":
    main()
