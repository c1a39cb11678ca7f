"""Serve a video model on seeded random clips and report its throughput.

Usage:
  python -m multi_modal_csi_tpu_torch.cli.serve_video --model MViT-v2 \
      [--task identity] [--pretrained PATH] [--clip 45,224,224] \
      [--batch 0] [--dtype auto] [--device cuda] [--requests 2,1,3]

The weights are drawn from a seeded generator, or loaded from a
torchvision-layout checkpoint with ``--pretrained`` (its tables resized to
the clip). Each request is a seeded numpy array of (n, T, H, W, 3) float32
clips in host memory, in the JAX cache layout. Prints each request's
output shape and the clips per second over all requests, timed from the
host arrays to the logits back on the host. The first request is answered
once untimed, as warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.serving import VideoServer
from ..runners.video import (TASK_OUT_FEATURES, VIDEO_CLIP, VIDEO_MODELS,
                             build_video_model, load_video_pretrained)

SEED = 0


def make_clips(sizes, seed: int, clip):
    """One (n, T, H, W, 3) float32 array of standard normals per size."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, *clip, 3), dtype=np.float32)
            for n in sizes]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, choices=sorted(VIDEO_MODELS))
    p.add_argument("--task", default="identity",
                   choices=sorted(TASK_OUT_FEATURES))
    p.add_argument("--pretrained", default=None,
                   help="torchvision-layout .pt/.pth checkpoint")
    p.add_argument("--clip", default=",".join(map(str, VIDEO_CLIP)),
                   help="T,H,W of every clip")
    p.add_argument("--batch", type=int, default=0,
                   help="serving batch (0 = the model's default, 2)")
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", default="2,1,3",
                   help="comma-separated clip counts, one per request")
    args = p.parse_args(argv)

    clip = tuple(int(n) for n in args.clip.split(","))
    sizes = [int(n) for n in args.requests.split(",")]
    model = build_video_model(args.model, TASK_OUT_FEATURES[args.task], clip,
                              seed=SEED)
    if args.pretrained:
        load_video_pretrained(args.pretrained, args.model, model)
    server = VideoServer(args.model, model, batch=args.batch or None,
                         dtype=args.dtype, device=args.device)
    requests = make_clips(sizes, SEED, clip)
    server(requests[0]).cpu()                                  # warm-up

    start = time.perf_counter()
    shapes = [tuple(server(r).cpu().shape) for r in requests]
    seconds = time.perf_counter() - start
    for n, shape in zip(sizes, shapes):
        print(f"{args.model}: request of {n} clips -> logits {shape}")
    device = (torch.cuda.get_device_name(server.device)
              if server.device.type == "cuda" else "cpu")
    print(f"{args.model} {server.dtype} batch {server.batch} on {device}: "
          f"{sum(sizes) / seconds:.2f} clips/s over {sum(sizes)} clips of "
          f"{clip}")


if __name__ == "__main__":
    main()
