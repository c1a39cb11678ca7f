"""Serve a CSI model on seeded random requests and report its throughput.

Usage:
  python -m multi_modal_csi_tpu_torch.cli.serve_csi --model THAT \
      [--task activity] [--batch 0] [--dtype auto] [--device cuda] \
      [--requests 256,100,300] [--quant none] [--calib F.npy] \
      [--calib-stat amax]

``--model`` takes every ported CSI key (``runners/csi.py::CSI_MODELS``):
the WiMANS baselines MLP, CNN-1D, CNN-2D, LSTM, CLSTM and ABLSTM, the THAT
family, THAT_ENCODER and DETR. The weights are drawn from a seeded
generator; each request is a seeded numpy array of (n, 3000, 270) float32
windows in host memory (MLP's server flattens each batch). ``--quant``
serves int8 weights (``core/quantize.py``): "auto" takes the model's
``QUANT_DEFAULTS`` (w8a8 for DETR and THAT_ENCODER, w8 for MLP); w8a8
calibrates on ``--calib``, a .npy of (n, 3000, 270) windows split into
serving batches. CNN-2D's int8 serving raises NotImplementedError (ROADMAP
item 12).
Prints each request's output shape and the windows per second over all
requests, timed from the host arrays to the logits back on the host. The
first request is answered once untimed, as warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.config import CSI_CHANNELS, QUANT_CHOICES, Config, resolve_quant
from ..core.quantize import STATS
from ..core.serving import CSIServer
from ..runners.csi import CSI_MODELS, build_model

SEED = 0


def make_requests(sizes, seed: int, length: int):
    """One (n, length, 270) float32 array of standard normals per size."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, length, CSI_CHANNELS), dtype=np.float32)
            for n in sizes]


def add_quant_arguments(p: argparse.ArgumentParser) -> None:
    """--quant, --calib and --calib-stat, as the JAX package's export CLI
    has them (``cli/export_model.py:81-93`` there)."""
    p.add_argument("--quant", default="none", choices=QUANT_CHOICES,
                   help="int8 post-training quantization of the hooked "
                        "matmul/conv weights (core/quantize.py). auto = "
                        "the model's default (core.config.QUANT_DEFAULTS). "
                        "w8a8 additionally needs --calib NPY of inputs")
    p.add_argument("--calib", default=None,
                   help="path to a .npy of calibration inputs (N, *input) "
                        "for --quant w8a8; split into batches of --batch")
    p.add_argument("--calib-stat", default="amax", choices=STATS,
                   help="w8a8 activation-scale statistic: exact max-abs or "
                        "the outlier-robust 99.9th percentile")


def quant_arguments(args: argparse.Namespace):
    """The resolved int8 mode and the calibration samples (or None);
    exits when w8a8 has no --calib, as the JAX export CLI does."""
    quant = resolve_quant(args.quant, args.model)
    calib = np.load(args.calib) if args.calib else None
    if quant == "w8a8" and calib is None:
        raise SystemExit(f"--quant {args.quant} resolved to w8a8 for "
                         f"{args.model}: pass --calib with real input "
                         "batches to calibrate the activation scales")
    return quant, calib


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
    add_quant_arguments(p)
    args = p.parse_args(argv)
    quant, calib = quant_arguments(args)

    sizes = [int(n) for n in args.requests.split(",")]
    model = build_model(args.model, args.task, seed=SEED)
    server = CSIServer(args.model, model, batch=args.batch or None,
                       dtype=args.dtype, device=args.device,
                       quant=quant, calib=calib,
                       calib_stat=args.calib_stat)
    requests = make_requests(sizes, SEED, Config().data.length)
    server(requests[0]).cpu()                                  # warm-up

    start = time.perf_counter()
    shapes = [tuple(server(r).cpu().shape) for r in requests]
    seconds = time.perf_counter() - start
    for n, shape in zip(sizes, shapes):
        print(f"{args.model}: request of {n} windows -> logits {shape}")
    device = (torch.cuda.get_device_name(server.device)
              if server.device.type == "cuda" else "cpu")
    print(f"{args.model} {server.dtype} quant {server.quant} batch "
          f"{server.batch} on {device}: "
          f"{sum(sizes) / seconds:.1f} windows/s over {sum(sizes)} windows")


if __name__ == "__main__":
    main()
