"""Export a CSI or video model's serving forward as an artifact.

Usage:
  python -m multi_modal_csi_tpu_torch.cli.export_model --model DETR \
      --task activity --batch 256 --out detr_serving.mmcsi \
      [--pretrained PATH] [--dtype auto] [--platforms cuda,cpu] \
      [--device cuda]
  python -m multi_modal_csi_tpu_torch.cli.export_model --model S3D \
      --out s3d.mmcsi

The port of the JAX package's ``cli/export_model.py``, with its flags,
defaults and refusals: every model key its table holds (the 11 CSI keys of
``runners/csi.py::CSI_MODELS`` and the 6 video backbones; SSL, dual band
and ST-RF have runners of their own and no serving artifact), the
reduced-target models at task ``activity`` only, ``--quant`` w8a8 only
with ``--calib``, an int8 input only with ``--input-scale`` or
``--calib``. The artifact (``core/export.py``) is reloaded with
``core.export.serve_file``, with no model code. Platforms with ``cuda``
(``--platforms cuda``, or the default ``cuda,cpu``) keep the hand kernels
in it as ``mmcsi`` ops, which launch on the card and take their plain
versions on the CPU; ``cuda`` alone serves on the card only, ``cuda,cpu``
on either device. ``--device`` is where the model is built and traced (the
card unless told otherwise).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.config import (CSI_CHANNELS, load_config, resolve_quant,
                           resolve_serving_batch, resolve_serving_dtype)
from ..core.device import resolve_device
from ..core.export import PLATFORMS, export_serving, save_artifact, \
    stored_bytes
from ..runners.csi import CSI_MODELS, build_model
from ..runners.video import (VIDEO_CLIPS, VIDEO_MODELS, build_video_model,
                             load_video_pretrained)

# task -> (per-user class count, baseline flat out_dim, reduced out_dim)
_TASK_DIMS = {
    "activity": (9, 6 * 9, 10),
    "identity": (6, 6, None),
    "location": (5, 6 * 5, None),
}


def infer_out_dim(model_key: str, task: str) -> int:
    """The out_features the runner derives from the encoded labels: raw
    targets flatten the per-user one-hots, reduced targets use the
    10-class query rows (JAX's ``cli/export_model.py:32-42``)."""
    _, flat, reduced = _TASK_DIMS[task]
    if CSI_MODELS[model_key].target.startswith("reduce"):
        if reduced is None:
            raise SystemExit(f"{model_key} supports task=activity only")
        return reduced
    return flat


def _fold(model_key: str, model: torch.nn.Module, out_dim: int,
          in_features: int) -> torch.nn.Module:
    """MLP's or CNN-2D's input BatchNorm folded into its first layer."""
    generator = torch.Generator().manual_seed(0)   # weights replaced below
    if model_key == "MLP":
        from ..models.csi.mlp import MLP, fold_input_norm
        folded = MLP(out_dim, in_features=in_features, fold_input_norm=True,
                     generator=generator)
    else:
        from ..models.csi.cnn_2d import CNN2D, fold_input_norm
        folded = CNN2D(out_dim, fold_input_norm=True, generator=generator)
    folded.load_state_dict(fold_input_norm(model.state_dict()), strict=True)
    return folded.eval()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True)
    p.add_argument("--task", default="activity", choices=sorted(_TASK_DIMS))
    p.add_argument("--batch", type=int, default=0,
                   help="serving batch (0 = the model's serving default, "
                        "core.config.SERVING_BATCH_DEFAULTS)")
    p.add_argument("--out", required=True)
    p.add_argument("--pretrained", default=None,
                   help="component checkpoint (core.checkpoint) for a CSI "
                        "model; a component file or a torchvision-layout "
                        ".pt/.pth for a video model")
    p.add_argument("--dtype", default="auto",
                   help="auto | float32 | bfloat16 (auto = per-model "
                        "default)")
    p.add_argument("--input-dtype", default="float32",
                   help="dtype the artifact accepts (bfloat16 halves, int8 "
                        "quarters the input's bytes; the caller quantizes: "
                        "int8 needs --input-scale or --calib)")
    p.add_argument("--input-scale", type=float, default=None,
                   help="int8 input dequant scale (the host quantizes as "
                        "round(x/scale); amax/127 of --calib when omitted)")
    p.add_argument("--no-fold-bn", action="store_true",
                   help="keep MLP's and CNN-2D's input BatchNorm (folded "
                        "into the first layer by default: exact eval-mode "
                        "algebra)")
    p.add_argument("--quant", default="none",
                   choices=["none", "auto", "w8", "w8a8"],
                   help="int8 post-training quantization (core/quantize.py)"
                        "; auto = the model's QUANT_DEFAULTS; w8a8 needs "
                        "--calib")
    p.add_argument("--calib", default=None,
                   help=".npy of calibration inputs (N, *input), split into "
                        "batches of --batch")
    p.add_argument("--calib-stat", default="amax", choices=["amax", "p999"])
    p.add_argument("--platforms", default=",".join(PLATFORMS))
    p.add_argument("--seed", type=int, default=39)
    p.add_argument("--clip-shape", default=None,
                   help="video only: T,H,W of the serving clip (default: "
                        "the model's, runners.video.VIDEO_CLIPS)")
    p.add_argument("--device", default="cuda",
                   help="where the model is built and traced")
    args = p.parse_args(argv)

    if args.model not in CSI_MODELS and args.model not in VIDEO_MODELS:
        raise SystemExit(f"unknown model {args.model}; choices: "
                         f"{sorted(CSI_MODELS) + sorted(VIDEO_MODELS)}")
    cfg = load_config(None, {"model": args.model, "task": args.task})
    batch = resolve_serving_batch(args.model,
                                  args.batch if args.batch > 0 else None)

    if args.model in VIDEO_MODELS:
        # (B, T, H, W, 3) channels-last clips, flat per-user labels
        out_dim = _TASK_DIMS[args.task][1]
        clip = (tuple(int(v) for v in args.clip_shape.split(","))
                if args.clip_shape else VIDEO_CLIPS[args.model])
        shape = (batch, *clip, 3)
        model = build_video_model(args.model, out_dim, clip, seed=args.seed)
        if args.pretrained:
            load_video_pretrained(args.pretrained, args.model, model)
    else:
        out_dim = infer_out_dim(args.model, args.task)
        length = cfg.data.length
        shape = ((batch, length * CSI_CHANNELS)
                 if CSI_MODELS[args.model].input_layout == "flat"
                 else (batch, length, CSI_CHANNELS))
        model = build_model(args.model, args.task, seed=args.seed, cfg=cfg)
        if args.pretrained:
            from ..core.checkpoint import restore_scenario
            restore_scenario(model, args.pretrained, "full",
                             model_key=args.model)

    folded = not args.no_fold_bn and args.model in ("MLP", "CNN-2D")
    if folded:
        model = _fold(args.model, model, out_dim,
                      cfg.data.length * CSI_CHANNELS)
    model = model.to(resolve_device(args.device))

    dtype = resolve_serving_dtype(args.dtype, args.model)
    quant = resolve_quant(args.quant, args.model)
    calib_x = None
    if args.calib:
        rows = np.load(args.calib)
        calib_x = [rows[i:i + batch] for i in range(0, len(rows), batch)]
    elif quant == "w8a8":
        raise SystemExit(f"--quant {args.quant} resolved to w8a8 for "
                         f"{args.model}: pass --calib with real input "
                         "batches to calibrate the activation scales")
    input_scale = args.input_scale
    if args.input_dtype == "int8" and input_scale is None:
        if calib_x is None:
            raise SystemExit("--input-dtype int8 needs --input-scale or "
                             "--calib to derive the dequant scale")
        input_scale = max(float(np.max(np.abs(np.concatenate(
            [np.asarray(b).ravel() for b in calib_x])))), 1e-12) / 127.0
    platforms = args.platforms.split(",")
    blob = export_serving(model, torch.empty(shape), serving_dtype=dtype,
                          input_dtype=args.input_dtype, quant=quant,
                          calib_x=calib_x, calib_stat=args.calib_stat,
                          input_scale=input_scale, platforms=platforms)
    save_artifact(args.out, blob, {
        "model": args.model, "task": args.task, "batch": batch,
        "input_shape": list(shape), "serving_dtype": dtype,
        "input_dtype": args.input_dtype, "quant": quant,
        "input_scale": input_scale, "folded_bn": folded,
        "platforms": platforms, "pretrained": bool(args.pretrained),
    })
    print(f"wrote {args.out}: {args.model}/{args.task} batch={batch} "
          f"dtype={dtype} ({len(blob) / 1e6:.2f} MB; the weights it "
          f"serves {stored_bytes(blob) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
