"""Model inspection CLI (the port of the JAX package's
``cli/inspect_model.py``; the reference's InspectingOutput.ipynb as a
command): restores a component checkpoint of either package
(``core/checkpoint.py::restore_scenario``, scenario ``full``), runs the
model over the configured dataset's test split on the card unless
``--device cpu``, and prints as JSON:

- ``query_bias``: per query, the histogram of its argmax class, and how
  often it predicts "no person" (the last class);
- ``metrics``: ``performance_metrics`` in the model's mode;
- ``viz_stats`` with ``--viz DIR``: the summary of the PNGs that
  ``utils/visualize.py`` writes there (needs matplotlib).

Usage:
  python -m multi_modal_csi_tpu_torch.cli.inspect_model \\
      --checkpoint PT_empty_room_DETR.pt --model DETR [--viz out_dir] \\
      [--config cfg.json] [--set KEY=VALUE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.checkpoint import restore_scenario
from ..core.config import load_config
from ..core.device import resolve_device
from ..metrics.performance import performance_metrics
from ..runners.csi import CSI_MODELS, master_split
from ..train.loop import eval_dataset
from ..utils.results import NumpyJSONEncoder


def query_bias(logits: np.ndarray) -> dict:
    """Per-query argmax-class histogram from (L, B, Q, C) or (B, Q, C)
    logits, and each query's share of "no person" predictions."""
    if logits.ndim == 4:
        logits = logits[-1]
    _, q, c = logits.shape
    idx = logits.argmax(-1)
    hist = {f"query_{i}": np.bincount(idx[:, i], minlength=c).tolist()
            for i in range(q)}
    hist["no_person_rate_per_query"] = [
        float((idx[:, i] == c - 1).mean()) for i in range(q)]
    return hist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="DETR")
    p.add_argument("--task", default="activity")
    p.add_argument("--viz", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-path override")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    overrides = dict(kv.partition("=")[::2] for kv in args.set)
    cfg = load_config(args.config, dict(overrides, model=args.model,
                                        task=args.task))
    device = resolve_device(args.device)
    spec = CSI_MODELS[cfg.model]
    _, x_te, y_tr, y_te = master_split(cfg, spec.target)
    x_te = x_te.reshape(x_te.shape[0], x_te.shape[1], -1)
    out_dim = int(np.asarray(y_tr[0]).shape[-1])
    model = spec.build(x_te.shape[1:], out_dim, cfg,
                       torch.Generator().manual_seed(0))
    restore_scenario(model, args.checkpoint, "full", model_key=cfg.model)
    logits = eval_dataset(model.to(device), x_te,
                          batch_axis=spec.batch_axis)
    report = {
        "query_bias": query_bias(logits),
        "metrics": {k: v for k, v in performance_metrics(
            y_te, logits, var_mode=spec.mode).items()
            if k != "counting_error_perPerson"},
    }
    if args.viz:
        from ..utils.visualize import visualize_model_performance
        report["viz_stats"] = visualize_model_performance(
            logits, y_te, save_dir=args.viz, var_mode=spec.mode)
    print(json.dumps(report, indent=2, cls=NumpyJSONEncoder))
    return report


if __name__ == "__main__":
    main()
