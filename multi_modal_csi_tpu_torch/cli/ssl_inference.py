"""SSL inference-only evaluation (the port of the JAX package's
``cli/ssl_inference.py``; reference ``inference_only.py:11-90``).

Restores an SSL checkpoint through ``core/checkpoint.py::restore_scenario``
(scenario ``full``, model key ``SSL``), so it takes the port's ``.pt``, the
reference's own ``.pt`` (with its ``model_state_dict`` wrapper and
``_orig_mod.`` prefixes) or the JAX package's ``.msgpack``, and scores the
online head on the whole test split: subset accuracy and the
classification report, printed as JSON.

Usage:
  python -m multi_modal_csi_tpu_torch.cli.ssl_inference \\
      --checkpoint ssl.pt [--task activity] [--config cfg.json] \\
      [--set path.data_x=AMP] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from ..core.checkpoint import restore_scenario
from ..core.config import load_config
from ..core.device import resolve_device
from ..metrics.classification import (accuracy_score, classification_report,
                                      predict_labels)
from ..runners.csi import _layout, master_split
from ..runners.ssl import build_ssl
from ..train.loop import eval_dataset
from ..utils.results import NumpyJSONEncoder


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--task", default="activity")
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-path override")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    overrides = dict(kv.partition("=")[::2] for kv in args.set)
    cfg = load_config(args.config, dict(overrides, model="SSL",
                                        task=args.task))
    device = resolve_device(args.device)
    _, x_te, _, y_te = master_split(cfg, "raw")
    x_te = _layout(x_te, "seq")
    y_flat = y_te.reshape(y_te.shape[0], -1).astype(int)
    model = restore_scenario(build_ssl(y_flat.shape[-1], 0, x_te.shape[-1]),
                             args.checkpoint, "full", model_key="SSL")
    logits = eval_dataset(model.to(device), x_te)
    pred = predict_labels(logits, cfg.nn.threshold)
    out = {"accuracy": accuracy_score(y_flat, pred),
           "report": classification_report(y_flat, pred)}
    print(json.dumps(out, indent=2, cls=NumpyJSONEncoder))
    return out


if __name__ == "__main__":
    main()
