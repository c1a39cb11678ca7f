"""Metric writers: the port's copy of the JAX package's ``utils/logging.py``.

``MetricWriter`` fans one record out to stdout, an optional JSONL file and
an optional W&B run. wandb is imported only when a project is named; where
it is absent or fails, the writer says so once on stderr and carries on
with stdout and JSONL.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch


class MetricWriter:
    """Fan-out writer: stdout (compact), optional JSONL file, optional W&B."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 run_name: Optional[str] = None,
                 config: Optional[dict] = None,
                 verbose: bool = True):
        self.verbose = verbose
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         config=config, reinit=True)
            except Exception as e:  # wandb missing or offline: degrade
                print(f"[metrics] wandb unavailable ({e}); stdout/JSONL only",
                      file=sys.stderr)

    def log(self, metrics: Dict[str, object],
            step: Optional[int] = None) -> None:
        """Write ``{"_time", "step", **metrics}`` with the metrics made
        Python scalars where they are one-element arrays or tensors (a
        CUDA tensor is read once, which waits for the card)."""
        scalars = {k: _scalarize(v) for k, v in metrics.items()}
        record = {"_time": time.time()}
        if step is not None:
            record["step"] = step
        record.update(scalars)
        if self.verbose:
            parts = [f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in record.items() if not k.startswith("_")]
            print(" - ".join(parts))
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(scalars, step=step)

    def finish(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()


def _scalarize(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, torch.Tensor):
        return v.item() if v.numel() == 1 else v
    if hasattr(v, "item") and getattr(v, "size", None) == 1:
        return v.item()
    return v
