#!/usr/bin/env python3
"""Time the serving export of the LSTM models in bf16 at full width.

In bf16 the port's LSTM runs its steps as a Python loop
(``nn/layers.py::lstm_steps``), which ``torch.export`` unrolls: 3000 steps
a window for LSTM, twice that for ABLSTM's two directions. For each model
this exports a bf16 artifact of two (3000, 270) windows for ``cuda,cpu``
with ``core/export.py::export_serving``, loads it with ``load_serving``
and answers one batch, and prints the seconds to export and to load, the
artifact's size and the logits' shape. Tracing and serializing are host
work, so the times say what the host's CPU takes; the script names the
host's threads and the device it answered on.

Run it from the repository root, on the CPU or on a machine with a card:

    python3 probes/lstm_export.py [--device cpu] [--models LSTM,ABLSTM]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from multi_modal_csi_tpu_torch.core.export import (  # noqa: E402
    export_serving, load_serving)
from multi_modal_csi_tpu_torch.runners.csi import build_model  # noqa: E402

WINDOWS, LENGTH, CHANNELS = 2, 3000, 270


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--models", default="LSTM,ABLSTM")
    args = p.parse_args(argv)
    x = np.random.default_rng(0).standard_normal(
        (WINDOWS, LENGTH, CHANNELS), dtype=np.float32)
    for key in args.models.split(","):
        model = build_model(key, seed=0).to(args.device)
        start = time.perf_counter()
        blob = export_serving(model, x, serving_dtype="bfloat16",
                              platforms=("cuda", "cpu"))
        exported = time.perf_counter() - start
        start = time.perf_counter()
        fn = load_serving(blob, args.device)
        loaded = time.perf_counter() - start
        out = fn(x)
        print(f"{key} bf16, ({WINDOWS}, {LENGTH}, {CHANNELS}) windows: "
              f"export {exported:.1f} s, {len(blob) / 1e6:.1f} MB, load "
              f"{loaded:.1f} s; logits {tuple(out.shape)} on "
              f"{out.device}; host threads {torch.get_num_threads()}")


if __name__ == "__main__":
    main()
