"""Video experiment CLI (the reference's benchmark/video/run.py surface; the
port of the JAX package's ``cli/run_video.py``).

Usage:
  python -m multi_modal_csi_tpu_torch.cli.run_video --model Swin-T \\
      --task identity [--repeat 10] [--config cfg.json] \\
      --set path.video_pre_x=CACHE --set path.data_y=annotation.csv \\
      [--set path.save=out.json] [--device cuda|cpu]

The JAX CLI's overrides apply (lr 1e-4, 20 epochs, batch 8, repeat 10),
then ``--set`` takes any dotted-path override. The run reads
``path.data_y`` (annotation.csv) and the cached ``.npy`` clips of
``path.video_pre_x``, trains on the card unless ``--device cpu``, prints
the result and writes it as JSON to ``path.save``. ``--model`` is any of
the six video backbones; the default is Swin-T, as the JAX CLI's.
``--mesh`` and ``--distributed`` wait for the parallel layer (ROADMAP item
14).
"""

from __future__ import annotations

import argparse
import json
import os

from ..core.config import load_config
from ..runners.video import run_video_model
from ..utils.results import NumpyJSONEncoder


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="Swin-T")
    p.add_argument("--task", default="identity")
    p.add_argument("--repeat", default=None, type=int)
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-path override")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over a device mesh (not ported)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host initialisation (not ported)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mesh or args.distributed:
        raise NotImplementedError("--mesh and --distributed (data-parallel "
                                  "and multi-host runs) are not ported yet "
                                  "(ROADMAP item 14)")
    overrides = {"model": args.model, "task": args.task,
                 "nn.lr": 1e-4, "nn.epoch": 20, "nn.batch_size": 8,
                 "repeat": args.repeat if args.repeat is not None else 10}
    for kv in args.set:
        key, _, value = kv.partition("=")
        overrides[key] = value
    cfg = load_config(args.config, overrides)
    result = run_video_model(cfg, device=args.device)
    result["model"] = cfg.model
    result["task"] = cfg.task
    if cfg.path.save:
        os.makedirs(os.path.dirname(cfg.path.save) or ".", exist_ok=True)
        with open(cfg.path.save, "w") as f:
            json.dump(result, f, indent=4, cls=NumpyJSONEncoder)
    print(result)
    return result


if __name__ == "__main__":
    main()
