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

``--mesh`` trains data-parallel over the config's mesh (``mesh.data``,
``mesh.model``, ``mesh.fsdp`` by ``--set``), one process a device;
``--distributed`` joins the process group that ``torchrun`` describes
(NCCL on the card, gloo with ``--device cpu``)::

  torchrun --nproc-per-node 2 -m multi_modal_csi_tpu_torch.cli.run_video \
      --distributed --mesh --model ResNet ... --device cpu

Only rank 0 prints the result and writes ``path.save``.
"""

from __future__ import annotations

import argparse
import json
import os

from ..core.config import load_config
from ..parallel.mesh import initialize_distributed, is_main_process
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
                   help="shard batches over the device mesh (data "
                        "parallel; cfg.mesh.fsdp adds FSDP)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes before "
                        "anything runs (parallel/mesh.py::"
                        "initialize_distributed)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.distributed:
        initialize_distributed(device=args.device)
    overrides = {"model": args.model, "task": args.task,
                 "nn.lr": 1e-4, "nn.epoch": 20, "nn.batch_size": 8,
                 "repeat": args.repeat if args.repeat is not None else 10}
    for kv in args.set:
        key, _, value = kv.partition("=")
        overrides[key] = value
    cfg = load_config(args.config, overrides)
    result = run_video_model(cfg, use_mesh=args.mesh, device=args.device)
    result["model"] = cfg.model
    result["task"] = cfg.task
    if not is_main_process():
        return result
    if cfg.path.save:
        os.makedirs(os.path.dirname(cfg.path.save) or ".", exist_ok=True)
        with open(cfg.path.save, "w") as f:
            json.dump(result, f, indent=4, cls=NumpyJSONEncoder)
    print(result)
    return result


if __name__ == "__main__":
    main()
