"""CSI experiment CLI (the reference's run_main.py surface; the port of the
JAX package's ``cli/run_csi.py``).

Usage:
  python -m multi_modal_csi_tpu_torch.cli.run_csi --model DETR \\
      --task activity --repeat 8 --users "0,1,2,3,4,5" \\
      [--config cfg.json] [--set nn.lr=1e-4 --set data.wifi_band=5] \\
      [--device cuda|cpu]

``--model`` takes every CSI key of the JAX package: MLP, CNN-1D, CNN-2D,
LSTM, CLSTM, ABLSTM, the THAT family, THAT_ENCODER, DETR, SSL, dual_band
(band 2 selected by ``--set data_band2.wifi_band=2.4`` and the like) and
ST-RF (where sklearn is installed). ``--set pretrained_path=F --set
transfer_scenario=feature_encoder`` restores a component file for
transfer learning; ``--set save_model=true`` saves each repeat's best
weights under ``saving_path``. The environment overlay (LEARNING_RATE,
BATCH_SIZE, ... DATA_PATH, ENVIRONMENTS_EXP: the reference's
config_modifier.py knob set) applies automatically; ``--set`` takes any
dotted-path override. The run reads
``path.data_y`` (annotation.csv) and the amplitude cache ``path.data_x``,
trains on the card unless ``--device cpu``, and writes the result JSON to
``path.save``. The JAX CLI's ``--mesh`` and ``--distributed`` wait for the
parallel layer (ROADMAP item 14).
"""

from __future__ import annotations

import argparse

from ..core.config import load_config
from ..runners.csi import run_experiment


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default=None)
    p.add_argument("--task", default=None)
    p.add_argument("--repeat", default=None, type=int)
    p.add_argument("--users", default=None,
                   help="comma-separated user counts, e.g. '0,1,2,3,4,5'")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted-path override")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    overrides = {}
    for kv in args.set:
        key, _, value = kv.partition("=")
        overrides[key] = value
    if args.model:
        overrides["model"] = args.model
    if args.task:
        overrides["task"] = args.task
    if args.repeat is not None:
        overrides["repeat"] = args.repeat
    if args.users:
        overrides["data.num_users"] = [u.strip()
                                       for u in args.users.split(",")]
    cfg = load_config(args.config, overrides)
    result = run_experiment(cfg, device=args.device)
    print(result)
    return result


if __name__ == "__main__":
    main()
