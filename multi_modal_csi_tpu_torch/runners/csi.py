"""The CSI model table, as far as serving needs it (counterpart of the JAX
package's ``runners/csi.py:51-151`` and ``cli/export_model.py:25-43``).

Each entry builds the model in eval mode from a ``torch.Generator``, and
records the batch axis of its output and its input layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import CSI_CHANNELS, Config
from ..models import csi as csi_models


@dataclasses.dataclass(frozen=True)
class CSIModelSpec:
    key: str
    # (input shape (length, channels), out_features, config, generator)
    build: Callable[[Tuple[int, int], int, Config, torch.Generator],
                    nn.Module]
    target: str = "raw"            # raw | reduce | reduce_pad | reduce_sum
    input_layout: str = "seq"      # (B, length, channels)
    batch_axis: int = 0            # batch axis of the model's OUTPUT


def _trunk(shape):
    return {"length": shape[0], "channels": shape[1]}


CSI_MODELS: Dict[str, CSIModelSpec] = {
    "THAT": CSIModelSpec(
        key="THAT",
        build=lambda xs, out, cfg, g: csi_models.THAT(
            out, generator=g, **_trunk(xs))),
    "THAT_MULTI_HEAD": CSIModelSpec(
        key="THAT_MULTI_HEAD",
        build=lambda xs, out, cfg, g: csi_models.THATMultiHead(
            out, generator=g, **_trunk(xs)),
        target="reduce"),
    "THAT_COUNT": CSIModelSpec(
        key="THAT_COUNT",
        build=lambda xs, out, cfg, g: csi_models.THATCount(
            generator=g, **_trunk(xs))),
    "THAT_COUNT_CONSTRAINED": CSIModelSpec(
        key="THAT_COUNT_CONSTRAINED",
        build=lambda xs, out, cfg, g: csi_models.THATCountConstrained(
            generator=g, **_trunk(xs)),
        target="reduce_sum"),
    "DETR": CSIModelSpec(
        key="DETR",
        build=lambda xs, out, cfg, g: csi_models.DETRMultiUser(
            token_length=cfg.nn.token_length,
            num_decoder_layers=cfg.nn.num_decoder_layers,
            temp_cross=cfg.nn.cross_attention_temp,
            num_queries=cfg.nn.num_obj_queries,
            dim_feedforward=cfg.nn.dim_ffn,
            generator=g, **_trunk(xs)),
        target="reduce_pad", batch_axis=1),
}

# task -> (per-user class count, flat out_dim, reduced out_dim)
_TASK_DIMS = {
    "activity": (9, 6 * 9, 10),
    "identity": (6, 6, None),
    "location": (5, 6 * 5, None),
}


def infer_out_dim(model_key: str, task: str) -> int:
    """The out_features the runner derives from the encoded labels: raw
    targets flatten the per-user one-hots, reduced targets use the
    10-class query rows."""
    spec = CSI_MODELS[model_key]
    _, flat, reduced = _TASK_DIMS[task]
    if spec.target.startswith("reduce"):
        if reduced is None:
            raise ValueError(f"{model_key} supports task=activity only")
        return reduced
    return flat


def build_model(model_key: str, task: str = "activity", *, seed: int = 0,
                cfg: Optional[Config] = None) -> nn.Module:
    """Build ``model_key`` at the full serving width with weights drawn from
    a generator seeded with ``seed``, in eval mode, on the CPU."""
    if model_key not in CSI_MODELS:
        raise KeyError(f"unknown model {model_key!r}; ported: "
                       f"{sorted(CSI_MODELS)}")
    cfg = cfg or Config()
    generator = torch.Generator().manual_seed(seed)
    model = CSI_MODELS[model_key].build(
        (cfg.data.length, CSI_CHANNELS), infer_out_dim(model_key, task),
        cfg, generator)
    return model.eval()
