"""The CSI model table (counterpart of the JAX package's
``runners/csi.py:51-151`` and ``cli/export_model.py:25-43``) for the
ported models.

Each entry builds the model from a ``torch.Generator`` and records what
serving and ``train.loop.fit`` need: the loss, the metrics mode, the
weight decay, the output's batch axis, the target transform and the input
layout, plus the runner's valid/test split and final evaluation, which
wait for the runner's port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.config import CSI_CHANNELS, Config
from ..losses.basic import bce_with_logits, smooth_l1
from ..losses.matching import (HungarianMatchingLoss, count_based_loss,
                               permutation_matching_loss)
from ..models import csi as csi_models

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CSIModelSpec:
    key: str
    # (input shape (length, channels), out_features, config, generator)
    build: Callable[[Tuple[int, int], int, Config, torch.Generator],
                    nn.Module]
    make_loss: Callable[[Config, int], Loss]
    mode: str                      # performance_metrics mode
    target: str = "raw"            # raw | reduce | reduce_pad | reduce_sum
    input_layout: str = "seq"      # (B, length, channels)
    valid_split: bool = False      # THAT/DETR-family 50/50 valid/test split
    weight_decay: float = 0.0
    final_eval: str = "report"     # report | metrics | count_round
    batch_axis: int = 0            # batch axis of the model's OUTPUT


def _hungarian(cfg: Config, out: int) -> Loss:
    return HungarianMatchingLoss(
        cost_class_weight=cfg.nn.loss.cost_class_weight,
        aux_loss_weight=cfg.nn.loss.aux_loss_weight,
        label_smoothing=cfg.nn.loss.label_smoothing,
        class_imbalance_weight=cfg.nn.loss.class_imbalance_weight)


def _trunk(shape):
    return {"length": shape[0], "channels": shape[1]}


CSI_MODELS: Dict[str, CSIModelSpec] = {
    "THAT": CSIModelSpec(
        key="THAT",
        build=lambda xs, out, cfg, g: csi_models.THAT(
            out, generator=g, **_trunk(xs)),
        make_loss=lambda cfg, out: lambda o, t: bce_with_logits(o, t, 4.0),
        mode="baseline", valid_split=True, weight_decay=2e-4,
        final_eval="metrics"),
    "THAT_MULTI_HEAD": CSIModelSpec(
        key="THAT_MULTI_HEAD",
        build=lambda xs, out, cfg, g: csi_models.THATMultiHead(
            out, generator=g, **_trunk(xs)),
        make_loss=lambda cfg, out: permutation_matching_loss,
        mode="multi_head", target="reduce", final_eval="metrics"),
    "THAT_COUNT": CSIModelSpec(
        key="THAT_COUNT",
        build=lambda xs, out, cfg, g: csi_models.THATCount(
            generator=g, **_trunk(xs)),
        make_loss=lambda cfg, out: lambda o, t: smooth_l1(o, t),
        mode="count_classification", valid_split=True,
        final_eval="metrics"),
    "THAT_COUNT_CONSTRAINED": CSIModelSpec(
        key="THAT_COUNT_CONSTRAINED",
        build=lambda xs, out, cfg, g: csi_models.THATCountConstrained(
            generator=g, **_trunk(xs)),
        make_loss=lambda cfg, out: count_based_loss,
        mode="count_classification_withConstrain", target="reduce_sum",
        weight_decay=1e-4, final_eval="metrics"),
    "DETR": CSIModelSpec(
        key="DETR",
        build=lambda xs, out, cfg, g: csi_models.DETRMultiUser(
            token_length=cfg.nn.token_length,
            num_decoder_layers=cfg.nn.num_decoder_layers,
            temp_cross=cfg.nn.cross_attention_temp,
            num_queries=cfg.nn.num_obj_queries,
            dim_feedforward=cfg.nn.dim_ffn,
            generator=g, **_trunk(xs)),
        make_loss=_hungarian, mode="multi_head", target="reduce_pad",
        valid_split=True, weight_decay=2e-4, final_eval="metrics",
        batch_axis=1),
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
    """Build ``model_key`` at the full width of ``cfg.data.length`` windows
    with weights drawn from a generator seeded with ``seed``, in eval mode,
    on the CPU."""
    if model_key not in CSI_MODELS:
        raise KeyError(f"unknown model {model_key!r}; ported: "
                       f"{sorted(CSI_MODELS)}")
    cfg = cfg or Config()
    generator = torch.Generator().manual_seed(seed)
    model = CSI_MODELS[model_key].build(
        (cfg.data.length, CSI_CHANNELS), infer_out_dim(model_key, task),
        cfg, generator)
    return model.eval()
