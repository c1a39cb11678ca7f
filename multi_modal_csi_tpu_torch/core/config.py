"""Configuration the CSI serving and training code needs, copied from the
JAX package's ``core/config.py`` (which the port does not import).

- ``NNConfig``: the model and training hyperparameters of the reference
  preset (reference ``wifi_csi/preset.py:42-66``), with the cosine-warmup
  schedule's and the set-matching loss's knobs;
- ``DataConfig.length``: CSI time steps per window after left-padding;
- the serving dtype and batch with their ``resolve_*`` functions. The JAX
  package's tables differ per model only for video models, which arrive with
  the video slice; every CSI model serves in bf16 at batch 256.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

CSI_CHANNELS = 270          # 3 x 3 antenna pairs x 30 subcarriers

CSI_SERVING_DTYPE = "bfloat16"
CSI_SERVING_BATCH = 256


@dataclass
class DataConfig:
    length: int = 3000      # CSI time steps after left-pad


@dataclass
class SchedulerConfig:
    """Cosine-warmup schedule knobs (reference wifi_csi/preset.py:47-51)."""
    num_warmup_epochs: int = 10
    min_lr_ratio: float = 0.05


@dataclass
class LossConfig:
    """Set-matching loss knobs (reference wifi_csi/preset.py:52-59)."""
    cost_class_weight: float = 1.0
    aux_loss_weight: float = 0.25
    label_smoothing: float = 0.3
    class_imbalance_weight: float = 0.25


@dataclass
class NNConfig:
    lr: float = 5e-4
    epoch: int = 300
    batch_size: int = 16
    threshold: float = 0.5
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    cross_attention_temp: float = 2.0
    weight_decay: float = 2e-4
    num_obj_queries: int = 5
    num_decoder_layers: int = 6
    dim_ffn: int = 512
    token_length: int = 10
    patience: int = 150


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    nn: NNConfig = field(default_factory=NNConfig)


def resolve_serving_dtype(compute_dtype: str, model_name: str) -> str:
    """"auto" takes the model's serving dtype; "float32" and "bfloat16"
    always win."""
    if compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError("serving dtype must be auto, float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    return CSI_SERVING_DTYPE if compute_dtype == "auto" else compute_dtype


def resolve_serving_batch(model_name: str,
                          batch: Optional[int] = None) -> int:
    """The model's serving batch; an explicit positive batch wins."""
    if batch is not None and batch > 0:
        return batch
    return CSI_SERVING_BATCH
