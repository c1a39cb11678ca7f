"""The typed configuration tree of the CSI experiment path, copied from the
JAX package's ``core/config.py`` (which the port does not import).

- ``Config``: model, task, repeats, dataset paths, data selection, the
  model and training hyperparameters of the reference preset (reference
  ``wifi_csi/preset.py:8-96``), the label encoding tables, transfer
  learning, and the serving and training dtypes. ``dataclasses.asdict``
  of ``data`` and ``nn`` goes into the result JSON, so their fields are
  the JAX package's, field for field.
- ``override`` (dotted-path overrides), the environment overlay
  (``apply_env_overrides``, the reference's ``config_modifier.py`` knob
  set) and ``load_config`` (defaults < JSON file < environment < CLI).
- the serving dtype and batch with their ``resolve_*`` functions. The JAX
  package's tables differ per model only for video models (MViT serves in
  bf16 at batch 2); every CSI model serves in bf16 at batch 256.
- the int8 serving mode per model (``QUANT_DEFAULTS``, ``resolve_quant``).
- ``MeshConfig``: the device mesh's axes for data-parallel runs
  (``parallel/mesh.py::config_batch_sharding``), with ``mesh.*`` dotted
  overrides.
- the observability fields ``wandb_project``, ``log_jsonl`` and
  ``profile_dir``, as in JAX (``None`` by default), so that a JAX config
  file that sets them loads; the writers themselves are
  ``utils/logging.py::MetricWriter``, which a caller hands to the runner
  (``runners/csi.py::run_csi_model(writer_factory=...)``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

CSI_CHANNELS = 270          # 3 x 3 antenna pairs x 30 subcarriers

CSI_SERVING_DTYPE = "bfloat16"
CSI_SERVING_BATCH = 256

# the video models' serving dtype and batch (JAX core/config.py:261-269,
# :329-336); every other model takes the CSI values above
SERVING_DTYPE_DEFAULTS: Dict[str, str] = {
    "ResNet": "bfloat16",
    "S3D": "bfloat16",
    "Swin-T": "float32",
    "Swin-S": "float32",
    "MViT-v1": "bfloat16",
    "MViT-v2": "bfloat16",
}
SERVING_BATCH_DEFAULTS: Dict[str, int] = {
    "ResNet": 64,
    "S3D": 32,
    "Swin-T": 2,
    "Swin-S": 2,
    "MViT-v1": 2,
    "MViT-v2": 2,
}

# label encoding tables (reference wifi_csi/preset.py:69-90)
ACTIVITY_ENCODING: Dict[str, List[int]] = {
    "nan":      [0, 0, 0, 0, 0, 0, 0, 0, 0],
    "nothing":  [1, 0, 0, 0, 0, 0, 0, 0, 0],
    "walk":     [0, 1, 0, 0, 0, 0, 0, 0, 0],
    "rotation": [0, 0, 1, 0, 0, 0, 0, 0, 0],
    "jump":     [0, 0, 0, 1, 0, 0, 0, 0, 0],
    "wave":     [0, 0, 0, 0, 1, 0, 0, 0, 0],
    "lie_down": [0, 0, 0, 0, 0, 1, 0, 0, 0],
    "pick_up":  [0, 0, 0, 0, 0, 0, 1, 0, 0],
    "sit_down": [0, 0, 0, 0, 0, 0, 0, 1, 0],
    "stand_up": [0, 0, 0, 0, 0, 0, 0, 0, 1],
}

LOCATION_ENCODING: Dict[str, List[int]] = {
    "nan": [0, 0, 0, 0, 0],
    "a":   [1, 0, 0, 0, 0],
    "b":   [0, 1, 0, 0, 0],
    "c":   [0, 0, 1, 0, 0],
    "d":   [0, 0, 0, 1, 0],
    "e":   [0, 0, 0, 0, 1],
}


@dataclass
class PathConfig:
    """Dataset and result locations (reference wifi_csi/preset.py:20-24,
    video/preset.py:19-25)."""
    data_x: str = "dataset/wifi_csi/amp"
    data_y: str = "dataset/annotation.csv"
    save: str = "results/result.json"
    video_x: str = "dataset/video"
    video_pre_x: str = "dataset/cache"
    save_model: Optional[str] = None


@dataclass
class DataConfig:
    """Data selection (reference wifi_csi/preset.py:27-32)."""
    num_users: List[str] = field(
        default_factory=lambda: ["0", "1", "2", "3", "4", "5"])
    wifi_band: List[str] = field(default_factory=lambda: ["5"])
    environment: List[str] = field(default_factory=lambda: ["empty_room"])
    length: int = 3000          # CSI time steps after left-pad
    frame_stride: int = 1       # video frame downsampling (video/preset.py:40)


@dataclass
class SchedulerConfig:
    """Cosine-warmup schedule knobs (reference wifi_csi/preset.py:47-51)."""
    type: str = "cosine_warmup"
    num_warmup_epochs: int = 10
    min_lr_ratio: float = 0.05


@dataclass
class LossConfig:
    """Set-matching loss knobs (reference wifi_csi/preset.py:52-59)."""
    type: str = "HungarianMatchingLoss"
    cost_class_weight: float = 1.0
    aux_loss_weight: float = 0.25
    label_smoothing: float = 0.3
    class_imbalance_weight: float = 0.25


@dataclass
class NNConfig:
    """Model and optimizer hyperparameters (reference
    wifi_csi/preset.py:42-66)."""
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
class MeshConfig:
    """The device mesh's axes: ``data`` ranks split each global batch
    (-1: every rank not on ``model``), ``model`` ranks replicate it (``fit``
    and ``fit_video`` replicate over "model", as JAX's do; the
    tensor-parallel rules are reached through
    ``parallel/partition.py::apply_tensor_parallel`` and
    ``entry.py::dryrun_multichip``), and ``fsdp`` shards the parameters
    and Adam's moments over the data axis (``parallel/partition.py``)."""
    data: int = -1
    model: int = 1
    fsdp: bool = False

    def resolved(self, n_devices: int) -> Dict[str, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        return {"data": data, "model": model}


@dataclass
class Config:
    """Root experiment config."""
    model: str = "DETR"
    task: str = "activity"        # identity | activity | location
    repeat: int = 8
    path: PathConfig = field(default_factory=PathConfig)
    data: DataConfig = field(default_factory=DataConfig)
    # the second band's selection for dual_band (reference
    # run_dualband.py:34-129)
    data_band2: DataConfig = field(default_factory=DataConfig)
    nn: NNConfig = field(default_factory=NNConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    encoding_activity: Dict[str, List[int]] = field(
        default_factory=lambda: dict(ACTIVITY_ENCODING))
    encoding_location: Dict[str, List[int]] = field(
        default_factory=lambda: dict(LOCATION_ENCODING))
    # transfer learning (reference wifi_csi/preset.py:91-95)
    pretrained_path: Optional[str] = None
    transfer_scenario: str = "full"   # full | feature_extractor |
                                      # feature_encoder
    save_model: bool = False
    saving_path: str = "results/"
    # observability
    wandb_project: Optional[str] = None   # None => stdout/JSONL only
    log_jsonl: Optional[str] = None
    profile_dir: Optional[str] = None
    # dtype of the final test-set pass: "float32" (the reference's
    # numerics), "bfloat16", or "auto" (resolve_serving_dtype)
    compute_dtype: str = "float32"
    # dtype of training: "float32" (the reference's) or "bfloat16"
    train_dtype: str = "float32"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def override(self, dotted: Dict[str, Any]) -> "Config":
        """A new Config with dotted-path overrides applied, e.g.
        ``override({"nn.lr": 1e-3, "data.environment": ["classroom"]})``.
        String values are coerced to the type of the value they replace
        (bool, int, float, or a comma-separated list). Unlike the JAX
        package's shallow copy, the original's nested nodes are left as
        they were."""
        cfg = copy.deepcopy(self)
        for key, value in dotted.items():
            node: Any = cfg
            parts = key.split(".")
            for part in parts[:-1]:
                node = getattr(node, part)
            leaf = parts[-1]
            if not hasattr(node, leaf):
                raise KeyError(f"unknown config key: {key}")
            current = getattr(node, leaf)
            if current is not None and not isinstance(current, type(value)) \
                    and not (isinstance(current, float)
                             and isinstance(value, int)):
                if isinstance(current, bool):
                    value = str(value).lower() in ("1", "true", "yes")
                elif isinstance(current, int):
                    value = int(value)
                elif isinstance(current, float):
                    value = float(value)
                elif isinstance(current, list) and isinstance(value, str):
                    value = [v.strip() for v in value.split(",")]
            setattr(node, leaf, value)
        return cfg


# environment overlay: the reference's config_modifier.py:14-46 knob set
_ENV_MAP = {
    "LEARNING_RATE": ("nn.lr", float),
    "BATCH_SIZE": ("nn.batch_size", int),
    "NUM_EPOCHS": ("nn.epoch", int),
    "NUM_DECODER_LAYERS": ("nn.num_decoder_layers", int),
    "DIM_FFN": ("nn.dim_ffn", int),
    "NUM_QUERIES": ("nn.num_obj_queries", int),
    "AUX_LOSS": ("nn.loss.aux_loss_weight", float),
    "CLASS_IMBALANCE_WEIGHT": ("nn.loss.class_imbalance_weight", float),
    "LABEL_SMOOTHING": ("nn.loss.label_smoothing", float),
    "MODEL_TYPE": ("model", str),
}


def apply_env_overrides(cfg: Config,
                        environ: Optional[Dict[str, str]] = None) -> Config:
    """Overlay environment variables (``os.environ`` by default) onto
    ``cfg``."""
    env = dict(os.environ) if environ is None else environ
    overrides: Dict[str, Any] = {}
    for var, (key, cast) in _ENV_MAP.items():
        if var in env:
            overrides[key] = cast(env[var])
    if "DATA_PATH" in env:
        overrides["path.data_x"] = env["DATA_PATH"] + "/wifi_csi/amp"
        overrides["path.data_y"] = env["DATA_PATH"] + "/annotation.csv"
    if "ENVIRONMENTS_EXP" in env:
        overrides["data.environment"] = [
            e.strip() for e in env["ENVIRONMENTS_EXP"].split(",")]
    return cfg.override(overrides) if overrides else cfg


def load_config(path: Optional[str] = None,
                cli_overrides: Optional[Dict[str, Any]] = None,
                use_env: bool = True) -> Config:
    """Config resolution order: defaults < JSON file < env vars < CLI."""
    cfg = Config()
    if path:
        with open(path) as f:
            cfg = cfg.override(_flatten(json.load(f)))
    if use_env:
        cfg = apply_env_overrides(cfg)
    if cli_overrides:
        cfg = cfg.override(cli_overrides)
    return cfg


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts to dotted keys; the encoding tables stay whole."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and not key.endswith(
                ("encoding_activity", "encoding_location")):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = v
    return flat


def resolve_serving_dtype(compute_dtype: str, model_name: str) -> str:
    """"auto" takes the model's serving dtype; "float32" and "bfloat16"
    always win."""
    if compute_dtype not in ("auto", "float32", "bfloat16"):
        raise ValueError("serving dtype must be auto, float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    if compute_dtype != "auto":
        return compute_dtype
    return SERVING_DTYPE_DEFAULTS.get(model_name, CSI_SERVING_DTYPE)


# the int8 serving mode that --quant auto picks per model (JAX
# core/config.py:297-304): full int8 for DETR, THAT_ENCODER and the video
# conv backbones, weight-only for the MLP; every other model unquantized
QUANT_DEFAULTS: Dict[str, Optional[str]] = {
    "DETR": "w8a8",
    "THAT_ENCODER": "w8a8",
    "MLP": "w8",
    "ResNet": "w8a8",
    "S3D": "w8a8",
}
QUANT_CHOICES = ("none", "auto", "w8", "w8a8")


def resolve_quant(quant: Optional[str], model_name: str) -> Optional[str]:
    """--quant for a model as None, "w8" or "w8a8": "auto" takes
    ``QUANT_DEFAULTS`` (None for a model not listed), "none" and None
    disable, "w8" and "w8a8" always win."""
    if quant not in QUANT_CHOICES and quant is not None:
        raise ValueError(f"quant must be one of {QUANT_CHOICES}, got "
                         f"{quant!r}")
    if quant == "auto":
        return QUANT_DEFAULTS.get(model_name)
    if quant in (None, "none"):
        return None
    return quant


def resolve_serving_batch(model_name: str,
                          batch: Optional[int] = None) -> int:
    """The model's serving batch; an explicit positive batch wins."""
    if batch is not None and batch > 0:
        return batch
    return SERVING_BATCH_DEFAULTS.get(model_name, CSI_SERVING_BATCH)
