"""The video runner's serving half (counterpart of the JAX package's
``runners/video.py``): the video model table, the dataset selection,
streaming evaluation and torchvision checkpoints.

- ``VIDEO_MODELS``: MViT-v1 and MViT-v2 are ported; ResNet, S3D, Swin-T
  and Swin-S raise NotImplementedError (ROADMAP item 12);
- ``load_video_data``: the annotation filter (environment and
  number_of_users), the seeded 80/20 split (seed 39, reference
  ``video/run.py:56-59``) and lazy ``ClipDataset``s over the clip cache;
- ``evaluate``: the JAX ``_evaluate`` (``:86-123``), every sample scored
  through ``prefetch_batches`` in fixed chunks, the tail chunk zero-padded
  and the padding cut from the logits, the input cast to the serving dtype;
- ``load_video_pretrained``: a torchvision-layout ``.pt``/``.pth``
  checkpoint into a live model, its tables resized to the model's clip.

Training (``fit_video``, ``run_video_model``) comes with the MViT flash
backward in slice 5 of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import Config
from ..core.weights import resize_mvit_tables
from ..data.annotation import filter_annotation, label_list, load_annotation
from ..data.encoders import encode_labels
from ..data.pipeline import pad_to
from ..data.splits import train_test_split
from ..data.video_io import ClipDataset, prefetch_batches
from ..metrics.classification import accuracy_score
from ..models import video as video_models

THW = Tuple[int, int, int]
# (out_features, clip (T, H, W), generator) -> model
Builder = Callable[[int, THW, torch.Generator], nn.Module]

# the serving clip: a 90-frame WiMANS clip at frame stride 2, 224 x 224
VIDEO_CLIP: THW = (45, 224, 224)
VIDEO_SPLIT_SEED = 39            # reference video/run.py:59

VIDEO_MODELS: Dict[str, Builder] = {
    "MViT-v1": lambda out, clip, g: video_models.mvit_v1_b(
        out, clip, generator=g),
    "MViT-v2": lambda out, clip, g: video_models.mvit_v2_s(
        out, clip, generator=g),
}
# the JAX package's other video backbones, still to port (ROADMAP item 12)
UNPORTED_VIDEO_MODELS = ("ResNet", "S3D", "Swin-T", "Swin-S")
_MVIT_VARIANT = {"MViT-v1": "v1", "MViT-v2": "v2"}
# flat label width per task: six users' presence bits or one-hots
TASK_OUT_FEATURES = {"identity": 6, "activity": 6 * 9, "location": 6 * 5}


def video_spec(model_key: str) -> Builder:
    """The builder of a ported video model; NotImplementedError for the
    backbones still to port, KeyError for unknown keys."""
    if model_key in UNPORTED_VIDEO_MODELS:
        raise NotImplementedError(
            f"{model_key} is not ported to PyTorch yet (ROADMAP item 12); "
            f"ported: {sorted(VIDEO_MODELS)}")
    if model_key not in VIDEO_MODELS:
        raise KeyError(f"unknown video model {model_key!r}; ported: "
                       f"{sorted(VIDEO_MODELS)}")
    return VIDEO_MODELS[model_key]


def build_video_model(model_key: str, out_features: int,
                      clip: THW = VIDEO_CLIP, *, seed: int = 0) -> nn.Module:
    """``model_key`` for clips of ``clip`` = (T, H, W) frames, with
    weights drawn from a generator seeded with ``seed``, in eval mode, on
    the CPU."""
    generator = torch.Generator().manual_seed(seed)
    return video_spec(model_key)(out_features, tuple(clip), generator).eval()


def load_video_data(cfg: Config) -> Tuple[ClipDataset, ClipDataset]:
    """Lazy training and test ClipDatasets over ``cfg.path.video_pre_x``:
    the annotation filtered by environment and number of users, split
    80/20 with seed 39 as sklearn's ``train_test_split`` splits it."""
    df = load_annotation(cfg.path.data_y)
    df = filter_annotation(df, environment=cfg.data.environment,
                           num_users=cfg.data.num_users)
    rows = np.arange(len(df))
    train_rows, test_rows, _, _ = train_test_split(rows, rows, 0.2,
                                                   VIDEO_SPLIT_SEED)
    out = []
    for part in (df.take(train_rows), df.take(test_rows)):
        y = encode_labels(part, cfg.task, cfg.encoding_activity,
                          cfg.encoding_location)
        out.append(ClipDataset(cfg.path.video_pre_x, label_list(part),
                               y.reshape(y.shape[0], -1),
                               cfg.data.frame_stride))
    return out[0], out[1]


def _eval_rows(n: int, chunk: int) -> Sequence[np.ndarray]:
    return [np.arange(s, min(s + chunk, n)) for s in range(0, n, chunk)]


@torch.no_grad()
def evaluate(model: nn.Module, dataset, threshold: float, *,
             chunk: int = 16, num_workers: int = 4,
             dtype: Optional[torch.dtype] = None
             ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(subset accuracy, 0/1 predictions, f32 logits) of ``model`` over
    every sample of ``dataset`` (a ClipDataset or ArrayClips).

    The model runs in eval mode on its own device, already cast for
    serving (``train.loop.cast_for_serving``) when ``dtype`` is given;
    each chunk of clips is cast to ``dtype`` on the way in.
    """
    model.eval()
    device = next(model.parameters()).device
    n = len(dataset)
    chunk = min(chunk, max(1, n))
    outs = []
    for bx, _ in prefetch_batches(dataset, _eval_rows(n, chunk),
                                  num_workers=num_workers):
        size = bx.shape[0]
        x = torch.from_numpy(pad_to(bx, chunk)).to(device)
        if dtype is not None:
            x = x.to(dtype)
        outs.append(model(x).float()[:size].cpu().numpy())
    logits = np.concatenate(outs, axis=0)
    pred = (1 / (1 + np.exp(-logits)) > threshold).astype(int)
    acc = accuracy_score(dataset.y.astype(int),
                         pred.reshape(-1, dataset.y.shape[-1]))
    return acc, pred, logits


def _task_head(out_features: int, in_features: int = 400
               ) -> Dict[str, torch.Tensor]:
    """The fresh Linear(400 -> out) task head that the JAX package puts on
    a converted torchvision backbone (``tools/convert_torchvision.py::
    _task_head``): uniform(+-1/sqrt(400)) from ``default_rng(0)``, the
    (in, out) kernel first, then the bias."""
    rng = np.random.default_rng(0)
    bound = 1.0 / np.sqrt(in_features)
    kernel = rng.uniform(-bound, bound, (in_features, out_features))
    bias = rng.uniform(-bound, bound, (out_features,))
    return {"weight": torch.from_numpy(kernel.T.astype(np.float32)),
            "bias": torch.from_numpy(bias.astype(np.float32))}


def load_video_pretrained(path: str, model_key: str,
                          model: nn.Module) -> nn.Module:
    """Load a torchvision-layout MViT checkpoint (``.pt``/``.pth``: a
    state dict, a module's, or a dict with ``model_state_dict``) into
    ``model``, a port MViT of ``model_key``: the tables resized to the
    model's clip (``core.weights.resize_mvit_tables``), the backbone
    shape-checked against the live model and loaded strictly, and a fresh
    task head drawn as the JAX package draws it. Returns ``model``."""
    video_spec(model_key)          # every ported video model is an MViT
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"a torchvision checkpoint is a .pt or .pth file, "
                         f"got {path!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    backbone = model.backbone
    live = backbone.state_dict()
    if set(ckpt) == set(live):
        ckpt = resize_mvit_tables(ckpt, _MVIT_VARIANT[model_key],
                                  backbone.clip)
    shapes = {k: tuple(v.shape) for k, v in ckpt.items()}
    want = {k: tuple(v.shape) for k, v in live.items()}
    if shapes != want:
        diff = sorted(set(shapes.items()) ^ set(want.items()))[:6]
        raise ValueError(
            f"pretrained tree for {model_key} does not match the model "
            f"(wrong arch, head width, or clip size?): {diff}")
    backbone.load_state_dict(ckpt, strict=True)
    head = model.task_head
    head.load_state_dict(_task_head(*head.weight.shape))
    return model
