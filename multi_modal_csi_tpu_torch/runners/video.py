"""The video runner (counterpart of the JAX package's ``runners/video.py``):
the video model table, the dataset selection, streaming evaluation,
torchvision checkpoints, and training as the reference's video engine
trains (reference ``video/run.py:37-99``, ``video/train.py:19-176``).

- ``VIDEO_MODELS``: the JAX package's six video backbones (ResNet, S3D,
  MViT-v1, MViT-v2, Swin-T, Swin-S), and ``VIDEO_CLIPS``, the clip each
  serves (JAX's ``cli/export_model.py`` shapes: ResNet (45, 112, 112),
  the rest (45, 224, 224));
- ``load_video_data``: the annotation filter (environment and
  number_of_users), the seeded 80/20 split (seed 39, reference
  ``video/run.py:56-59``) and lazy ``ClipDataset``s over the clip cache;
- ``evaluate``: the JAX ``_evaluate`` (``:86-123``), every sample scored
  through ``prefetch_batches`` in fixed chunks, the tail chunk zero-padded
  and the padding cut from the logits, the input cast to the serving dtype;
- ``load_video_pretrained``: a torchvision-layout ``.pt``/``.pth``
  checkpoint into a live model (MViT's tables resized to the model's
  clip; Swin's bias tables never are);
- ``fit_video``: the JAX ``fit_video`` (``:126-262``): Adam, BCE with
  logits, no augmentation, ``n // batch_size`` full batches an epoch, then
  a full evaluation of the training and the test set; the best weights
  by test subset accuracy alone, starting from the initial weights;
- ``run_video_model``: the JAX ``run_video_model`` (``:323-407``):
  ``cfg.repeat`` runs seeded r + 39, each trained by ``fit_video`` and
  scored on the test set in the serving dtype, and the result dict.

``cfg.path.save_model`` is the JAX runner's warm start and save: each
repeat starts from that component file when it exists (fresh weights when
it does not) and saves its best weights there, so a repeat warm-starts
from the one before. The port writes a torch state dict
(``core/checkpoint.py``); the JAX runner's warm start reads only its own
msgpack.

Data parallelism (JAX's ``sharding`` and ``fsdp``): ``fit_video`` and
``evaluate`` take a ``parallel.mesh.BatchSharding``, and
``run_video_model(use_mesh=True)`` the config's mesh. Each rank loads and
trains on its rows of every global batch (``train/loop.py``'s step: the
gradients averaged over the ranks, BatchNorm's statistics and the draws
the global batch's), and evaluation splits each chunk, padded to a
multiple of the data axis, over the ranks and gathers the logits.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import (is_torch_file, restore_scenario,
                               save_components)
from ..core.config import Config, resolve_serving_dtype
from ..core.device import resolve_device
from ..core.weights import resize_mvit_tables
from ..data.annotation import filter_annotation, label_list, load_annotation
from ..data.encoders import encode_labels
from ..data.pipeline import epoch_batches
from ..data.splits import train_test_split
from ..data.video_io import ArrayClips, ClipDataset, prefetch_batches
from ..losses.basic import bce_with_logits
from ..metrics.classification import accuracy_score, classification_report
from ..models import video as video_models
from ..parallel.collectives import axis_scope, pmean
from ..parallel.mesh import (BatchSharding, barrier, config_batch_sharding,
                             is_main_process, shard_batch)
from ..train.loop import (TRAIN_DTYPES, StateDict, adam_like_torch,
                          cast_for_serving, cast_parameters, data_parallel,
                          eval_chunk, forward_chunk, make_train_step,
                          state_snapshot)
from ..utils.complexity import complexity_report

THW = Tuple[int, int, int]
# (out_features, clip (T, H, W), generator) -> model
Builder = Callable[[int, THW, torch.Generator], nn.Module]

# the serving clip: a 90-frame WiMANS clip at frame stride 2, 224 x 224
VIDEO_CLIP: THW = (45, 224, 224)
VIDEO_SPLIT_SEED = 39            # reference video/run.py:59

VIDEO_MODELS: Dict[str, Builder] = {
    "ResNet": lambda out, clip, g: video_models.ResNet3D18(
        out, clip, generator=g),
    "S3D": lambda out, clip, g: video_models.S3D(out, clip, generator=g),
    "MViT-v1": lambda out, clip, g: video_models.mvit_v1_b(
        out, clip, generator=g),
    "MViT-v2": lambda out, clip, g: video_models.mvit_v2_s(
        out, clip, generator=g),
    "Swin-T": lambda out, clip, g: video_models.swin3d_t(
        out, clip, generator=g),
    "Swin-S": lambda out, clip, g: video_models.swin3d_s(
        out, clip, generator=g),
}
# the clip each model serves: 90 WiMANS frames at stride 2, at its
# torchvision transform's crop (data/video_io.py::VIDEO_TRANSFORMS)
VIDEO_CLIPS: Dict[str, THW] = {key: VIDEO_CLIP for key in VIDEO_MODELS}
VIDEO_CLIPS["ResNet"] = (45, 112, 112)
_MVIT_VARIANT = {"MViT-v1": "v1", "MViT-v2": "v2"}
# torchvision's buffers that the port computes instead of loading
_TORCHVISION_BUFFERS = ("num_batches_tracked", "relative_position_index")
# flat label width per task: six users' presence bits or one-hots
TASK_OUT_FEATURES = {"identity": 6, "activity": 6 * 9, "location": 6 * 5}


def video_spec(model_key: str) -> Builder:
    """The builder of a video model; KeyError for unknown keys."""
    if model_key not in VIDEO_MODELS:
        raise KeyError(f"unknown video model {model_key!r}; have: "
                       f"{sorted(VIDEO_MODELS)}")
    return VIDEO_MODELS[model_key]


def build_video_model(model_key: str, out_features: int,
                      clip: Optional[THW] = None, *,
                      seed: int = 0) -> nn.Module:
    """``model_key`` for clips of ``clip`` = (T, H, W) frames (the model's
    serving clip, ``VIDEO_CLIPS``, by default), with weights drawn from a
    generator seeded with ``seed``, in eval mode, on the CPU."""
    builder = video_spec(model_key)
    generator = torch.Generator().manual_seed(seed)
    clip = VIDEO_CLIPS[model_key] if clip is None else tuple(clip)
    return builder(out_features, clip, generator).eval()


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
             dtype: Optional[torch.dtype] = None,
             sharding: Optional[BatchSharding] = None
             ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(subset accuracy, 0/1 predictions, f32 logits) of ``model`` over
    every sample of ``dataset`` (a ClipDataset or ArrayClips).

    The model runs in eval mode on its own device, already cast for
    serving (``train.loop.cast_for_serving``) when ``dtype`` is given;
    each chunk of clips is cast to ``dtype`` on the way in. With
    ``sharding`` each rank loads every chunk, padded to the data axis,
    and runs its rows of it (``train/loop.py::eval_chunk``,
    ``forward_chunk``), so every rank returns the same result.
    """
    model.eval()
    n = len(dataset)
    chunk = eval_chunk(n, chunk, sharding)
    logits = np.concatenate(
        [forward_chunk(model, bx, chunk, dtype=dtype, sharding=sharding)
         for bx, _ in prefetch_batches(dataset, _eval_rows(n, chunk),
                                       num_workers=num_workers)], axis=0)
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
    """Load ``path`` into ``model``, a port video model of ``model_key``,
    and return it. A component file (the whole model, as
    ``path.save_model`` holds it: the port's ``.pt`` or the JAX package's
    ``.msgpack``) loads as it is. A torchvision-layout checkpoint
    (``.pt``/``.pth``: a state dict, or a dict with ``model_state_dict``)
    loads into the backbone: torchvision's ``num_batches_tracked`` and
    ``relative_position_index`` buffers dropped, S3D's 1x1x1 classifier
    conv as its Linear, MViT's tables resized to the model's clip
    (``core.weights.resize_mvit_tables``; Swin's bias tables are never
    resized), shape-checked against the live model and loaded strictly,
    with a fresh task head drawn as the JAX package draws it."""
    video_spec(model_key)
    if not is_torch_file(path):    # a JAX component file
        return restore_scenario(model, path, "full", model_key)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    if set(ckpt) == set(model.state_dict()):
        return restore_scenario(model, path, "full", model_key)
    ckpt = {k: v for k, v in ckpt.items()
            if not k.endswith(_TORCHVISION_BUFFERS)}
    backbone = model.backbone
    live = backbone.state_dict()
    if model_key == "S3D" and "classifier.1.weight" in ckpt:
        w = ckpt["classifier.1.weight"]
        ckpt["classifier.1.weight"] = w.reshape(w.shape[0], -1)
    if model_key in _MVIT_VARIANT and set(ckpt) == set(live):
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


def fit_video(model: nn.Module, train_ds, test_ds, *, lr: float,
              epochs: int, batch_size: int, seed: int, threshold: float,
              verbose: bool = True, num_workers: int = 4,
              train_dtype: Optional[Union[str, torch.dtype]] = None,
              sharding: Any = None, fsdp: bool = False,
              history: Optional[List[Dict[str, float]]] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Tuple[StateDict, float]:
    """Train ``model`` (moved to ``device``, the card by default) on
    ``train_ds`` (a ClipDataset or ArrayClips) and return (the best
    weights as a CPU state dict, the best test accuracy).

    Each epoch shuffles with ``np.random.default_rng(seed)`` and trains
    ``n // batch_size`` full batches (Adam at ``lr``, BCE with logits, no
    augmentation), then scores the whole training and test sets in chunks
    of ``batch_size``. The best weights start as the initial ones and are
    replaced only by a strictly higher test accuracy. ``history``, if
    given, receives one record an epoch: the last batch's loss and both
    accuracies. ``train_dtype="bfloat16"`` keeps the parameters and Adam's
    moments in bf16, casts each batch and evaluates in bf16.

    ``sharding`` (every rank calls alike) trains data-parallel: each rank
    loads its rows of every global batch of ``batch_size``, which the data
    axis must divide, and ``fsdp`` shards the parameters and Adam's
    moments over it (``train/loop.py``); evaluation is split over the
    ranks, and only rank 0 prints."""
    if train_dtype not in TRAIN_DTYPES:
        raise ValueError(f"unsupported train_dtype {train_dtype!r}")
    batch_dtype = TRAIN_DTYPES[train_dtype]
    device = resolve_device(device)
    np_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    if sharding is not None:
        sharding.rows(batch_size)               # the batch must split
    model.to(device)
    cast_parameters(model, batch_dtype)
    data_parallel(model, sharding, fsdp)
    step = make_train_step(model, adam_like_torch(model.parameters(), lr),
                           bce_with_logits, augment=False,
                           batch_dtype=batch_dtype, sharding=sharding,
                           fsdp=fsdp)

    best_acc = 0.0
    best = state_snapshot(model)
    n = len(train_ds)
    for epoch in range(epochs):
        t0 = time.time()
        loss = torch.zeros((), device=device)
        idx = shard_batch(sharding, epoch_batches(n, batch_size, np_rng,
                                                  skip_last=False), axis=1)
        for bx, by in prefetch_batches(train_ds, idx,
                                       num_workers=num_workers):
            loss, _ = step(torch.from_numpy(bx).to(device),
                           torch.from_numpy(by).to(device), generator)
        with axis_scope(None if sharding is None else sharding.mesh):
            loss = pmean(loss)         # the global batch's
        train_acc, _, _ = evaluate(model, train_ds, threshold,
                                   chunk=batch_size, num_workers=num_workers,
                                   dtype=batch_dtype, sharding=sharding)
        test_acc, _, _ = evaluate(model, test_ds, threshold,
                                  chunk=batch_size, num_workers=num_workers,
                                  dtype=batch_dtype, sharding=sharding)
        if verbose and is_main_process():
            print(f"Epoch {epoch}/{epochs} - {time.time() - t0:.3f}s "
                  f"- Loss {float(loss):.6f} - Accuracy {train_acc:.6f} "
                  f"- Test Accuracy {test_acc:.6f}")
        if history is not None:
            history.append({"epoch": epoch, "train_loss": float(loss),
                            "train_acc": float(train_acc),
                            "test_acc": float(test_acc)})
        if test_acc > best_acc:
            best_acc = test_acc
            best = state_snapshot(model)
    return best, best_acc


def run_video_model(cfg: Config,
                    data: Optional[Tuple[np.ndarray, ...]] = None,
                    use_mesh: bool = False,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Any]:
    """Run ``cfg.repeat`` seeded experiments of the video model
    ``cfg.model`` on ``device`` (the card unless told otherwise) and
    return the result dict of the JAX runner: the complexity report, one
    classification report per repeat, and the mean and spread of the test
    accuracy and of the training and test seconds.

    ``data`` is (x_tr, x_te, y_tr, y_te) in memory; by default the clips
    stream from ``cfg.path.video_pre_x`` (``load_video_data``). The model
    is built for the clips' (T, H, W). Repeat ``r`` draws its weights
    from a generator seeded r + 39 (or loads ``cfg.pretrained_path``, a
    torchvision-layout checkpoint or a component file), trains with that
    seed and scores the test set in the serving dtype (``compute_dtype``,
    "auto" the model's own), and saves its best weights to ``cfg.path.save_model`` when set,
    where the next repeat warm-starts. The complexity report's forward
    runs on the CPU. ``use_mesh`` trains each repeat data-parallel over
    the config's mesh (``cfg.mesh``, with ``cfg.mesh.fsdp``); every rank
    returns the same result, and rank 0 alone saves
    ``cfg.path.save_model``."""
    make_model = video_spec(cfg.model)
    sharding = (config_batch_sharding(cfg, resolve_device(device))
                if use_mesh else None)
    fsdp = sharding is not None and cfg.mesh.fsdp
    if data is None:
        train_ds, test_ds = load_video_data(cfg)
    else:
        x_tr, x_te, y_tr, y_te = data
        train_ds = ArrayClips(x_tr, y_tr.reshape(y_tr.shape[0], -1))
        test_ds = ArrayClips(x_te, y_te.reshape(y_te.shape[0], -1))
    out_dim = train_ds.y.shape[-1]
    example = np.ascontiguousarray(train_ds.example())
    clip = tuple(example.shape[1:4])

    def build(seed: int) -> nn.Module:
        return make_model(out_dim, clip,
                          torch.Generator().manual_seed(seed))

    result: Dict[str, Any] = {"complexity": complexity_report(
        build(0).eval(), torch.from_numpy(example))}
    pretrained = None
    if cfg.pretrained_path:
        pretrained = state_snapshot(load_video_pretrained(
            cfg.pretrained_path, cfg.model, build(0)))
    dtype = (torch.bfloat16 if resolve_serving_dtype(
        cfg.compute_dtype, cfg.model) == "bfloat16" else None)

    accuracies, times_train, times_test = [], [], []
    for r in range(cfg.repeat):
        model = build(r + 39)
        if pretrained is not None:
            model.load_state_dict(pretrained)
        elif cfg.path.save_model and os.path.exists(cfg.path.save_model):
            restore_scenario(model, cfg.path.save_model, "full", cfg.model)
        t0 = time.time()
        best, _ = fit_video(model, train_ds, test_ds, lr=cfg.nn.lr,
                            epochs=cfg.nn.epoch, batch_size=cfg.nn.batch_size,
                            seed=r + 39, threshold=cfg.nn.threshold,
                            train_dtype=cfg.train_dtype, sharding=sharding,
                            fsdp=fsdp, device=device)
        t1 = time.time()
        # the final test pass: the serving path, in the serving dtype,
        # every rank on the whole test set (as JAX's); FSDP left the
        # trained model's parameters sharded, so it serves from a copy
        if fsdp:
            model = build(r + 39).to(resolve_device(device))
        model.load_state_dict(best)
        if dtype is not None:
            cast_for_serving(model, dtype)
        acc, pred, _ = evaluate(model, test_ds, cfg.nn.threshold,
                                chunk=cfg.nn.batch_size, dtype=dtype)
        result[f"repeat_{r}"] = classification_report(
            test_ds.y.astype(int), pred)
        accuracies.append(acc)
        times_train.append(t1 - t0)
        times_test.append(time.time() - t1)
        if cfg.path.save_model and is_main_process():
            save_components(cfg.path.save_model, best)
        if sharding is not None:
            barrier()       # the next repeat's warm start reads it

    for name, values in (("accuracy", accuracies),
                         ("time_train", times_train),
                         ("time_test", times_test)):
        result[name] = {"avg": float(np.mean(values)),
                        "std": float(np.std(values))}
    return result
