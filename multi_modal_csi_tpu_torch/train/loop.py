"""The CSI training engine (counterpart of the JAX package's
``train/loop.py``): one eager train step, the host epoch loop, chunked
full-dataset evaluation, best-weight selection and early stopping.

It keeps the reference engine's observable rules (reference
``wifi_csi/train.py:36-176``):

- shuffle each epoch with ``np.random.default_rng(seed)``, as the JAX
  package does, and skip the final batch, so every step sees a full batch;
- augmentation on training batches only;
- the cosine-warmup schedule stepped once per step (multi_head mode by
  default);
- per-epoch metrics on the LAST TRAINED batch (train side, with the
  reference's ``astype(int)`` truncation of the logits) and on the FULL
  validation set (test side);
- best weights kept only when F1 and perfect-prediction-% both strictly
  improve; patience-based early stop; the final weights when nothing ever
  improved.

Dropout and augmentation draw from one ``torch.Generator`` on the model's
device, seeded with ``seed``.

Run checkpoints (``checkpoint_dir``, ``checkpoint_every``) hold what the
JAX package's resume restores: the model's parameters and BatchNorm
buffers, the optimizer's state and the epoch, and here also the
schedule's state, which JAX's optimizer state carries. As in JAX, a
resumed run draws its shuffles, augmentation and dropout afresh from
``seed`` and keeps its best weights from the epochs it runs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import RunCheckpointer
from ..core.device import resolve_device
from ..data.pipeline import chunked, epoch_batches, pad_to, prefetch_batches
from ..metrics.performance import performance_metrics
from ..nn.layers import dropout_generator
from .augment import apply_augmentation
from .schedules import cosine_warmup

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
StateDict = Dict[str, torch.Tensor]
TRAIN_DTYPES = {None: None, "float32": None, torch.float32: None,
                 "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


@dataclasses.dataclass
class FitResult:
    best_state: StateDict          # CPU copy of the best state dict
    best_epoch: int
    epochs_ran: int
    history: List[Dict[str, float]]


def adam_like_torch(params, lr: float,
                    weight_decay: float = 0.0) -> torch.optim.Adam:
    """torch.optim.Adam as the reference trains: betas (0.9, 0.999), eps
    1e-8, coupled L2 (grad += wd * param before the moments), which is
    what the JAX package's optax chain reproduces."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Loss, *,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
                    = None,
                    augment: bool = True,
                    batch_dtype: Optional[torch.dtype] = None):
    """One training step ``step(bx, by, generator) -> (loss, out)``: cast
    the batch to ``batch_dtype``, augment it, forward in training mode
    with dropout drawn from ``generator``, backward, update, step the
    schedule. ``loss`` and ``out`` come back detached, on the device."""

    def step(bx: torch.Tensor, by: torch.Tensor,
             generator: torch.Generator):
        model.train()
        if batch_dtype is not None:
            bx = bx.to(batch_dtype)
        if augment:
            bx = apply_augmentation(bx, generator)
        optimizer.zero_grad(set_to_none=True)
        with dropout_generator(generator):
            out = model(bx)
        loss = loss_fn(out, by)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach(), out.detach()

    return step


@torch.no_grad()
def eval_dataset(model: nn.Module, x: np.ndarray, *, chunk: int = 512,
                 batch_axis: int = 0, dtype: Optional[torch.dtype] = None
                 ) -> np.ndarray:
    """Eval-mode forward over all of ``x`` in fixed chunks (the last one
    zero-padded), on the model's device. ``batch_axis`` is where the batch
    lies in the OUTPUT (1 for DETR's (L, B, Q, C)); ``dtype`` casts each
    chunk. Returns float32 logits."""
    device = next(model.parameters()).device
    model.eval()
    n = x.shape[0]
    chunk = min(chunk, max(1, n))
    outs = []
    for start, size in chunked(n, chunk):
        bx = torch.from_numpy(pad_to(x[start:start + size], chunk)).to(device)
        if dtype is not None:
            bx = bx.to(dtype)
        out = model(bx).float().cpu().numpy()
        outs.append(np.take(out, np.arange(size), axis=batch_axis))
    return np.concatenate(outs, axis=batch_axis)


@torch.no_grad()
def cast_for_serving(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every float32 parameter and persistent buffer to ``dtype`` in
    place. Non-persistent buffers (constants such as GaussianPosition's
    position index) stay as they are, as the JAX package computes them
    in the forward."""
    for module in model.modules():
        for param in module.parameters(recurse=False):
            if param.dtype == torch.float32:
                param.data = param.data.to(dtype)
        for name, buf in module.named_buffers(recurse=False):
            if (buf.dtype == torch.float32
                    and name not in module._non_persistent_buffers_set):
                setattr(module, name, buf.to(dtype))
    return model


def cast_parameters(model: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Cast every float32 parameter to ``dtype`` in place (bf16 training;
    nothing for None); buffers such as BatchNorm's statistics stay f32."""
    if dtype is None:
        return
    for param in model.parameters():
        if param.dtype == torch.float32:
            param.data = param.data.to(dtype)


def state_snapshot(model: nn.Module) -> StateDict:
    """A CPU copy of the model's state dict."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def resume(state: Dict, model: nn.Module, opt: torch.optim.Optimizer,
           scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]) -> int:
    """Load a run checkpoint into the live run and return its epoch. The
    schedule keeps the live run's length: the step count is restored and
    the learning rate recomputed from it, as JAX evaluates its schedule at
    the restored count."""
    live = model.state_dict()
    wrong = [k for k, v in state["model"].items()
             if v.dtype != live[k].dtype]
    if wrong:
        raise ValueError(f"the run checkpoint's dtypes differ from the "
                         f"run's (e.g. {wrong[0]}): a checkpoint restores "
                         f"only into a run of its own train_dtype")
    model.load_state_dict(state["model"], strict=True)
    opt.load_state_dict(state["optimizer"])
    if (scheduler is None) != (state["scheduler"] is None):
        raise ValueError("the run checkpoint's schedule does not match the "
                         "run's")
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
        for group, base, factor in zip(opt.param_groups, scheduler.base_lrs,
                                       scheduler.lr_lambdas):
            group["lr"] = base * factor(scheduler.last_epoch)
    return int(state["epoch"])


def fit(model: nn.Module,
        x_train: np.ndarray, y_train: np.ndarray,
        x_valid: np.ndarray, y_valid: np.ndarray,
        *,
        loss_fn: Loss,
        mode: str,
        lr: float,
        epochs: int,
        batch_size: int,
        seed: int,
        weight_decay: float = 0.0,
        threshold: float = 0.5,
        patience: int = 150,
        use_cosine_schedule: Optional[bool] = None,
        warmup_epochs: int = 10,
        min_lr_ratio: float = 0.05,
        batch_axis: int = 0,
        augment: bool = True,
        eval_chunk: int = 512,
        train_dtype: Optional[Union[str, torch.dtype]] = None,
        optimizer: Optional[Callable[[nn.Module],
                                     torch.optim.Optimizer]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        device: Optional[Union[str, torch.device]] = None) -> FitResult:
    """Train ``model`` (moved to ``device``, the card by default) and return
    the best weights by the reference's rule.

    ``mode`` feeds performance_metrics (baseline | multi_head |
    count_classification | count_classification_withConstrain); target
    transforms are the caller's. ``train_dtype="bfloat16"`` keeps the
    parameters and Adam's moments in bf16 and casts each batch, while
    BatchNorm's running statistics stay f32; validation then runs in bf16
    too.

    ``optimizer``, if given, builds the optimizer from the model in place
    of Adam with ``weight_decay`` and the cosine schedule, and no schedule
    is stepped: the JAX ``fit``'s ``tx`` for restored weights
    (``train.transfer.transfer_optimizer``).

    With ``checkpoint_dir`` and ``checkpoint_every`` > 0 a run checkpoint
    is saved after every ``checkpoint_every``-th epoch, and a run that
    finds one there resumes from the newest at the epoch after it. A
    checkpoint restores only into a run of its own dtype.
    """
    if train_dtype not in TRAIN_DTYPES:
        raise ValueError(f"unsupported train_dtype {train_dtype!r}")
    batch_dtype = TRAIN_DTYPES[train_dtype]
    device = resolve_device(device)
    np_rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)

    n = x_train.shape[0]
    steps_per_epoch = math.ceil(n / batch_size) - 1
    if steps_per_epoch < 1:
        raise ValueError(f"{n} training windows at batch {batch_size} give "
                         f"no full batch once the last one is skipped")
    model.to(device)
    cast_parameters(model, batch_dtype)
    scheduler = None
    if optimizer is not None:
        opt = optimizer(model)
    else:
        opt = adam_like_torch(model.parameters(), lr, weight_decay)
        if use_cosine_schedule is None:
            use_cosine_schedule = mode == "multi_head"
        if use_cosine_schedule:
            scheduler = torch.optim.lr_scheduler.LambdaLR(
                opt, cosine_warmup(warmup_epochs * steps_per_epoch,
                                   epochs * steps_per_epoch, min_lr_ratio))
    step = make_train_step(model, opt, loss_fn, scheduler=scheduler,
                           augment=augment, batch_dtype=batch_dtype)
    ckpt, start_epoch = None, 0
    if checkpoint_dir and checkpoint_every > 0:
        ckpt = RunCheckpointer(checkpoint_dir)
        if ckpt.latest_step() is not None:
            start_epoch = resume(ckpt.restore(), model, opt, scheduler) + 1

    best_f1 = best_ppp = 0.0
    best_state = state_snapshot(model)
    best_epoch = -1
    counter = 0
    history: List[Dict[str, float]] = []
    y_valid_np = np.asarray(y_valid)

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        idx = epoch_batches(n, batch_size, np_rng, skip_last=True)
        for bx, by in prefetch_batches(x_train, y_train, idx, device):
            loss_train, out = step(bx, by, generator)
            last_by, last_out = by, out

        # train-side metrics on the last trained batch, with the
        # reference's astype(int) truncation of the logits
        train_metrics = performance_metrics(
            last_by.cpu().numpy().astype(int),
            last_out.float().cpu().numpy().astype(int),
            var_mode=mode, var_threshold=threshold)

        logits_valid = eval_dataset(model, x_valid, chunk=eval_chunk,
                                    batch_axis=batch_axis, dtype=batch_dtype)
        loss_valid = float(loss_fn(torch.from_numpy(logits_valid),
                                   torch.from_numpy(y_valid_np)))
        valid_metrics = performance_metrics(
            y_valid_np, logits_valid, var_mode=mode, var_threshold=threshold)

        history.append({
            "epoch": epoch,
            "epoch_time": time.time() - t0,
            "train_loss": float(loss_train),
            "test_loss": loss_valid,
            "total_error_test": valid_metrics["total_error"],
            "perfect_prediction_percentage_test":
                valid_metrics["perfect_prediction_percentage"],
            "perfect_prediction_percentage_train":
                train_metrics["perfect_prediction_percentage"],
            "accuracy_test": valid_metrics["accuracy"],
            "precision": valid_metrics["precision"],
            "recall": valid_metrics["recall"],
            "f1_score": valid_metrics["f1_score"],
        })

        # best weights only when f1 AND PPP both strictly improve
        if (valid_metrics["f1_score"] > best_f1
                and valid_metrics["perfect_prediction_percentage"]
                > best_ppp):
            best_f1 = valid_metrics["f1_score"]
            best_ppp = valid_metrics["perfect_prediction_percentage"]
            best_state = state_snapshot(model)
            best_epoch = epoch
            counter = 0
        else:
            counter += 1
        if ckpt and (epoch + 1) % checkpoint_every == 0:
            ckpt.save(epoch, {
                "model": state_snapshot(model),
                "optimizer": opt.state_dict(),
                "scheduler": (None if scheduler is None
                              else scheduler.state_dict()),
                "epoch": epoch})
        if counter >= patience:
            break

    if best_epoch < 0:  # never improved: the final weights
        best_state = state_snapshot(model)
    return FitResult(best_state, best_epoch, len(history), history)
