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

Data parallelism (``sharding``, a ``parallel.mesh.BatchSharding``; JAX's
``fit(sharding=..., fsdp=...)``): one process a device, each training on
its rows of every global batch, with the numbers of one process on the
whole batch (BatchNorm's statistics, the random draws and the losses'
denominators are the global batch's, ``nn/layers.py``). The gradients
are averaged over the ranks by one all-reduce after the backward
(``parallel/collectives.py::average_gradients``) rather than by
``DistributedDataParallel``: the model stays the module the runners
built (its state dict, its attributes, no wrapper), parameters without a
gradient need no flag, and at the reference's model sizes the overlap
DDP's buckets would buy is small. ``fsdp=True`` shards the parameters
and Adam's moments over the data axis with FSDP2 instead
(``parallel/partition.py::apply_fsdp``), which averages the gradients
itself. Validation is split over the ranks and its logits gathered, so
every rank computes the same metrics and takes the same best-weight and
early-stop decisions. The best weights, ``FitResult``'s and a
checkpoint's are whole tensors on every rank; rank 0 writes the
checkpoint, the state dicts an unsharded run writes.
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
from ..core.device import cudnn_f32, resolve_device
from ..data.pipeline import chunked, epoch_batches, pad_to, prefetch_batches
from ..metrics.performance import performance_metrics
from ..nn.layers import dropout_generator
from ..parallel.collectives import (average_gradients, axis_scope,
                                    gather_rows, pmean)
from ..parallel.mesh import (DATA_AXIS, BatchSharding, barrier,
                             batch_divisor, is_main_process, shard_batch)
from ..parallel.partition import apply_fsdp, full_tensor
from ..utils.logging import MetricWriter
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
    what the JAX package's optax chain reproduces. Where some parameters
    are DTensors and some are not (a model under the tensor-parallel
    rules), each kind is a parameter group of its own: a foreach step
    refuses a list that mixes them; the update of each parameter is the
    same."""
    from torch.distributed.tensor import DTensor
    params = list(params)
    placed = [p for p in params if isinstance(p, DTensor)]
    if placed and len(placed) < len(params):
        params = [{"params": placed},
                  {"params": [p for p in params
                              if not isinstance(p, DTensor)]}]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def data_parallel(model: nn.Module, sharding: Optional[BatchSharding],
                  fsdp: bool) -> None:
    """Check the data-parallel options and, with ``fsdp``, shard the
    model's parameters over the data axis in place (before its optimizer
    is built). ``fsdp`` without ``sharding`` raises ValueError, as JAX's
    ``aot_train_step`` does."""
    if fsdp and sharding is None:
        raise ValueError("fsdp=True requires a batch `sharding` (the mesh "
                         "whose 'data' axis the state shards over)")
    if fsdp:
        apply_fsdp(model, sharding.mesh)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Loss, *,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
                    = None,
                    augment: bool = True,
                    batch_dtype: Optional[torch.dtype] = None,
                    sharding: Optional[BatchSharding] = None,
                    fsdp: bool = False):
    """One training step ``step(bx, by, generator) -> (loss, out)``: cast
    the batch to ``batch_dtype``, augment it, forward in training mode
    with dropout drawn from ``generator``, backward, update, step the
    schedule. ``loss`` and ``out`` come back detached, on the device.

    With ``sharding`` the batch is this rank's rows of the global one:
    the forward and backward run inside ``axis_scope`` of its mesh, and
    the gradients are averaged over the mesh's "data" axis (by FSDP2 when
    the model was sharded with ``fsdp``, ``data_parallel``); ``loss`` is
    then this rank's term, whose mean over the data axis is the global
    loss. A model under the tensor-parallel rules
    (``parallel/partition.py::apply_tensor_parallel``) runs on its shards
    over the mesh's "model" axis, whose ranks take the same rows."""
    mesh = None if sharding is None else sharding.mesh

    def step(bx: torch.Tensor, by: torch.Tensor,
             generator: torch.Generator):
        model.train()
        if batch_dtype is not None:
            bx = bx.to(batch_dtype)
        with axis_scope(mesh):
            if augment:
                bx = apply_augmentation(bx, generator)
            optimizer.zero_grad(set_to_none=True)
            with dropout_generator(generator):
                out = model(bx)
            loss = loss_fn(out, by)
            with cudnn_f32():          # the convs' backward in full f32 too
                loss.backward()
            if sharding is not None and not fsdp:
                average_gradients(model.parameters(), DATA_AXIS)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return loss.detach(), out.detach()

    return step


def eval_chunk(n: int, chunk: int,
               sharding: Optional[BatchSharding] = None) -> int:
    """The evaluation chunk for ``n`` rows: ``chunk``, at most ``n``,
    rounded up to a multiple of ``batch_divisor`` (a set smaller than the
    data axis included)."""
    div = batch_divisor(sharding)
    return -(-min(chunk, max(1, n)) // div) * div


@torch.no_grad()
def forward_chunk(model: nn.Module, rows: np.ndarray, chunk: int, *,
                  batch_axis: int = 0, dtype: Optional[torch.dtype] = None,
                  sharding: Optional[BatchSharding] = None) -> np.ndarray:
    """Eval forward of ``rows`` zero-padded to ``chunk`` rows, each cast
    to ``dtype``, on the model's device: with ``sharding`` this rank runs
    its rows of the chunk inside ``axis_scope`` of its mesh (a model under
    the tensor-parallel rules sums over its "model" axis) and the outputs
    are gathered over the data axis. Returns the f32 outputs of the real
    rows (``batch_axis`` is where the batch lies in the output)."""
    device = next(model.parameters()).device
    bx = torch.from_numpy(shard_batch(sharding, pad_to(rows, chunk)))
    bx = bx.to(device)
    if dtype is not None:
        bx = bx.to(dtype)
    with axis_scope(None if sharding is None else sharding.mesh):
        out = gather_rows(model(bx), sharding, batch_axis)
    return np.take(out.float().cpu().numpy(), np.arange(rows.shape[0]),
                   axis=batch_axis)


@torch.no_grad()
def eval_dataset(model: nn.Module, x: np.ndarray, *, chunk: int = 512,
                 batch_axis: int = 0, dtype: Optional[torch.dtype] = None,
                 sharding: Optional[BatchSharding] = None) -> np.ndarray:
    """Eval-mode forward over all of ``x`` in fixed chunks (the last one
    zero-padded), on the model's device. ``batch_axis`` is where the batch
    lies in the OUTPUT (1 for DETR's (L, B, Q, C)); ``dtype`` casts each
    chunk. Returns float32 logits.

    With ``sharding`` each rank runs its rows of every chunk, padded to
    the data axis (``eval_chunk``, ``forward_chunk``), so every rank
    returns all the logits."""
    model.eval()
    n = x.shape[0]
    chunk = eval_chunk(n, chunk, sharding)
    return np.concatenate(
        [forward_chunk(model, x[start:start + size], chunk,
                       batch_axis=batch_axis, dtype=dtype,
                       sharding=sharding)
         for start, size in chunked(n, chunk)], axis=batch_axis)


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


def host_value(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor (FSDP's shards, or a tensor-parallel
    parameter's) is gathered from every rank, so every rank must call
    this alike (JAX's ``host_value``)."""
    return full_tensor(t)


def state_snapshot(model: nn.Module) -> StateDict:
    """A CPU copy of the model's state dict, whole tensors also where
    FSDP shards them."""
    return {k: host_value(v.detach()).to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def optimizer_snapshot(opt: torch.optim.Optimizer) -> Dict:
    """The optimizer's state dict with whole tensors where FSDP shards
    them: what an unsharded run's optimizer holds."""
    state = opt.state_dict()
    state["state"] = {i: {k: host_value(v) if torch.is_tensor(v) else v
                          for k, v in per.items()}
                      for i, per in state["state"].items()}
    return state


def restore_model(state: Dict, model: nn.Module) -> None:
    """Load a run checkpoint's model state into a model not yet sharded;
    a checkpoint restores only into a run of its own dtypes."""
    live = model.state_dict()
    wrong = [k for k, v in state["model"].items()
             if v.dtype != live[k].dtype]
    if wrong:
        raise ValueError(f"the run checkpoint's dtypes differ from the "
                         f"run's (e.g. {wrong[0]}): a checkpoint restores "
                         f"only into a run of its own train_dtype")
    model.load_state_dict(state["model"], strict=True)


def resume(state: Dict, opt: torch.optim.Optimizer,
           scheduler: Optional[torch.optim.lr_scheduler.LambdaLR]) -> int:
    """Load a run checkpoint's optimizer and schedule into the live run
    (the model's state is ``restore_model``'s) and return its epoch.
    Moments of parameters that FSDP shards are sharded alike. The
    schedule keeps the live run's length: the step count is restored and
    the learning rate recomputed from it, as JAX evaluates its schedule at
    the restored count."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    opt.load_state_dict(state["optimizer"])
    for param, per in opt.state.items():
        if isinstance(param, DTensor):
            for k, v in per.items():
                if torch.is_tensor(v) and v.dim() and not isinstance(
                        v, DTensor):
                    per[k] = distribute_tensor(v, param.device_mesh,
                                               param.placements)
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
        sharding: Optional[BatchSharding] = None,
        fsdp: bool = False,
        writer: Optional[MetricWriter] = None,
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

    ``sharding`` (every rank calls ``fit`` alike, with the same seed)
    trains data-parallel on this rank's rows of each global batch of
    ``batch_size``, which the data axis must divide; ``fsdp`` shards the
    parameters and Adam's moments over it too (module docstring).

    ``writer`` (a ``utils.logging.MetricWriter`` or anything with its
    ``log``) gets each epoch's record, the dict appended to ``history``,
    with ``step=epoch``; under ``sharding`` only rank 0 logs, as only rank
    0 writes a run's files.
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
    if sharding is not None:
        sharding.rows(batch_size)               # the batch must split
    model.to(device)
    cast_parameters(model, batch_dtype)
    ckpt, state = None, None
    if checkpoint_dir and checkpoint_every > 0:
        ckpt = RunCheckpointer(checkpoint_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore()
            restore_model(state, model)
    data_parallel(model, sharding, fsdp)
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
                           augment=augment, batch_dtype=batch_dtype,
                           sharding=sharding, fsdp=fsdp)
    start_epoch = 0 if state is None else resume(state, opt, scheduler) + 1
    mesh = None if sharding is None else sharding.mesh

    best_f1 = best_ppp = 0.0
    best_state = state_snapshot(model)
    best_epoch = -1
    counter = 0
    history: List[Dict[str, float]] = []
    y_valid_np = np.asarray(y_valid)

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        idx = epoch_batches(n, batch_size, np_rng, skip_last=True)
        for bx, by in prefetch_batches(x_train, y_train, idx, device,
                                       sharding):
            loss_train, out = step(bx, by, generator)
            last_by, last_out = by, out
        # the global batch's loss and last batch
        with axis_scope(mesh):
            loss_train = pmean(loss_train)
        last_by = gather_rows(last_by, sharding)
        last_out = gather_rows(last_out, sharding, batch_axis)

        # train-side metrics on the last trained batch, with the
        # reference's astype(int) truncation of the logits
        train_metrics = performance_metrics(
            last_by.cpu().numpy().astype(int),
            last_out.float().cpu().numpy().astype(int),
            var_mode=mode, var_threshold=threshold)

        logits_valid = eval_dataset(model, x_valid, chunk=eval_chunk,
                                    batch_axis=batch_axis, dtype=batch_dtype,
                                    sharding=sharding)
        loss_valid = float(loss_fn(torch.from_numpy(logits_valid),
                                   torch.from_numpy(y_valid_np)))
        valid_metrics = performance_metrics(
            y_valid_np, logits_valid, var_mode=mode, var_threshold=threshold)

        record = {
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
        }
        history.append(record)
        if writer is not None and is_main_process():
            writer.log(record, step=epoch)

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
            saved = {"model": state_snapshot(model),
                     "optimizer": optimizer_snapshot(opt),
                     "scheduler": (None if scheduler is None
                                   else scheduler.state_dict()),
                     "epoch": epoch}
            if sharding is None:
                ckpt.save(epoch, saved)
            else:                      # one file for the ranks' one run
                if is_main_process():
                    ckpt.save(epoch, saved)
                barrier()
        if counter >= patience:
            break

    if best_epoch < 0:  # never improved: the final weights
        best_state = state_snapshot(model)
    return FitResult(best_state, best_epoch, len(history), history)
