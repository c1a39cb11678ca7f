"""The CSI experiment driver (counterpart of the JAX package's
``runners/csi.py``): the model table, then data selection, per-model
repeats and results, as the reference's ``run_main.py`` runs them.

- ``master_split`` (reference ``run_main.py:20-66``): per environment, the
  annotation filter, the amplitude windows, label encoding, the model's
  target reduction (``:39-47``) and the seeded 80/20 split, concatenated
  over environments;
- ``run_csi_model``: the 50/50 validation/test split of the THAT and DETR
  families, repeat ``r`` trained by ``train.loop.fit`` with seed
  ``r + 39`` from a model drawn from a generator with that seed, the final
  test pass in the serving dtype, and the result dict;
- ``run_experiment``: that dict with the config's model, task, data and
  nn sections, written as JSON.

Each model-table entry builds the model from a ``torch.Generator`` and
records what serving and ``fit`` need: the loss, the metrics mode, the
weight decay, the output's batch axis, the target transform and the input
layout. ST-RF, SSL and dual_band have runners of their own
(``_run_strf``, ``runners/ssl.py``, ``runners/dual_band.py``), which
``run_csi_model`` dispatches to as the JAX runner does.

Transfer learning: ``cfg.pretrained_path`` (a component file of either
package, or a reference ``.pt``) is restored once into the weights of
seed 0 in ``cfg.transfer_scenario`` (``core/checkpoint.py``), and every
repeat starts from it and trains with ``train/transfer.py``'s optimizer.
``cfg.save_model`` saves each repeat's best weights to
``component_path(cfg.saving_path, cfg.data.environment, model)``. Metric
writers and device meshes wait for ROADMAP items 15 and 14 and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import component_path, restore_scenario, save_components
from ..core.config import CSI_CHANNELS, Config, resolve_serving_dtype
from ..core.device import resolve_device
from ..data.annotation import filter_annotation, label_list, load_annotation
from ..data.csi_io import flatten_features, load_csi_windows
from ..data.encoders import encode_labels, reduce_dataset
from ..data.splits import concat_env_splits, env_split, valid_test_split
from ..losses.basic import bce_with_logits, mse, smooth_l1
from ..losses.matching import (HungarianMatchingLoss, count_based_loss,
                               permutation_matching_loss)
from ..metrics.classification import (accuracy_score, classification_report,
                                      predict_labels)
from ..metrics.performance import performance_metrics
from ..models import csi as csi_models
from ..models.csi.strf import device_features, fit_predict_strf
from ..train.loop import (cast_for_serving, eval_dataset, fit,
                          state_snapshot)
from ..train.transfer import transfer_optimizer
from ..utils.complexity import complexity_report
from ..utils.results import NumpyJSONEncoder

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Split = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass(frozen=True)
class CSIModelSpec:
    key: str
    # (input shape (length, channels), or (features,) in the flat layout;
    # out_features, config, generator)
    build: Callable[[Tuple[int, ...], int, Config, torch.Generator],
                    nn.Module]
    make_loss: Callable[[Config, int], Loss]
    mode: str                      # performance_metrics mode
    target: str = "raw"            # raw | reduce | reduce_pad | reduce_sum
    input_layout: str = "seq"      # seq (B, length, channels) | flat
                                   # (B, length x channels)
    valid_split: bool = False      # THAT/DETR-family 50/50 valid/test split
    weight_decay: float = 0.0
    final_eval: str = "report"     # report | metrics | count_round
    batch_axis: int = 0            # batch axis of the model's OUTPUT


def _hungarian(per_layer_matching: bool = False):
    def make(cfg: Config, out: int) -> Loss:
        return HungarianMatchingLoss(
            cost_class_weight=cfg.nn.loss.cost_class_weight,
            aux_loss_weight=cfg.nn.loss.aux_loss_weight,
            label_smoothing=cfg.nn.loss.label_smoothing,
            class_imbalance_weight=cfg.nn.loss.class_imbalance_weight,
            per_layer_matching=per_layer_matching)
    return make


def _trunk(shape):
    return {"length": shape[0], "channels": shape[1]}


def _bce(pos_weight: float):
    def make(cfg: Config, out: int) -> Loss:
        return lambda o, t: bce_with_logits(o, t, pos_weight)
    return make


CSI_MODELS: Dict[str, CSIModelSpec] = {
    # the WiMANS baselines; MLP's shape is (length x channels,) in the
    # runner's flat layout and (length, channels) from build_model
    "MLP": CSIModelSpec(
        key="MLP",
        build=lambda xs, out, cfg, g: csi_models.MLP(
            out, in_features=math.prod(xs), generator=g),
        make_loss=_bce(4.0), mode="baseline", input_layout="flat",
        weight_decay=1e-3),
    "LSTM": CSIModelSpec(
        key="LSTM",
        build=lambda xs, out, cfg, g: csi_models.LSTMModel(
            out, channels=xs[-1], generator=g),
        make_loss=_bce(6.0), mode="baseline"),
    "CNN-1D": CSIModelSpec(
        key="CNN-1D",
        build=lambda xs, out, cfg, g: csi_models.CNN1D(
            out, channels=xs[-1], generator=g),
        make_loss=lambda cfg, out: mse, mode="baseline",
        final_eval="count_round"),
    "CNN-2D": CSIModelSpec(
        key="CNN-2D",
        build=lambda xs, out, cfg, g: csi_models.CNN2D(out, generator=g),
        make_loss=_bce(6.0), mode="baseline", weight_decay=1e-4),
    "CLSTM": CSIModelSpec(
        key="CLSTM",
        build=lambda xs, out, cfg, g: csi_models.CLSTM(
            out, channels=xs[-1], generator=g),
        make_loss=_bce(8.0), mode="baseline"),
    "ABLSTM": CSIModelSpec(
        key="ABLSTM",
        build=lambda xs, out, cfg, g: csi_models.ABLSTM(
            out, channels=xs[-1], generator=g),
        make_loss=_bce(6.0), mode="baseline"),
    "THAT": CSIModelSpec(
        key="THAT",
        build=lambda xs, out, cfg, g: csi_models.THAT(
            out, generator=g, **_trunk(xs)),
        make_loss=_bce(4.0), mode="baseline", valid_split=True,
        weight_decay=2e-4, final_eval="metrics"),
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
    "THAT_ENCODER": CSIModelSpec(
        key="THAT_ENCODER",
        build=lambda xs, out, cfg, g: csi_models.THATEncoderDETR(
            temp_cross=cfg.nn.cross_attention_temp,
            num_queries=cfg.nn.num_obj_queries,
            num_decoder_layers=cfg.nn.num_decoder_layers,
            generator=g, **_trunk(xs)),
        make_loss=_hungarian(per_layer_matching=True), mode="multi_head",
        target="reduce_pad", valid_split=True, weight_decay=2e-4,
        final_eval="metrics", batch_axis=1),
    "DETR": CSIModelSpec(
        key="DETR",
        build=lambda xs, out, cfg, g: csi_models.DETRMultiUser(
            token_length=cfg.nn.token_length,
            num_decoder_layers=cfg.nn.num_decoder_layers,
            temp_cross=cfg.nn.cross_attention_temp,
            num_queries=cfg.nn.num_obj_queries,
            dim_feedforward=cfg.nn.dim_ffn,
            generator=g, **_trunk(xs)),
        make_loss=_hungarian(), mode="multi_head", target="reduce_pad",
        valid_split=True, weight_decay=2e-4, final_eval="metrics",
        batch_axis=1),
}

# the CSI model keys with runners of their own (run_csi_model dispatches)
OWN_RUNNERS = ("ST-RF", "SSL", "dual_band")

# task -> (per-user class count, flat out_dim, reduced out_dim)
_TASK_DIMS = {
    "activity": (9, 6 * 9, 10),
    "identity": (6, 6, None),
    "location": (5, 6 * 5, None),
}


def _spec(model_key: str) -> CSIModelSpec:
    if model_key not in CSI_MODELS:
        raise KeyError(f"unknown model {model_key!r}; the table holds "
                       f"{sorted(CSI_MODELS)}, with runners of their own "
                       f"{list(OWN_RUNNERS)}")
    return CSI_MODELS[model_key]


MODEL_KEYS = tuple(CSI_MODELS) + OWN_RUNNERS


def infer_out_dim(model_key: str, task: str) -> int:
    """The out_features the runner derives from the encoded labels: raw
    targets flatten the per-user one-hots, reduced targets use the
    10-class query rows."""
    _, flat, reduced = _TASK_DIMS[task]
    if model_key in OWN_RUNNERS:
        return flat
    if _spec(model_key).target.startswith("reduce"):
        if reduced is None:
            raise ValueError(f"{model_key} supports task=activity only")
        return reduced
    return flat


def build_model(model_key: str, task: str = "activity", *, seed: int = 0,
                cfg: Optional[Config] = None) -> nn.Module:
    """Build ``model_key`` at the full width of ``cfg.data.length`` windows
    with weights drawn from a generator seeded with ``seed``, in eval mode,
    on the CPU. ST-RF has no network to build."""
    cfg = cfg or Config()
    out = infer_out_dim(model_key, task)
    if model_key == "SSL":
        from .ssl import build_ssl
        return build_ssl(out, seed).eval()
    if model_key == "dual_band":
        from .dual_band import build_dual_band
        return build_dual_band(out, seed).eval()
    if model_key == "ST-RF":
        raise ValueError("ST-RF is a random forest: it has no model to build")
    model = _spec(model_key).build((cfg.data.length, CSI_CHANNELS), out, cfg,
                                   torch.Generator().manual_seed(seed))
    return model.eval()


# ---------------------------------------------------------------------- #
# data assembly
# ---------------------------------------------------------------------- #

def apply_target_reduction(y: np.ndarray, target: str,
                           cfg: Config) -> np.ndarray:
    """The model's target transform (reference run_main.py:39-47)."""
    if target == "raw":
        return y
    if target == "reduce":
        return reduce_dataset(y)
    if target == "reduce_pad":
        return reduce_dataset(y, cfg.nn.num_obj_queries)
    if target == "reduce_sum":
        return reduce_dataset(y).sum(axis=1)
    raise ValueError(f"unknown target transform: {target}")


def master_split(cfg: Config, target: str = "raw", data_cfg=None) -> Split:
    """Per environment: filter, load, encode, reduce and split 80/20;
    concatenated over environments as (x_tr, x_te, y_tr, y_te)."""
    data_cfg = data_cfg or cfg.data
    annotation = load_annotation(cfg.path.data_y)
    per_env = []
    for env in data_cfg.environment:
        df = filter_annotation(annotation, environment=[env],
                               wifi_band=data_cfg.wifi_band,
                               num_users=data_cfg.num_users)
        x = load_csi_windows(cfg.path.data_x, label_list(df),
                             length=data_cfg.length)
        y = encode_labels(df, cfg.task, cfg.encoding_activity,
                          cfg.encoding_location)
        per_env.append(env_split(x, apply_target_reduction(y, target, cfg)))
    return concat_env_splits(per_env)


def _layout(x: np.ndarray, layout: str) -> np.ndarray:
    if layout == "flat":
        return x.reshape(x.shape[0], -1)
    return flatten_features(x) if x.ndim > 3 else x


# ---------------------------------------------------------------------- #
# final-test evaluators
# ---------------------------------------------------------------------- #

def _final_report(logits: np.ndarray, y_test: np.ndarray,
                  threshold: float) -> Tuple[float, dict]:
    """Baseline-family final evaluation: sigmoid > threshold, subset
    accuracy and the classification report (reference model/mlp.py:161-184)."""
    y_c = y_test.reshape(-1, y_test.shape[-1]).astype(int)
    p_c = predict_labels(logits, threshold).reshape(-1, y_test.shape[-1])
    return accuracy_score(y_c, p_c), classification_report(y_c, p_c)


def _count_round_metrics(logits: np.ndarray, y_test: np.ndarray) -> dict:
    """CNN-1D's final evaluation, as the JAX package fixed it: the
    per-user one-hot regression rounded and clamped to counts."""
    pred = np.clip(np.round(logits), 0, 5)
    users = y_test.shape[1] if y_test.ndim == 3 else 6
    pred_counts = pred.reshape(pred.shape[0], users, -1).sum(axis=1)
    true_counts = y_test.reshape(y_test.shape[0], users, -1).sum(axis=1)
    return performance_metrics(true_counts, pred_counts,
                               var_mode="count_classification_withConstrain")


# ---------------------------------------------------------------------- #
# the runner
# ---------------------------------------------------------------------- #

def _check_options(cfg: Config, writer_factory, use_mesh: bool) -> None:
    if writer_factory is not None:
        raise NotImplementedError("metric writers are not ported yet "
                                  "(ROADMAP item 15)")
    if use_mesh:
        raise NotImplementedError("data-parallel runs over a device mesh "
                                  "are not ported yet (ROADMAP item 14)")


def run_csi_model(cfg: Config, data: Optional[Split] = None,
                  writer_factory: Optional[Callable[[str], Any]] = None,
                  use_mesh: bool = False,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, Any]:
    """Run ``cfg.repeat`` seeded experiments of ``cfg.model`` on ``device``
    (the card unless told otherwise) and return the result dict that the
    reference's run_main.py would write. ``data`` is (x_tr, x_te, y_tr,
    y_te) as ``master_split`` returns it; by default it is read from
    ``cfg.path``. The complexity report's forward runs on the CPU. ST-RF,
    SSL and dual_band go to their own runners."""
    key = cfg.model
    _check_options(cfg, writer_factory, use_mesh)
    if key == "ST-RF":
        return _run_strf(cfg, data, device)
    if key == "SSL":
        from .ssl import run_ssl
        return run_ssl(cfg, data, device=device)
    if key == "dual_band":
        from .dual_band import run_dual_band
        return run_dual_band(cfg, data, device=device)
    spec = _spec(key)

    if data is None:
        x_tr, x_te, y_tr, y_te = master_split(cfg, spec.target)
    else:
        x_tr, x_te, y_tr, y_te = data
    if spec.valid_split:
        x_va, x_te, y_va, y_te = valid_test_split(x_te, y_te)
    else:
        x_va, y_va = x_te, y_te
    x_tr, x_va, x_te = (_layout(x, spec.input_layout)
                        for x in (x_tr, x_va, x_te))

    out_dim = (int(np.asarray(y_tr[0]).reshape(-1).shape[0])
               if spec.target == "raw" else int(np.asarray(y_tr[0]).shape[-1]))

    # the engine's target views (reference train.py:91-94)
    if spec.mode == "baseline":
        y_tr_fit = y_tr.reshape(y_tr.shape[0], -1)
        y_va_fit = y_va.reshape(y_va.shape[0], -1)
    elif spec.mode == "count_classification":
        y_tr_fit, y_va_fit = y_tr.sum(axis=1), y_va.sum(axis=1)
    else:
        y_tr_fit, y_va_fit = y_tr, y_va

    def build(seed: int) -> nn.Module:
        return spec.build(x_tr.shape[1:], out_dim, cfg,
                          torch.Generator().manual_seed(seed))

    result: Dict[str, Any] = {"complexity": complexity_report(
        build(0), torch.from_numpy(np.ascontiguousarray(x_tr[:1])))}

    # restored weights: loaded once into the weights of seed 0 (the JAX
    # runner restores into its init at PRNGKey(0)), trained with the
    # scenario's optimizer
    pretrained = optimizer = None
    if cfg.pretrained_path:
        pretrained = state_snapshot(restore_scenario(
            build(0), cfg.pretrained_path, cfg.transfer_scenario, key))

        def optimizer(model):
            return transfer_optimizer(model, cfg.nn.lr,
                                      cfg.transfer_scenario)

    eval_dtype = (torch.bfloat16 if resolve_serving_dtype(
        cfg.compute_dtype, key) == "bfloat16" else None)
    accuracies: List[float] = []
    times_train: List[float] = []
    times_test: List[float] = []
    last_metrics: Dict[str, Any] = {}
    for r in range(cfg.repeat):
        seed = r + 39
        model = build(seed)
        if pretrained is not None:
            model.load_state_dict(pretrained, strict=True)
        t0 = time.time()
        fitres = fit(model, x_tr, y_tr_fit, x_va, y_va_fit,
                     loss_fn=spec.make_loss(cfg, out_dim), mode=spec.mode,
                     lr=cfg.nn.lr, epochs=cfg.nn.epoch,
                     batch_size=cfg.nn.batch_size, seed=seed,
                     weight_decay=spec.weight_decay,
                     threshold=cfg.nn.threshold, patience=cfg.nn.patience,
                     warmup_epochs=cfg.nn.scheduler.num_warmup_epochs,
                     min_lr_ratio=cfg.nn.scheduler.min_lr_ratio,
                     batch_axis=spec.batch_axis, train_dtype=cfg.train_dtype,
                     optimizer=optimizer, device=device)
        t1 = time.time()
        if cfg.save_model:
            save_components(component_path(cfg.saving_path,
                                           cfg.data.environment, key),
                            fitres.best_state)

        # the final test pass: the serving path, in the serving dtype
        model.load_state_dict(fitres.best_state)
        if eval_dtype is not None:
            cast_for_serving(model, eval_dtype)
        logits = eval_dataset(model, x_te, batch_axis=spec.batch_axis,
                              dtype=eval_dtype)
        t2 = time.time()

        if spec.final_eval == "report":
            y_eval = (y_te.reshape(y_te.shape[0], -1)
                      if spec.mode == "baseline" else y_te)
            acc, report = _final_report(logits, y_eval, cfg.nn.threshold)
            result[f"repeat_{r}"] = report
            accuracies.append(acc)
        else:
            if spec.final_eval == "count_round":
                last_metrics = _count_round_metrics(logits, y_te)
            else:
                y_eval = (y_te.sum(axis=1)
                          if spec.mode == "count_classification" else y_te)
                last_metrics = performance_metrics(
                    y_eval, logits, var_mode=spec.mode,
                    var_threshold=cfg.nn.threshold)
            accuracies.append(last_metrics["perfect_prediction_percentage"])
            result[f"repeat_{r}"] = {k: v for k, v in last_metrics.items()
                                     if k != "counting_error_perPerson"}
        times_train.append(t1 - t0)
        times_test.append(t2 - t1)

    summarize(result, accuracies, times_train, times_test)
    if last_metrics:
        result["final_metrics"] = {k: v for k, v in last_metrics.items()
                                   if k != "counting_error_perPerson"}
    return result


def summarize(result: Dict[str, Any], accuracies: List[float],
              times_train: List[float], times_test: List[float]) -> None:
    """Add the avg/std over repeats of the accuracy and the train and test
    times to ``result``, as the reference's run_main.py reports them."""
    for name, values in (("accuracy", accuracies),
                         ("time_train", times_train),
                         ("time_test", times_test)):
        result[name] = {"avg": float(np.mean(values)),
                        "std": float(np.std(values))}


def _run_strf(cfg: Config, data: Optional[Split],
              device: Optional[Union[str, torch.device]]) -> Dict[str, Any]:
    """ST-RF (reference model/strf.py:17-113): the spectrogram features
    once on ``device``, then per repeat the forest seeded r + 39 on the
    host, its subset accuracy and the classification report."""
    device = resolve_device(device)
    if data is None:
        data = master_split(cfg, "raw")
    x_tr, x_te, y_tr, y_te = data
    f_tr = device_features(_layout(x_tr, "seq"), device)
    f_te = device_features(_layout(x_te, "seq"), device)
    result: Dict[str, Any] = {}
    accuracies, times_train, times_test = [], [], []
    for r in range(cfg.repeat):
        t0 = time.time()
        pred = fit_predict_strf(f_tr, y_tr, f_te, seed=r + 39)
        t1 = time.time()
        y_c = y_te.reshape(-1, y_te.shape[-1])
        p_c = pred.reshape(-1, y_te.shape[-1])
        accuracies.append(accuracy_score(y_c, p_c))
        result[f"repeat_{r}"] = classification_report(y_c, p_c)
        times_train.append(t1 - t0)
        times_test.append(time.time() - t1)
    summarize(result, accuracies, times_train, times_test)
    return result


def run_experiment(cfg: Config, data: Optional[Split] = None,
                   save: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
    """``run_csi_model`` plus the config's model, task, data and nn
    sections (reference run_main.py:88-160), written as JSON to
    ``cfg.path.save`` when ``save``."""
    result = run_csi_model(cfg, data, device=device)
    result["model"] = cfg.model
    result["task"] = cfg.task
    result["data"] = dataclasses.asdict(cfg.data)
    result["nn"] = dataclasses.asdict(cfg.nn)
    if save and cfg.path.save:
        os.makedirs(os.path.dirname(cfg.path.save) or ".", exist_ok=True)
        with open(cfg.path.save, "w") as f:
            json.dump(result, f, indent=4, cls=NumpyJSONEncoder)
    return result
