"""Carry weights from the JAX package's variables to the port.

``state_dict_from_jax(model_key, variables)`` takes a JAX model's
``{"params": ..., "batch_stats": ...}`` tree as nested dicts of arrays and
returns the port model's state dict, for ``load_state_dict(strict=True)``.
It is the inverse of the JAX package's ``core/torch_import.py`` per-layer
maps (which read the same reference torch layout the port's parameters are
named after):

- Linear ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv1d ``conv/kernel`` (k, in/groups, out) -> ``weight`` (out, in/groups, k);
- BatchNorm ``bn/scale, bias`` + stats ``bn/mean, var`` -> ``weight, bias,
  running_mean, running_var``;
- LayerNorm ``ln/scale, bias`` -> ``weight, bias``;
- attention ``in_proj_weight`` and ``out_proj_weight`` transposed;
- GaussianPosition ``embedding, mu, sigma`` -> ``var_embedding, var_mu,
  var_sigma``.

The weight-shared decoder layer is written under every
``decoder_layers.{i}`` index, as the port's state dict repeats it.

MViT (``tools/convert_torchvision.py::convert_mvit`` inverted): Conv3d
``kernel`` (kt, kh, kw, in/groups, out) -> ``weight`` (out, in/groups, kt,
kh, kw); Linear and LayerNorm as above; the backbone under ``backbone.``
with torchvision's names, the task head as ``task_head``.
``resize_mvit_tables`` adapts a torchvision-named MViT checkpoint to
another clip size.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import NNConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{pre}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, p, pre: str) -> None:
    c = p["conv"]
    sd[f"{pre}.weight"] = _t(np.transpose(np.asarray(c["kernel"]), (2, 1, 0)))
    if "bias" in c:
        sd[f"{pre}.bias"] = _t(c["bias"])


def _bn(sd: StateDict, p, s, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(p["bn"]["scale"])
    sd[f"{pre}.bias"] = _t(p["bn"]["bias"])
    sd[f"{pre}.running_mean"] = _t(s["bn"]["mean"])
    sd[f"{pre}.running_var"] = _t(s["bn"]["var"])


def _ln(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(p["ln"]["scale"])
    sd[f"{pre}.bias"] = _t(p["ln"]["bias"])


def _mha(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.in_proj_weight"] = _t(np.asarray(p["in_proj_weight"]).T)
    sd[f"{pre}.in_proj_bias"] = _t(p["in_proj_bias"])
    sd[f"{pre}.out_proj.weight"] = _t(np.asarray(p["out_proj_weight"]).T)
    sd[f"{pre}.out_proj.bias"] = _t(p["out_proj_bias"])


def _gaussian(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.var_embedding"] = _t(p["embedding"])
    sd[f"{pre}.var_mu"] = _t(p["mu"])
    sd[f"{pre}.var_sigma"] = _t(p["sigma"])


def _encoder_block(sd: StateDict, p, s, pre: str, n_convs: int) -> None:
    _ln(sd, p["norm_0"], f"{pre}.layer_norm_0")
    _mha(sd, p["attn"], f"{pre}.layer_attention")
    _ln(sd, p["norm_1"], f"{pre}.layer_norm_1")
    for i in range(n_convs):
        _conv1d(sd, p[f"cnn_{i}"], f"{pre}.layer_cnn.{i}.0")
        _bn(sd, p[f"cnn_bn_{i}"], s[f"cnn_bn_{i}"], f"{pre}.layer_cnn.{i}.1")


def _that_trunk(sd: StateDict, p, s) -> None:
    tp, ts = p["trunk"], s["trunk"]
    _gaussian(sd, tp["gaussian"], "layer_left_gaussian")
    for i in range(4):
        _encoder_block(sd, tp[f"left_encoder_{i}"], ts[f"left_encoder_{i}"],
                       f"layer_left_encoder.{i}", 3)
    _ln(sd, tp["left_norm"], "layer_left_norm")
    _conv1d(sd, tp["left_cnn_0"], "layer_left_cnn_0")
    _conv1d(sd, tp["left_cnn_1"], "layer_left_cnn_1")
    _encoder_block(sd, tp["right_encoder_0"], ts["right_encoder_0"],
                   "layer_right_encoder.0", 3)
    _ln(sd, tp["right_norm"], "layer_right_norm")
    _conv1d(sd, tp["right_cnn_0"], "layer_right_cnn_0")
    _conv1d(sd, tp["right_cnn_1"], "layer_right_cnn_1")


def _that(sd: StateDict, p, s, layers: int) -> None:
    _that_trunk(sd, p, s)
    _linear(sd, p["head"], "layer_output")


def _that_multi_head(sd: StateDict, p, s, layers: int) -> None:
    _that_trunk(sd, p, s)
    heads = sorted((k for k in p if k.startswith("head_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, key in enumerate(heads):
        _linear(sd, p[key], f"layer_output.{i}")


def _detr(sd: StateDict, p, s, layers: int) -> None:
    fp, fs = p["feature_extractor"], s["feature_extractor"]
    _conv1d(sd, fp["initial_conv"]["depthwise"],
            "feature_extractor.initial_conv.depthwise")
    _conv1d(sd, fp["initial_conv"]["pointwise"],
            "feature_extractor.initial_conv.pointwise")
    for i in range(4):
        _conv1d(sd, fp[f"dilated_{i}"]["conv"],
                f"feature_extractor.dilated_blocks.{i}.conv")
        _bn(sd, fp[f"dilated_{i}"]["bn"], fs[f"dilated_{i}"]["bn"],
            f"feature_extractor.dilated_blocks.{i}.bn")
    _conv1d(sd, fp["final_conv"], "feature_extractor.final_conv")

    ep, es = p["encoder"], s["encoder"]
    _gaussian(sd, ep["gaussian"], "encoder.layer_embedding_gaussian")
    for i in range(4):
        _encoder_block(sd, ep[f"encoder_{i}"], es[f"encoder_{i}"],
                       f"encoder.layer_embedding_encoder.{i}", 1)
    _ln(sd, ep["norm"], "encoder.layer_embedding_norm")

    _shared_decoder(sd, p["decoder"], layers)
    _linear(sd, p["decoder"]["class_embed"], "decoder.class_embed")


def _shared_decoder(sd: StateDict, dp, layers: int) -> None:
    """The query embedding and the weight-shared decoder layer, written
    under every ``decoder.decoder_layers.{i}``."""
    sd["decoder.query_embed"] = _t(dp["query_embed"])
    lp = dp["shared_layer"]
    layer: StateDict = {}
    _mha(layer, lp["self_attn"], "self_attn")
    _mha(layer, lp["cross_attn"], "cross_attn")
    for norm in ("norm1", "norm2", "norm3"):
        _ln(layer, lp[norm], norm)
    _linear(layer, lp["ffn_up"], "ffn.0")
    _linear(layer, lp["ffn_down"], "ffn.3")
    for i in range(layers):
        for key, value in layer.items():
            sd[f"decoder.decoder_layers.{i}.{key}"] = value


def _that_encoder(sd: StateDict, p, s, layers: int) -> None:
    ep, es = p["encoder"], s["encoder"]
    _gaussian(sd, ep["gaussian"], "encoder.layer_left_gaussian")
    for i in range(4):
        _encoder_block(sd, ep[f"left_encoder_{i}"], es[f"left_encoder_{i}"],
                       f"encoder.layer_left_encoder.{i}", 3)
    _ln(sd, ep["left_norm"], "encoder.layer_left_norm")
    _encoder_block(sd, ep["right_encoder_0"], es["right_encoder_0"],
                   "encoder.layer_right_encoder.0", 3)
    _ln(sd, ep["right_norm"], "encoder.layer_right_norm")
    dp = p["decoder"]
    _shared_decoder(sd, dp, layers)
    _ln(sd, dp["norm"], "decoder.norm")
    for i in range(layers + 1):
        _linear(sd, dp[f"class_embed_{i}"], f"decoder.class_embed.{i}")


def _conv3d(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (4, 3, 0, 1, 2)))
    if "bias" in p:
        sd[f"{pre}.bias"] = _t(p["bias"])


def _ln_flat(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(p["scale"])
    sd[f"{pre}.bias"] = _t(p["bias"])


def _mvit_attention(sd: StateDict, ap, pre: str) -> None:
    """One MultiscaleAttention: qkv, project.0, pool_{q,k,v} (conv and
    norm_act.0) and the relative tables, where present."""
    _linear(sd, ap["qkv"], f"{pre}.qkv")
    _linear(sd, ap["project"], f"{pre}.project.0")
    for pool in ("pool_q", "pool_k", "pool_v"):
        if pool in ap:
            _conv3d(sd, ap[pool]["conv"], f"{pre}.{pool}.pool")
            _ln_flat(sd, ap[pool]["norm"], f"{pre}.{pool}.norm_act.0")
    for axis in ("h", "w", "t"):
        if f"rel_pos_{axis}" in ap:
            sd[f"{pre}.rel_pos_{axis}"] = _t(ap[f"rel_pos_{axis}"])


def _mvit(sd: StateDict, p, s, layers: int) -> None:
    """MViT-v1 or v2 (the variant shows in the tree: v1 has the absolute
    tables, v2 the relative ones) into ``backbone.*`` with torchvision's
    names, and the task head into ``task_head``."""
    _conv3d(sd, p["conv_proj"], "backbone.conv_proj")
    for name in ("class_token", "spatial_pos", "temporal_pos", "class_pos"):
        if name in p:
            sd[f"backbone.pos_encoding.{name}"] = _t(p[name])
    i = 0
    while f"block{i}" in p:
        bp, pre = p[f"block{i}"], f"backbone.blocks.{i}"
        _ln_flat(sd, bp["norm1"], f"{pre}.norm1")
        _mvit_attention(sd, bp["attn"], f"{pre}.attn")
        _ln_flat(sd, bp["norm2"], f"{pre}.norm2")
        _linear(sd, bp["mlp_up"], f"{pre}.mlp.0")
        _linear(sd, bp["mlp_down"], f"{pre}.mlp.3")
        if "project" in bp:
            _linear(sd, bp["project"], f"{pre}.project")
        i += 1
    _ln_flat(sd, p["norm"], "backbone.norm")
    _linear(sd, p["fc"], "backbone.head.1")
    _linear(sd, p["head"], "task_head")


_EXPORTERS = {
    "THAT": _that,
    "THAT_MULTI_HEAD": _that_multi_head,
    "THAT_COUNT": _that,
    "THAT_COUNT_CONSTRAINED": _that,
    "THAT_ENCODER": _that_encoder,
    "DETR": _detr,
    "MViT-v1": _mvit,
    "MViT-v2": _mvit,
}


def state_dict_from_jax(
        model_key: str, variables: Mapping[str, Any], *,
        num_decoder_layers: int = NNConfig.num_decoder_layers) -> StateDict:
    """The port's float32 state dict for the JAX ``variables`` of
    ``model_key``. ``num_decoder_layers`` says how many times the shared
    decoder layer of DETR and THAT_ENCODER is listed (the JAX tree holds
    it once), and so how many class heads THAT_ENCODER has (one more)."""
    if model_key not in _EXPORTERS:
        raise KeyError(f"no weight map for model {model_key!r} "
                       f"(have {sorted(_EXPORTERS)})")
    sd: StateDict = {}
    _EXPORTERS[model_key](sd, variables["params"],
                          variables.get("batch_stats", {}), num_decoder_layers)
    return sd


# ---------------------------------------------------------------------- #
# MViT checkpoints at another clip size (the port's copy of
# tools/convert_torchvision.py:270-323, on torchvision-named state dicts)
# ---------------------------------------------------------------------- #

def _interp_table_np(table: np.ndarray, dst: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False) on dim 0."""
    src = table.shape[0]
    if src == dst:
        return table
    pos = np.clip((np.arange(dst) + 0.5) * (src / dst) - 0.5, 0, src - 1)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = (pos - i0)[:, None].astype(table.dtype)
    return table[i0] * (1 - frac) + table[i1] * frac


def resize_mvit_tables(state: Mapping[str, Any], variant: str,
                       target_clip) -> StateDict:
    """A torchvision-named MViT state dict (``MViT.backbone``'s names)
    adapted to clips of ``target_clip`` = (T, H, W).

    v2: each block's decomposed relative tables are interpolated linearly
    to the sizes the clip gives, as torchvision does at run time. v1: the
    absolute tables are drawn afresh at the clip's size from
    ``default_rng(1)`` (std 0.02), as the reference rebuilds its positional
    encoding per clip size. Other entries are passed through.
    """
    from ..models.video.mvit import _block_configs, patchified
    sd = dict(state)
    tt, hh, ww = patchified(target_clip)
    if variant == "v1":
        c = sd["pos_encoding.class_token"].shape[0]
        rng = np.random.default_rng(1)
        for name, shape in (("spatial_pos", (hh * ww, c)),
                            ("temporal_pos", (tt, c)), ("class_pos", (c,))):
            sd[f"pos_encoding.{name}"] = _t(
                rng.standard_normal(shape) * 0.02)
        return sd
    size = [tt, hh, ww]
    for i, cfg in enumerate(_block_configs(variant)):
        pre = f"blocks.{i}.attn.rel_pos_"
        sp = max(size[1], size[2])
        rel_sp = 2 * max(sp // cfg.q_stride[1], sp // cfg.kv_stride[1]) - 1
        for axis, dst in (("h", rel_sp), ("w", rel_sp),
                          ("t", 2 * size[0] - 1)):
            table = np.asarray(sd[pre + axis], dtype=np.float32)
            sd[pre + axis] = _t(_interp_table_np(table, dst))
        if cfg.has_pool_q:
            size = [s // st for s, st in zip(size, cfg.q_stride)]
    return sd
