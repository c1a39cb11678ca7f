"""Carry weights from the JAX package's variables to the port.

``state_dict_from_jax(model_key, variables)`` takes a JAX model's
``{"params": ..., "batch_stats": ...}`` tree as nested dicts of arrays and
returns the port model's state dict, for ``load_state_dict(strict=True)``.
It is the inverse of the JAX package's ``core/torch_import.py`` per-layer
maps (which read the same reference torch layout the port's parameters are
named after):

- Linear ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv1d ``conv/kernel`` (k, in/groups, out) -> ``weight`` (out, in/groups, k);
- Conv2d ``conv/kernel`` (kh, kw, in, out) -> ``weight`` (out, in, kh, kw);
- LSTM ``w_ih_fwd``, ``w_hh_fwd`` (in, 4H) -> ``weight_ih_l0``,
  ``weight_hh_l0`` (4H, in), ``b_ih_fwd``, ``b_hh_fwd`` -> ``bias_ih_l0``,
  ``bias_hh_l0``, and the ``bwd`` direction with the ``l0_reverse``
  suffix;
- BatchNorm ``bn/scale, bias`` + stats ``bn/mean, var`` -> ``weight, bias,
  running_mean, running_var``;
- LayerNorm ``ln/scale, bias`` -> ``weight, bias``;
- attention ``in_proj_weight`` and ``out_proj_weight`` transposed;
- GaussianPosition ``embedding, mu, sigma`` -> ``var_embedding, var_mu,
  var_sigma``.

The weight-shared decoder layer is written under every
``decoder_layers.{i}`` index, as the port's state dict repeats it.

A tree quantized by the JAX package (``core/quantize.py`` there) carries
across too: an int8 ``kernel`` (or ``in_proj_weight``/``out_proj_weight``)
stays int8 in the port's layout, ``kernel_scale`` becomes
``weight_scale``, ``input_scale`` keeps its name, ``in_proj_weight_scale``
too, and ``out_proj_weight_scale`` becomes ``out_proj.weight_scale``
(float32 each). ``core.quantize.load_quantized`` loads such a state dict.

SSL and dual_band follow the JAX importer's maps (``core/torch_import.py:
331-353`` there): each CNN-1D tower as CNN-1D, the projector's Linears
and BatchNorms as ``projector.{0,1,3,4}``, the fusion Linears as
``combine_linear``, ``linear{1,2,3}`` and ``final_linear``.

MViT (``tools/convert_torchvision.py::convert_mvit`` inverted): Conv3d
``kernel`` (kt, kh, kw, in/groups, out) -> ``weight`` (out, in/groups, kt,
kh, kw); Linear and LayerNorm as above; the backbone under ``backbone.``
with torchvision's names, the task head as ``task_head``.
``resize_mvit_tables`` adapts a torchvision-named MViT checkpoint to
another clip size.

ResNet3D, S3D and Swin3D (``tools/convert_torchvision.py::convert_r3d_18``,
``convert_s3d`` and ``convert_swin3d`` inverted): the backbone under
``backbone.`` with torchvision's names, the task head as ``task_head``.
The convs of JAX's ``Conv3D`` wrapper (``conv/kernel``) carry their int8
weight and scales across as Linear's do; S3D's ``classifier`` is the
port's Linear ``classifier.1``; Swin's ``rel_pos_bias`` is
``relative_position_bias_table``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import NNConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _w(a) -> torch.Tensor:
    """A weight already in the port's layout: int8 stays int8 (a
    quantized tree), anything else becomes float32."""
    if np.asarray(a).dtype == np.int8:
        return torch.from_numpy(np.array(a, dtype=np.int8, copy=True))
    return _t(a)


def _scales(sd: StateDict, p, pre: str) -> None:
    """A quantized layer's ``kernel_scale`` and ``input_scale``, where
    present."""
    if "kernel_scale" in p:
        sd[f"{pre}.weight_scale"] = _t(p["kernel_scale"])
    if "input_scale" in p:
        sd[f"{pre}.input_scale"] = _t(p["input_scale"])


def _linear(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _w(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{pre}.bias"] = _t(p["bias"])
    _scales(sd, p, pre)


def _conv1d(sd: StateDict, p, pre: str) -> None:
    c = p["conv"]
    sd[f"{pre}.weight"] = _w(np.transpose(np.asarray(c["kernel"]), (2, 1, 0)))
    if "bias" in c:
        sd[f"{pre}.bias"] = _t(c["bias"])
    _scales(sd, c, pre)


def _conv2d(sd: StateDict, p, pre: str) -> None:
    c = p["conv"]
    sd[f"{pre}.weight"] = _w(np.transpose(np.asarray(c["kernel"]),
                                          (3, 2, 0, 1)))
    if "bias" in c:
        sd[f"{pre}.bias"] = _t(c["bias"])
    _scales(sd, c, pre)


def _lstm(sd: StateDict, p, pre: str, name: str = "fwd",
          suffix: str = "l0") -> None:
    sd[f"{pre}.weight_ih_{suffix}"] = _t(np.asarray(p[f"w_ih_{name}"]).T)
    sd[f"{pre}.weight_hh_{suffix}"] = _t(np.asarray(p[f"w_hh_{name}"]).T)
    sd[f"{pre}.bias_ih_{suffix}"] = _t(p[f"b_ih_{name}"])
    sd[f"{pre}.bias_hh_{suffix}"] = _t(p[f"b_hh_{name}"])


def _bn(sd: StateDict, p, s, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(p["bn"]["scale"])
    sd[f"{pre}.bias"] = _t(p["bn"]["bias"])
    sd[f"{pre}.running_mean"] = _t(s["bn"]["mean"])
    sd[f"{pre}.running_var"] = _t(s["bn"]["var"])


def _ln(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.weight"] = _t(p["ln"]["scale"])
    sd[f"{pre}.bias"] = _t(p["ln"]["bias"])


def _mha(sd: StateDict, p, pre: str) -> None:
    sd[f"{pre}.in_proj_weight"] = _w(np.asarray(p["in_proj_weight"]).T)
    sd[f"{pre}.in_proj_bias"] = _t(p["in_proj_bias"])
    sd[f"{pre}.out_proj.weight"] = _w(np.asarray(p["out_proj_weight"]).T)
    sd[f"{pre}.out_proj.bias"] = _t(p["out_proj_bias"])
    if "in_proj_weight_scale" in p:
        sd[f"{pre}.in_proj_weight_scale"] = _t(p["in_proj_weight_scale"])
    if "out_proj_weight_scale" in p:
        sd[f"{pre}.out_proj.weight_scale"] = _t(p["out_proj_weight_scale"])


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


def _mlp(sd: StateDict, p, s, layers: int) -> None:
    if "input_norm" in p:              # absent once folded for serving
        _bn(sd, p["input_norm"], s["input_norm"], "layer_norm")
    for i in range(3):
        _linear(sd, p[f"layer_{i}"], f"layer_{i}")


def _lstm_model(sd: StateDict, p, s, layers: int) -> None:
    _bn(sd, p["input_norm"], s["input_norm"], "layer_norm")
    _lstm(sd, p["lstm"], "layer_lstm")
    _linear(sd, p["head"], "layer_linear")


def _ablstm(sd: StateDict, p, s, layers: int) -> None:
    _bn(sd, p["input_norm"], s["input_norm"], "layer_norm")
    _lstm(sd, p["bilstm"], "layer_bilstm", "fwd", "l0")
    _lstm(sd, p["bilstm"], "layer_bilstm", "bwd", "l0_reverse")
    _linear(sd, p["attn"], "layer_linear")
    _linear(sd, p["head"], "layer_output")


def _cnn1d(sd: StateDict, p, s, layers: int) -> None:
    _cnn1d_tower(sd, p, s)


def _cnn1d_tower(sd: StateDict, p, s, pre: str = "") -> None:
    _bn(sd, p["input_norm"], s["input_norm"], f"{pre}layer_norm")
    for i in range(3):
        _conv1d(sd, p[f"conv_{i}"], f"{pre}layer_cnn_1d_{i}")
    _linear(sd, p["head"], f"{pre}layer_linear")


def _ssl(sd: StateDict, p, s, layers: int) -> None:
    _cnn1d_tower(sd, p["backbone"], s["backbone"], "backbone.")
    _linear(sd, p["proj_1"], "projector.0")
    _bn(sd, p["proj_bn_1"], s["proj_bn_1"], "projector.1")
    _linear(sd, p["proj_2"], "projector.3")
    _bn(sd, p["proj_bn_2"], s["proj_bn_2"], "projector.4")
    _linear(sd, p["online_head"], "online_head")


def _dual_band(sd: StateDict, p, s, layers: int) -> None:
    for band in (1, 2):
        _cnn1d_tower(sd, p[f"band{band}"], s[f"band{band}"],
                     f"cnn_band{band}.")
    _linear(sd, p["combine"], "combine_linear")
    for i in range(3):
        _linear(sd, p[f"res_{i}"], f"linear{i + 1}")
    _linear(sd, p["head"], "final_linear")


def _cnn2d(sd: StateDict, p, s, layers: int) -> None:
    for i in range(4):
        if f"norm_{i}" in p:           # norm_0 is absent once folded
            _bn(sd, p[f"norm_{i}"], s[f"norm_{i}"], f"layer_norm_{i}")
    for i in range(3):
        _conv2d(sd, p[f"conv_{i}"], f"layer_cnn_2d_{i}")
    _linear(sd, p["head"], "layer_linear")


def _clstm(sd: StateDict, p, s, layers: int) -> None:
    _bn(sd, p["input_norm"], s["input_norm"], "layer_norm")
    for i in range(3):
        _conv1d(sd, p[f"conv_{i}"], f"layer_cnn_1d_{i}")
        _bn(sd, p[f"norm_{i}"], s[f"norm_{i}"], f"layer_norm_{i}")
    _lstm(sd, p["lstm"], "layer_lstm")
    _linear(sd, p["head"], "layer_linear")


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


def _video_conv(sd: StateDict, p, pre: str) -> None:
    """A conv of JAX's video ``Conv3D`` wrapper (``conv/kernel`` and, when
    quantized, its scales)."""
    c = p["conv"]
    sd[f"{pre}.weight"] = _w(np.transpose(np.asarray(c["kernel"]),
                                          (4, 3, 0, 1, 2)))
    _scales(sd, c, pre)


def _resnet3d(sd: StateDict, p, s, layers: int) -> None:
    _video_conv(sd, p["stem"], "backbone.stem.0")
    _bn(sd, p["stem_bn"], s["stem_bn"], "backbone.stem.1")
    for layer in range(1, 5):
        for block in range(2):
            bp, bs = p[f"layer{layer}_{block}"], s[f"layer{layer}_{block}"]
            pre = f"backbone.layer{layer}.{block}"
            for conv in ("conv1", "conv2"):
                _video_conv(sd, bp[conv], f"{pre}.{conv}.0")
                _bn(sd, bp[f"bn{conv[-1]}"], bs[f"bn{conv[-1]}"],
                    f"{pre}.{conv}.1")
            if "downsample" in bp:
                _video_conv(sd, bp["downsample"], f"{pre}.downsample.0")
                _bn(sd, bp["downsample_bn"], bs["downsample_bn"],
                    f"{pre}.downsample.1")
    _linear(sd, p["fc"], "backbone.fc")
    _linear(sd, p["head"], "task_head")


def _convbn(sd: StateDict, p, s, pre: str) -> None:
    _video_conv(sd, p["conv"], f"{pre}.0")
    _bn(sd, p["bn"], s["bn"], f"{pre}.1")


def _sepconv(sd: StateDict, p, s, pre: str) -> None:
    _convbn(sd, p["spatial"], s["spatial"], f"{pre}.0")
    _convbn(sd, p["temporal"], s["temporal"], f"{pre}.1")


# the indices of S3D's mixed blocks in torchvision's ``features``
S3D_MIXED_FEATURES = (5, 6, 8, 9, 10, 11, 12, 14, 15)


def _s3d(sd: StateDict, p, s, layers: int) -> None:
    _sepconv(sd, p["stem"], s["stem"], "backbone.features.0")
    _convbn(sd, p["conv2"], s["conv2"], "backbone.features.2")
    _sepconv(sd, p["conv3"], s["conv3"], "backbone.features.3")
    for i, fi in enumerate(S3D_MIXED_FEATURES):
        mp, ms = p[f"mixed_{i}"], s[f"mixed_{i}"]
        pre = f"backbone.features.{fi}"
        _convbn(sd, mp["branch1"], ms["branch1"], f"{pre}.branch0")
        for src, dst in (("branch2", "branch1"), ("branch3", "branch2")):
            _convbn(sd, mp[f"{src}_reduce"], ms[f"{src}_reduce"],
                    f"{pre}.{dst}.0")
            _sepconv(sd, mp[src], ms[src], f"{pre}.{dst}.1")
        _convbn(sd, mp["branch4"], ms["branch4"], f"{pre}.branch3.1")
    _linear(sd, p["classifier"], "backbone.classifier.1")
    _linear(sd, p["head"], "task_head")


def _swin3d(sd: StateDict, p, s, layers: int) -> None:
    _conv3d(sd, p["patch_embed"], "backbone.patch_embed.proj")
    _ln_flat(sd, p["patch_norm"], "backbone.patch_embed.norm")
    stage = 0
    while f"stage{stage}_block0" in p:
        block = 0
        while f"stage{stage}_block{block}" in p:
            bp = p[f"stage{stage}_block{block}"]
            pre = f"backbone.features.{2 * stage}.{block}"
            _ln_flat(sd, bp["norm1"], f"{pre}.norm1")
            _linear(sd, bp["attn"]["qkv"], f"{pre}.attn.qkv")
            _linear(sd, bp["attn"]["proj"], f"{pre}.attn.proj")
            sd[f"{pre}.attn.relative_position_bias_table"] = _t(
                bp["attn"]["rel_pos_bias"])
            _ln_flat(sd, bp["norm2"], f"{pre}.norm2")
            _linear(sd, bp["mlp_up"], f"{pre}.mlp.0")
            _linear(sd, bp["mlp_down"], f"{pre}.mlp.3")
            block += 1
        if f"merge{stage}" in p:
            pre = f"backbone.features.{2 * stage + 1}"
            _ln_flat(sd, p[f"merge{stage}"]["norm"], f"{pre}.norm")
            _linear(sd, p[f"merge{stage}"]["reduction"], f"{pre}.reduction")
        stage += 1
    _ln_flat(sd, p["norm"], "backbone.norm")
    _linear(sd, p["fc"], "backbone.head")
    _linear(sd, p["head"], "task_head")


_EXPORTERS = {
    "MLP": _mlp,
    "LSTM": _lstm_model,
    "ABLSTM": _ablstm,
    "CNN-1D": _cnn1d,
    "CNN-2D": _cnn2d,
    "CLSTM": _clstm,
    "THAT": _that,
    "THAT_MULTI_HEAD": _that_multi_head,
    "THAT_COUNT": _that,
    "THAT_COUNT_CONSTRAINED": _that,
    "THAT_ENCODER": _that_encoder,
    "DETR": _detr,
    "SSL": _ssl,
    "dual_band": _dual_band,
    "MViT-v1": _mvit,
    "MViT-v2": _mvit,
    "ResNet": _resnet3d,
    "S3D": _s3d,
    "Swin-T": _swin3d,
    "Swin-S": _swin3d,
}


def state_dict_from_jax(
        model_key: str, variables: Mapping[str, Any], *,
        num_decoder_layers: int = NNConfig.num_decoder_layers) -> StateDict:
    """The port's state dict (float32, the int8 weights of a quantized
    tree kept int8) for the JAX ``variables`` of ``model_key``.
    ``num_decoder_layers`` says how many times the shared decoder layer of
    DETR and THAT_ENCODER is listed (the JAX tree holds it once), and so
    how many class heads THAT_ENCODER has (one more)."""
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
    to the sizes the live model has at that clip (the pooled sizes are
    ceilings, as the stride-2 pooling convs give them), as torchvision
    does at run time. v1: the
    absolute tables are drawn afresh at the clip's size from
    ``default_rng(1)`` (std 0.02), as the reference rebuilds its positional
    encoding per clip size. Other entries are passed through.
    """
    from ..models.video.mvit import (_block_configs, _pooled, patchified,
                                     rel_table_sizes)
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
    thw = (tt, hh, ww)
    for i, cfg in enumerate(_block_configs(variant)):
        pre = f"blocks.{i}.attn.rel_pos_"
        rel_sp, rel_t = rel_table_sizes(thw, cfg.q_stride, cfg.kv_stride)
        for axis, dst in (("h", rel_sp), ("w", rel_sp), ("t", rel_t)):
            table = np.asarray(sd[pre + axis], dtype=np.float32)
            sd[pre + axis] = _t(_interp_table_np(table, dst))
        if cfg.has_pool_q:
            thw = _pooled(thw, cfg.q_stride)
    return sd
