"""Checkpoints (counterpart of the JAX package's ``core/checkpoint.py``):
component files for saving and transfer learning, and run checkpoints for
resuming ``fit``.

- ``component_path`` and ``save_components``: the reference's
  ``results/model_0/PT_<envs>_<model>.pt``, a ``torch.save`` of the
  model's state dict. The port's parameter names are the reference's torch
  layout, so the file is the one the reference's ``save_model_components``
  writes, and the JAX package's ``restore_scenario`` reads it through its
  ``.pt`` route.
- ``load_components``: a state dict for a live model from a file in
  either package's format, decided by the bytes, not the name. A torch
  file (``.pt``/``.pth``, the port's or the reference's) is unwrapped
  from ``{'model_state_dict': ...}``, its ``_orig_mod.`` and ``module.``
  prefixes stripped (looping, so stacked wrappers unwrap too), and the
  entries the reference registers and never uses dropped: BatchNorm's
  ``num_batches_tracked``, THAT's position constant ``var_position``,
  THAT_ENCODER's head convs and DETR's decoder-level LayerNorm (JAX
  ``core/torch_import.py``). A JAX component file (flax msgpack, written
  by the JAX package's ``save_components``) is decoded and mapped through
  ``core/weights.py::state_dict_from_jax``; ``msgpack`` is imported only
  then.
- ``restore_scenario``: the reference's ``load_model_components`` with
  scenarios ``full`` (the whole model), ``feature_extractor`` (that
  submodule, with its BatchNorm buffers) and ``feature_encoder``
  (``feature_extractor`` and ``encoder``); the other submodules keep their
  weights. The file must hold the whole model in every scenario: a layout
  that does not match never loads in part.
- ``RunCheckpointer``: periodic run checkpoints with ``torch.save`` in
  place of orbax, keeping the newest ``RUNS_KEPT`` (3, orbax's setting in
  the JAX package).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

SCENARIOS = {"full": None,
             "feature_extractor": ("feature_extractor",),
             "feature_encoder": ("feature_extractor", "encoder")}

_PREFIXES = ("_orig_mod.", "module.")
# entries of every reference model that carry no weight
_NO_WEIGHT = (".num_batches_tracked", ".var_position")
# reference parameters that a model registers and never uses (reference
# that_encoder.py:217-247, detr.py:354; JAX core/torch_import.py:291-298,
# :322-325)
_DEAD_KEYS = {
    "THAT_ENCODER": tuple(
        f"encoder.layer_{side}_cnn_{i}.{leaf}" for side in ("left", "right")
        for i in (0, 1) for leaf in ("weight", "bias")),
    "DETR": ("decoder.norm.weight", "decoder.norm.bias"),
}


def component_path(saving_path: str, environments, model_name: str) -> str:
    """``<saving_path>/model_0/PT_<env1_env2...>_<model>.pt``."""
    env = "_".join(environments)
    return os.path.join(saving_path, "model_0", f"PT_{env}_{model_name}.pt")


def save_components(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """``torch.save`` of a state dict at ``path``, on the CPU, floating
    tensors in float32 as the reference stores them."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: (v.detach().float() if v.is_floating_point()
                    else v.detach()).cpu() for k, v in state.items()}, path)


def _unwrap(state: Mapping[str, Any], model_key: Optional[str]) -> StateDict:
    """A torch checkpoint's state dict: unwrapped, prefixes stripped, the
    weightless and dead entries dropped."""
    if "model_state_dict" in state:
        state = state["model_state_dict"]
    dead = set(_DEAD_KEYS.get(model_key, ()))
    out: StateDict = {}
    for key, value in state.items():
        while key.startswith(_PREFIXES):
            for prefix in _PREFIXES:
                key = key.removeprefix(prefix)
        if key.endswith(_NO_WEIGHT) or key in dead:
            continue
        out[key] = value
    return out


def load_pretrained(path: str, model_key: Optional[str] = None) -> StateDict:
    """A reference-layout state dict from a torch file, on the CPU, as
    ``_unwrap`` leaves it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _unwrap(state, model_key)


def _msgpack_leaf(code: int, data: bytes):
    """flax's msgpack extension types: 1 an ndarray (shape, dtype name,
    bytes), 3 a numpy scalar; bfloat16, which numpy lacks, comes back as
    float32 (exactly)."""
    import msgpack
    if code not in (1, 3):
        return msgpack.ExtType(code, data)
    shape, dtype, buffer = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        array = bits.view(np.float32).reshape(shape)
    else:
        array = np.frombuffer(buffer, np.dtype(dtype.decode())).reshape(shape)
    return array[()] if code == 3 else array


def is_torch_file(path: str) -> bool:
    """Whether ``path`` holds a ``torch.save`` file (a zip archive, or a
    pickle from before torch 1.6) rather than flax's msgpack (a map)."""
    with open(path, "rb") as f:
        head = f.read(4)
    return head == b"PK\x03\x04" or head[:1] == b"\x80"


def _read_flax_msgpack(data: bytes) -> Dict[str, Any]:
    """The nested dict of numpy arrays that flax's ``to_bytes`` wrote."""
    import msgpack
    return msgpack.unpackb(data, ext_hook=_msgpack_leaf, raw=False)


def _decoder_layers(model: nn.Module) -> int:
    layers = {int(m.group(1)) for k in model.state_dict()
              for m in [re.search(r"decoder_layers\.(\d+)\.", k)] if m}
    return len(layers)


def load_components(path: str, model: nn.Module,
                    model_key: Optional[str] = None) -> StateDict:
    """The state dict that ``path`` holds for ``model`` (``model_key``
    names its layout), from a torch file or a JAX msgpack component file,
    whatever the file's name."""
    if is_torch_file(path):
        return load_pretrained(path, model_key)
    with open(path, "rb") as f:
        data = f.read()
    try:
        tree = _read_flax_msgpack(data)
    except ValueError as e:        # msgpack's errors derive from it
        raise ValueError(f"{path} is neither a torch checkpoint nor a flax "
                         "msgpack component file") from e
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path} is neither a torch checkpoint nor a flax "
                         "msgpack component file")
    if model_key is None:
        raise ValueError(f"{path} is a JAX component file; pass model_key "
                         "so that its tree can be mapped")
    from .weights import state_dict_from_jax
    return state_dict_from_jax(model_key, tree,
                               num_decoder_layers=_decoder_layers(model))


def restore_scenario(model: nn.Module, path: str, scenario: str = "full",
                     model_key: Optional[str] = None) -> nn.Module:
    """Load ``path`` into ``model`` in ``scenario`` (full |
    feature_extractor | feature_encoder) and return ``model``. The file
    must match the whole model (the names, and the shapes of what loads);
    only the scenario's submodules take its weights."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario: {scenario}")
    saved = load_components(path, model, model_key)
    live = model.state_dict()
    missing, unexpected = set(live) - set(saved), set(saved) - set(live)
    if missing or unexpected:
        raise RuntimeError(
            f"{path} does not match the model: missing key(s) "
            f"{sorted(missing)[:6]}, unexpected key(s) "
            f"{sorted(unexpected)[:6]}")
    keep = SCENARIOS[scenario]
    if keep is not None:
        saved = {k: (v if k.split(".")[0] in keep else live[k])
                 for k, v in saved.items()}
    model.load_state_dict(saved, strict=True)
    return model


RUNS_KEPT = 3


class RunCheckpointer:
    """Run checkpoints ``<directory>/step_<N>.pt``, the newest
    ``RUNS_KEPT`` kept. A state is a dict of state dicts and numbers,
    as ``fit`` saves it; ``restore`` returns it on the CPU."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      for m in [re.fullmatch(r"step_(\d+)\.pt", name)] if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-RUNS_KEPT]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
