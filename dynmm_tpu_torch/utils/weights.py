"""Carry flax variable trees across to the port's modules.

A copy of the key and layout rules of ``dynmm_tpu/utils/torch_export.py``
(the port imports nothing of the JAX package): structural renames to the
reference's torch names (``block{i}`` → ``layer.i``, ``ds_conv`` →
``downsample.0``, ...), HWIO → OIHW for conv kernels, (in, out) → (out, in)
for dense kernels, ``scale`` → ``weight`` and ``mean``/``var`` →
``running_mean``/``running_var``. The port's modules carry exactly these
names, so the result loads with ``strict=True``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# structural renames, most specific first (torch_export.py:21-34)
_INV_RULES = [
    (re.compile(r"\.block(\d+)\."), lambda m: f".{m.group(1)}."),
    (re.compile(r"\.ds_conv\."), lambda m: ".downsample.0."),
    (re.compile(r"\.ds_bn\."), lambda m: ".downsample.1."),
    (re.compile(r"gate_layer\.conv1\."), lambda m: "gate_layer.conv.0."),
    (re.compile(r"gate_layer\.bn1\."), lambda m: "gate_layer.conv.1."),
    (re.compile(r"gate_layer\.conv2\."), lambda m: "gate_layer.conv.3."),
    (re.compile(r"gate_layer\.bn2\."), lambda m: "gate_layer.conv.4."),
    (re.compile(r"\.fc1\."), lambda m: ".fc.0."),
    (re.compile(r"\.fc2\."), lambda m: ".fc.2."),
    (re.compile(r"\.feature(\d+)\."), lambda m: f".features.{m.group(1)}.1."),
    (re.compile(r"(^|\.)(skip_layer\d)\."),
     lambda m: f"{m.group(1)}{m.group(2)}.0."),
    (re.compile(r"\.decoder_blocks(\d+)\."),
     lambda m: f".decoder_blocks.{m.group(1)}."),
]


def flax_to_torch_key(fkey: str) -> str:
    for pat, rep in _INV_RULES:
        fkey = pat.sub(rep, fkey)
    return fkey


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO → OIHW
    if leaf == "kernel" and value.ndim == 2:
        return value.transpose(1, 0)  # (in, out) → (out, in)
    return value


def state_dict_from_flax(params: dict, batch_stats: dict | None = None
                         ) -> dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (flax ``params`` and ``batch_stats``) →
    ``{torch_key: tensor}`` in the reference's torch names and layouts."""
    out: dict[str, torch.Tensor] = {}
    for path, value in _leaf_paths(params):
        leaf, base = path[-1], ".".join(path[:-1])
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        arr = _torch_layout(leaf, np.asarray(value))
        out[flax_to_torch_key(f"{base}.{name}")] = torch.tensor(arr)
    for path, value in _leaf_paths(batch_stats or {}):
        leaf, base = path[-1], ".".join(path[:-1])
        name = "running_mean" if leaf == "mean" else "running_var"
        out[flax_to_torch_key(f"{base}.{name}")] = torch.tensor(
            np.asarray(value))
    return out


def load_flax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Load ``{"params": ..., "batch_stats": ...}`` (numpy leaves) into
    ``model`` with ``strict=True``. Modules that keep kernel-packed copies
    of their weights repack them from a load hook."""
    sd = state_dict_from_flax(variables.get("params", {}),
                              variables.get("batch_stats"))
    model.load_state_dict(sd, strict=True)
