"""Carry flax variable trees across to the port's modules.

A copy of the key and layout rules of ``dynmm_tpu/utils/torch_export.py``
(the port imports nothing of the JAX package): structural renames to the
reference's torch names (``block{i}`` → ``layer.i``, ``ds_conv`` →
``downsample.0``, ...), HWIO → OIHW for conv kernels, (in, out) → (out, in)
for dense kernels, ``scale`` → ``weight`` and ``mean``/``var`` →
``running_mean``/``running_var``. The port's modules carry exactly these
names, so the result loads with ``strict=True``. ``flax_from_state_dict``
is the inverse, so a checkpoint the port writes holds the flax tree layout
and loads into the JAX package. ``load_recipe_gate`` merges the repo's
recipe-trained gate asset into a model; ``load_checkpoint_into`` loads the
weights of a flax msgpack checkpoint.

The modality-level models (``models/modality``, ``nn/mlp.py``,
``nn/sequence.py``; classes with ``flax_tree = True``) name their
submodules after the flax tree itself, so their bridge is a tree walk
(``encoders_i`` ↔ the ``ModuleList`` ``encoders.i``) plus layout rules:
dense kernels (in, out) ↔ (out, in); attention ``query``/``key``/``value``
kernels (in, H, D) ↔ (H·D, in) and biases (H, D) ↔ (H·D,); the attention
``out`` kernel (H, D, out) ↔ (out, H·D); LayerNorm and BN ``scale`` ↔
``weight``; BN ``mean``/``var`` ↔ running statistics. A raw ``self.param``
leaf of a flax module (the fusions' ``factor{i}``, ``rank_weights``,
``W``, ``U``, ...) is a parameter of the same name and shape, carried as
it is. ``load_flax_variables`` and ``flax_variables`` pick the rules from
the model.

The segmentation models' quantized convs (``nn/quant.py``) carry the flax
``quant`` collection both ways: ``in_scale``, ``in_pct`` and, once packed,
``w_scale`` under the conv's flax path, and a packed conv's int8 ``kernel``
in ``params``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from pathlib import Path

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


# the inverse renames, torch name → flax path (dots), most specific first
_FWD_RULES = [
    (re.compile(r"gate_layer\.conv\.0\."), "gate_layer.conv1."),
    (re.compile(r"gate_layer\.conv\.1\."), "gate_layer.bn1."),
    (re.compile(r"gate_layer\.conv\.3\."), "gate_layer.conv2."),
    (re.compile(r"gate_layer\.conv\.4\."), "gate_layer.bn2."),
    (re.compile(r"\.downsample\.0\."), ".ds_conv."),
    (re.compile(r"\.downsample\.1\."), ".ds_bn."),
    (re.compile(r"\.fc\.0\."), ".fc1."),
    (re.compile(r"\.fc\.2\."), ".fc2."),
    (re.compile(r"\.features\.(\d+)\.1\."), r".feature\1."),
    (re.compile(r"(^|\.)(skip_layer\d)\.0\."), r"\1\2."),
    (re.compile(r"\.decoder_blocks\.(\d+)\."), r".decoder_blocks\1."),
    (re.compile(r"(layer\d)\.(\d+)\."), r"\1.block\2."),
]


def flax_to_torch_key(fkey: str) -> str:
    for pat, rep in _INV_RULES:
        fkey = pat.sub(rep, fkey)
    return fkey


def torch_to_flax_key(tkey: str) -> str:
    """The flax path (dot-joined, leaf name still torch's) of a torch name."""
    for pat, rep in _FWD_RULES:
        tkey = pat.sub(rep, tkey)
    return tkey


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


def _flax_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(2, 3, 1, 0)  # OIHW → HWIO
    if leaf == "kernel" and value.ndim == 2:
        return value.transpose(1, 0)
    return value


def flax_leaf(torch_name: str, ndim: int) -> tuple[tuple[str, ...], str]:
    """(flax path, flax collection) of a parameter or BN buffer name:
    ``weight`` is a conv ``kernel`` or a BN ``scale`` (1-D), the running
    statistics go to ``batch_stats`` as ``mean``/``var``."""
    base, leaf = torch_to_flax_key(torch_name).rsplit(".", 1)
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    elif leaf in ("running_mean", "running_var"):
        return tuple(base.split(".")) + (leaf[len("running_"):],), "batch_stats"
    return tuple(base.split(".")) + (leaf,), "params"


def _set_path(tree: dict, path: tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tensors_from_flax_tree(tree: dict, like: dict[str, torch.Tensor],
                           take=None) -> dict[str, torch.Tensor]:
    """``{torch_name: tensor}`` (CPU) of the names in ``like`` from a flax
    params tree of tensors shaped like them (``flax_from_state_dict(
    named)["params"]``, e.g. optimizer moments), kernels back in OIHW.
    ``take(name, leaf)``, if given, picks what to read of each leaf (a
    mesh rank's slice)."""
    out = {}
    for name, t in like.items():
        path, _ = flax_leaf(name, t.dim())
        node = tree
        for k in path:
            node = node[k]
        if take is not None:
            node = take(name, node)
        out[name] = torch.tensor(_torch_layout(path[-1], np.asarray(node)))
    return out


def flax_params_tree(values: dict[str, torch.Tensor],
                     masked: dict[str, torch.Tensor] | None = None) -> dict:
    """The flax params tree of ``values`` (``{torch_name: tensor}`` shaped
    like the parameters, e.g. optimizer moments; numpy copies), with an
    empty dict at the path of each name in ``masked``: optax's
    ``MaskedNode``, the leaf of a parameter a masked transform (``freeze``)
    leaves out."""
    tree = flax_from_state_dict(values)["params"]
    for name, t in (masked or {}).items():
        _set_path(tree, flax_leaf(name, t.dim())[0], {})
    return tree


def flax_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``state_dict_from_flax``: a state_dict in the
    reference's torch names (or any ``{name: tensor}`` shaped like the
    model's parameters) → ``{"params": ..., "batch_stats": ...}`` nested
    trees of numpy copies on the host, in the flax layout."""
    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        path, coll = flax_leaf(name, t.dim())
        arr = t.detach().cpu().numpy().copy()
        _set_path(out[coll], path, _flax_layout(path[-1], arr))
    return out


def uses_flax_tree(model: torch.nn.Module) -> bool:
    """Whether ``model`` holds modules named after the flax tree (the
    modality-level models) rather than the reference's torch names."""
    return any(getattr(m, "flax_tree", False) for m in model.modules())


_LIST_ITEM = re.compile(r"^(encoders)_(\d+)$")
_QKV = ("query", "key", "value")


def _tree_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Flax variables of a modality-level model → its state_dict."""
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaf_paths(variables.get(coll) or {}):
            mods = [_LIST_ITEM.sub(r"\1.\2", p) for p in path[:-1]]
            leaf, arr = path[-1], np.asarray(value)
            if coll == "batch_stats":
                name = f"running_{leaf}"
            elif leaf == "kernel":
                name = "weight"
                if arr.ndim == 3 and mods[-1] in _QKV:  # (in, H, D)
                    arr = arr.reshape(arr.shape[0], -1)
                elif arr.ndim == 3:  # out: (H, D, out)
                    arr = arr.reshape(-1, arr.shape[-1])
                arr = arr.T
            else:
                name = {"scale": "weight"}.get(leaf, leaf)
                if mods and mods[-1] in _QKV:  # q/k/v biases are (H, D)
                    arr = arr.reshape(-1)
            out[".".join(mods + [name])] = torch.tensor(np.ascontiguousarray(arr))
    return out


def tree_flax_path(name: str, ndim: int) -> tuple[tuple[str, ...], str]:
    """(flax path, collection) of a modality-level model's parameter or
    buffer name: ``encoders.i`` → ``encoders_i``; ``weight`` → ``kernel``
    (2-D) or ``scale`` (1-D); ``running_mean``/``running_var`` →
    ``batch_stats`` ``mean``/``var``."""
    *mods, leaf = name.split(".")
    path: list[str] = []
    for m in mods:
        if m.isdigit():
            path[-1] = f"{path[-1]}_{m}"
        else:
            path.append(m)
    if leaf.startswith("running_"):
        return tuple(path) + (leaf[len("running_"):],), "batch_stats"
    if leaf == "weight":
        leaf = "kernel" if ndim > 1 else "scale"
    return tuple(path) + (leaf,), "params"


def _tree_variables(model: torch.nn.Module) -> dict:
    """A modality-level model's state → flax variables (numpy copies)."""
    from dynmm_tpu_torch.nn.sequence import MultiHeadDotProductAttention

    out: dict = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        arr = t.detach().cpu().numpy().copy()
        path, coll = tree_flax_path(name, arr.ndim)
        mods = name.split(".")[:-1]
        owner = model.get_submodule(".".join(mods[:-1]))
        if path[-1] == "kernel":
            arr = arr.T
        if isinstance(owner, MultiHeadDotProductAttention):
            heads = (owner.num_heads, owner.head_dim)
            if mods[-1] != "out":  # q/k/v: (in, H, D) kernels, (H, D) biases
                arr = arr.reshape(*arr.shape[:-1], *heads)
            elif path[-1] == "kernel":  # out: (H, D, out)
                arr = arr.reshape(*heads, arr.shape[-1])
        _set_path(out[coll], path, np.ascontiguousarray(arr))
    return out


_QUANT_LEAVES = ("in_scale", "in_pct", "w_scale")


def _quant_convs(model: torch.nn.Module):
    """(flax path of the conv, conv) of every quantized conv of ``model``."""
    from dynmm_tpu_torch.utils.quantize import quant_convs

    for name, conv in quant_convs(model):
        path, _ = flax_leaf(f"{name}.weight", 4)
        yield path[:-1], conv


def _quant_collection(model: torch.nn.Module, params: dict) -> dict:
    """The flax ``quant`` collection of ``model``'s quantized convs
    (``in_scale``, ``in_pct``, and ``w_scale`` where packed), numpy; a
    packed conv's ``kernel`` in ``params`` becomes its int8 HWIO twin."""
    quant: dict = {}
    for path, conv in _quant_convs(model):
        for leaf in _QUANT_LEAVES:
            t = getattr(conv, leaf)
            if t is not None:
                _set_path(quant, path + (leaf,),
                          t.detach().cpu().numpy().copy())
        if conv.weight_q is not None:
            _set_path(params, path + ("kernel",), _flax_layout(
                "kernel", conv.weight_q.cpu().numpy().copy()))
    return quant


def flax_variables(model: torch.nn.Module) -> dict:
    """``{"params": ..., "batch_stats": ...}`` of ``model`` as flax trees
    of numpy copies (either naming scheme), with the ``quant`` collection
    of a model with quantized convs (``_quant_collection``)."""
    if uses_flax_tree(model):
        return _tree_variables(model)
    out = flax_from_state_dict(model.state_dict())
    quant = _quant_collection(model, out["params"])
    if quant:
        out["quant"] = quant
    return out


def _node(tree, path: tuple[str, ...]):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _dequantized_kernels(params: dict, quant) -> dict:
    """``params`` with each packed (int8) ``kernel`` replaced by
    ``kernel · w_scale`` in fp32, the float weight that loads strictly."""
    out = dict(params)
    for k, v in params.items():
        if isinstance(v, Mapping):
            out[k] = _dequantized_kernels(v, _node(quant, (k,)))
        elif k == "kernel" and np.asarray(v).dtype == np.int8:
            out[k] = (np.asarray(v, np.float32)
                      * np.asarray(quant["w_scale"], np.float32))
    return out


def _load_quant(model: torch.nn.Module, params: dict, quant: dict) -> None:
    """Set the quantized convs' buffers from a flax ``quant`` collection:
    the scales it has, and a packed conv's int8 kernel (``params``)."""
    convs = dict(_quant_convs(model))
    for path, _ in _leaf_paths(quant):
        if path[:-1] not in convs:
            raise KeyError(f"quant/{'/'.join(path)}: no quantized conv of "
                           "the model at that path")
    for path, conv in convs.items():
        node = _node(quant, path) or {}
        for leaf in ("in_scale", "in_pct"):
            if leaf in node:
                getattr(conv, leaf).copy_(torch.tensor(
                    np.asarray(node[leaf], np.float32)))
        kernel = np.asarray(_node(params, path + ("kernel",)))
        if kernel.dtype == np.int8:
            dev = conv.weight.device
            conv.pack(torch.tensor(_torch_layout("kernel", kernel).copy(),
                                   device=dev),
                      torch.tensor(np.asarray(node["w_scale"], np.float32),
                                   device=dev))


def load_flax_variables(model: torch.nn.Module, variables: dict) -> None:
    """Load ``{"params": ..., "batch_stats": ...}`` (numpy leaves) into
    ``model`` with ``strict=True``. Modules that keep kernel-packed copies
    of their weights repack them from a load hook. A ``quant`` collection
    sets the quantized convs' scales and, where its tree is packed (int8
    kernels, ``w_scale``), their int8 weights; their float weights are
    then ``kernel · w_scale``."""
    quant = variables.get("quant")
    if uses_flax_tree(model):
        sd = _tree_state_dict(variables)
    else:
        params = variables.get("params", {})
        if quant:
            params = _dequantized_kernels(params, quant)
        sd = state_dict_from_flax(params, variables.get("batch_stats"))
    model.load_state_dict(sd, strict=True)
    if quant:
        with torch.no_grad():
            _load_quant(model, variables["params"], quant)


def merge_subtree(dst: dict, src: dict, path: str = "") -> dict:
    """``dst`` with its leaves overwritten by those of ``src`` (a subset of
    the same tree); shapes must match, dtypes follow ``dst``."""
    out = dict(dst)
    for k, v in src.items():
        if k not in out:
            raise KeyError(f"{path}/{k} is not in the model")
        if isinstance(v, Mapping):
            out[k] = merge_subtree(out[k], v, f"{path}/{k}")
            continue
        arr, ref = np.asarray(v), np.asarray(out[k])
        if arr.shape != ref.shape:
            raise ValueError(f"shape mismatch at {path}/{k}: {arr.shape} "
                             f"(asset) vs {ref.shape} (model)")
        out[k] = arr.astype(ref.dtype)
    return out


RECIPE_ASSET_DIR = Path(__file__).resolve().parents[2] / "bench_assets"


def load_recipe_gate(model: torch.nn.Module, encoder: str = "resnet34",
                     asset_dir=None):
    """Merge the recipe-trained gate asset (``gate_recipe[_<encoder>].msgpack``:
    the gate, both stems' ``conv1``/``bn1`` and the stem SE fusion, with
    their BN statistics when the asset has them) into ``model``. Returns
    ``(branch_ratios, provenance)`` of the asset, or ``(None, None)`` when
    there is no asset."""
    from dynmm_tpu_torch.utils.msgpack import msgpack_restore

    suffix = "" if encoder == "resnet34" else f"_{encoder}"
    path = Path(asset_dir or RECIPE_ASSET_DIR) / f"gate_recipe{suffix}.msgpack"
    if not path.exists():
        return None, None
    payload = msgpack_restore(path.read_bytes())
    sub = payload["subtree"]
    variables = flax_from_state_dict(model.state_dict())
    variables["params"] = merge_subtree(variables["params"], sub["params"])
    if sub.get("batch_stats"):
        variables["batch_stats"] = merge_subtree(variables["batch_stats"],
                                                 sub["batch_stats"])
    load_flax_variables(model, variables)
    return np.asarray(payload["branch_ratios"]), payload.get("provenance")


def load_checkpoint_into(model: torch.nn.Module, path) -> dict:
    """Load the weights (``state.params`` and ``state.model_state``'s
    ``batch_stats``) of a flax msgpack checkpoint, written by either
    package, into ``model``; returns the whole payload."""
    from dynmm_tpu_torch.utils.checkpoint import load_checkpoint

    payload = load_checkpoint(path)
    state = payload["state"]
    load_flax_variables(model, {
        "params": state["params"],
        "batch_stats": state.get("model_state", {}).get("batch_stats")})
    return payload
