"""PyTorch checkpoint import for the port's CLIs (the counterpart of
``dynmm_tpu/utils/torch_import.py``, with its semantics).

The reference persists two checkpoint styles:
* FusionDynMM: dict checkpoints ``{epoch, state_dict, optimizer[, best_miou]}``
  (``src/utils.py:118-143``) or bare state_dicts — plain tensors;
* ModalityDynMM: whole pickled ``nn.Module`` objects (``torch.save(model,
  f)``), which normally need the defining classes; ``load_torch_module_pickle``
  rebuilds them from stub classes and walks ``_modules``/``_parameters``/
  ``_buffers`` for a state_dict.

Files are read with ``torch.load(weights_only=True)`` first, so a dict
checkpoint or a bare state_dict runs no code from the file; only a whole
pickled module, which that refuses, is unpickled in full.

``import_torch_checkpoint`` merges non-strictly, as the JAX importer's
``merge_into`` does: a key the model lacks is reported as ``unconsumed: …``
(returned and printed), a key the checkpoint lacks keeps the model's value,
a shape mismatch raises, and BN ``num_batches_tracked`` counters are
dropped. The port's modules carry the reference's torch names, so no key
translation is needed (the JAX package maps them to flax paths); a
``module.`` prefix (``nn.DataParallel``) is removed.
"""

from __future__ import annotations

import os
import pickle
import sys
import types

import torch


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` dict checkpoint (``{"state_dict": ...}``) or a bare
    state_dict, as CPU tensors, read with ``weights_only=True``: no code
    from the file runs. Only a file that this refuses (a whole pickled
    module) is unpickled in full, by ``load_torch_module_pickle``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return load_torch_module_pickle(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return _tensors(obj)


class _StubModule:
    """Generic shell standing in for any unimportable torch nn.Module class."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    def __call__(self, *a, **k):
        raise RuntimeError("stub module is not executable")


def load_torch_module_pickle(path: str) -> dict[str, torch.Tensor]:
    """A state_dict from a whole-module torch pickle, even when the defining
    classes (e.g. MultiBench's) are not importable. This runs the file's
    pickle code: read only files you trust."""

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_StubModule,), {"__module__": module})

    pm = types.ModuleType("stub_pickle")
    pm.__dict__.update(pickle.__dict__)
    pm.Unpickler = StubUnpickler
    with open(path, "rb") as f:
        obj = torch.load(f, map_location="cpu", weights_only=False,
                         pickle_module=pm)
    if isinstance(obj, dict):  # a dict checkpoint holding other objects
        return _tensors(obj.get("state_dict", obj))
    if isinstance(obj, torch.nn.Module):  # its classes are importable here
        return _tensors(obj.state_dict())

    state: dict[str, torch.Tensor] = {}

    def walk(mod, prefix=""):
        d = getattr(mod, "__dict__", {})
        for group in ("_parameters", "_buffers"):
            for name, t in (d.get(group) or {}).items():
                if t is not None:
                    state[prefix + name] = t.detach().cpu()
        for name, sub in (d.get("_modules") or {}).items():
            if sub is not None:
                walk(sub, prefix + name + ".")

    walk(obj)
    return state


def merge_state_dict(model: torch.nn.Module, sd: dict[str, torch.Tensor]
                     ) -> list[str]:
    """Copy ``sd`` into ``model`` non-strictly (``merge_into``'s rules);
    returns the ``unconsumed: <key>`` report."""
    own = model.state_dict()
    report, take = [], {}
    for key, value in sd.items():
        key = key.removeprefix("module.")
        if key.endswith("num_batches_tracked"):
            continue
        if key not in own:
            report.append(f"unconsumed: {key}")
            continue
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: ckpt "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(own[key].shape)}")
        take[key] = value
    # the missing keys keep the model's values; modules that keep
    # kernel-packed copies repack them from their load hook
    model.load_state_dict({**own, **take}, strict=True)
    return report


def import_torch_checkpoint(model: torch.nn.Module, path: str,
                            verbose: bool = True) -> list[str]:
    """Load a torch ``.pth``/``.pt`` checkpoint into ``model``; returns the
    unconsumed keys (printed, the first 10, as the JAX importer does)."""
    report = merge_state_dict(model, load_torch_state_dict(path))
    if verbose and report:
        print(f"torch import: {len(report)} unconsumed keys (first 10):")
        for r in report[:10]:
            print("  ", r)
    return report


def import_scenenet_pretrain(model: torch.nn.Module, path: str,
                             context_module: str = "ppm") -> list[str]:
    """SceneNet-pretrain warm start (build_model.py:180-206): the checkpoint
    without its (side-)output heads and the two learned logit upsamples
    (class counts differ), and without the context module's features when
    the target's context module is neither ppm nor appm."""
    sd = load_torch_state_dict(path)
    drop = [k for k in sd if "out" in k or "decoder.upsample1" in k
            or "decoder.upsample2" in k]
    if context_module not in ("ppm", "appm"):
        drop.extend(k for k in sd if "context_module.features" in k)
    for k in drop:
        sd.pop(k, None)
    report = merge_state_dict(model, sd)
    if report:
        print(f"scenenet import: {len(report)} unconsumed keys")
    return report


def load_any_checkpoint(model: torch.nn.Module, path: str) -> None:
    """The CLIs' checkpoint loader: a flax msgpack checkpoint of either
    package (``utils/weights.py::load_checkpoint_into``) or a torch
    ``.pth``/``.pt`` (``import_torch_checkpoint``). A missing file exits
    with status 1."""
    if not os.path.isfile(path):
        print(f"=> no checkpoint found at '{path}'")
        sys.exit(1)
    if path.endswith((".pth", ".pt")):
        import_torch_checkpoint(model, path)
        return
    from dynmm_tpu_torch.utils.weights import load_checkpoint_into

    load_checkpoint_into(model, path)
