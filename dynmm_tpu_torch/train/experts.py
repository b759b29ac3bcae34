"""Expert checkpoints of the two-step DynMM workflow (port of
``dynmm_tpu/train/experts.py``): train the expert branches first, then
graft them into a router and train its gate.

An expert file is flax's msgpack of ``{params, batch_stats}`` trees
(``utils/msgpack.py``), so either package reads the other's. Trees are the
flax layout of ``utils/weights.py::flax_variables``; ``inject_expert``
grafts one into a router's variables, which ``load_flax_variables`` then
loads.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Optional

import numpy as np

from dynmm_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize


def _to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_expert(path: str, params: dict, batch_stats: Optional[dict] = None
                ) -> str:
    payload = {"params": _to_numpy(params),
               "batch_stats": _to_numpy(batch_stats or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack_serialize(payload))
    return path


def save_state_expert(path: str, variables: dict,
                      sub: Optional[str] = None) -> str:
    """``save_expert`` of a trainer state's ``{params, model_state}``
    (``SupervisedState.variables()``), or of its submodule ``sub``, as the
    JAX expert CLIs write them."""
    params = variables["params"]
    stats = variables["model_state"].get("batch_stats")
    if sub is not None:
        params, stats = params[sub], (stats or {}).get(sub)
    return save_expert(path, params, stats)


def load_expert(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _restore(target, state, path: str = ""):
    """flax's ``from_state_dict`` on dict trees: ``target``'s structure with
    ``state``'s leaves; a key of ``target`` missing from ``state`` raises,
    extra keys of ``state`` are ignored."""
    if not isinstance(target, Mapping):
        return state
    missing = set(map(str, target)) - set(state)
    if missing:
        raise ValueError(f"the expert lacks {sorted(missing)} at {path or '/'}")
    return {k: _restore(v, state[str(k)], f"{path}/{k}")
            for k, v in target.items()}


def inject_expert(variables: dict, submodule: str, expert: dict,
                  expert_sub: Optional[str] = None) -> dict:
    """A copy of ``variables`` with the expert's trees grafted into
    ``params[submodule]`` and ``batch_stats[submodule]``; ``expert_sub``
    picks a subtree of the saved expert (e.g. its ``encoder``)."""

    def pick(tree):
        return tree[expert_sub] if expert_sub else tree

    out = {k: dict(v) for k, v in variables.items()}
    out["params"][submodule] = _restore(variables["params"][submodule],
                                        pick(expert["params"]))
    if expert.get("batch_stats") and submodule in variables.get(
            "batch_stats", {}):
        src = pick(expert["batch_stats"])
        if src:
            out["batch_stats"][submodule] = _restore(
                variables["batch_stats"][submodule], src)
    return out
