"""Checkpoint save/load/resume in the JAX package's msgpack format (port of
``dynmm_tpu/utils/checkpoint.py``).

One flax msgpack file per checkpoint (``utils/msgpack.py``) holding

    {epoch, state: {params, model_state: {batch_stats}, opt_state},
     [best_miou, best_miou_epoch]}

``params`` and ``batch_stats`` are the flax trees (``utils/weights.py``), so
a checkpoint written by either package loads into the other. ``opt_state``
is optax's layout in both (``train/seg.py::SegOptimizer``): either package
resumes the other's optimizer, and a layout that does not fit the
trainer's config raises ``ValueError``.

``state`` is a nested dict of numpy arrays, or any object with a ``tree()``
method that returns one (``train/seg.py::TrainState``); ``load_ckpt`` with a
``target`` restores into it through ``target.load_tree``. Under a mesh
(``train/seg.py``) rank 0 writes the same file, the 'model' slices
gathered. Orbax checkpoints (the JAX package's ``save_orbax`` and
``load_orbax``) are not ported: they need ``orbax`` and ``tensorstore``,
which the card's installation lacks and the port may not import; the port
reads and writes msgpack only.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Optional

import numpy as np
import torch

from dynmm_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize


def _to_host(tree: Any) -> Any:
    if hasattr(tree, "tree"):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(path: str, state, epoch: int, **extra) -> str:
    payload = {"epoch": int(epoch), "state": _to_host(state),
               **{k: _to_host(v) for k, v in extra.items()}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(payload))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, target=None) -> dict:
    """The payload; with ``target`` its ``state`` is loaded into it
    (``target.load_tree``) and replaced by it."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    if target is not None:
        target.load_tree(payload["state"])
        payload["state"] = target
    return payload


def save_ckpt(ckpt_dir: str, state, epoch: int) -> str:
    """Periodic epoch checkpoint: ``ckpt_epoch_{epoch}.msgpack``."""
    return save_checkpoint(
        os.path.join(ckpt_dir, f"ckpt_epoch_{epoch}.msgpack"), state, epoch)


def save_ckpt_every_epoch(ckpt_dir: str, state, epoch: int, best_miou: float,
                          best_miou_epoch: int) -> str:
    """Rolling resume checkpoint: ``ckpt_latest.msgpack``."""
    return save_checkpoint(
        os.path.join(ckpt_dir, "ckpt_latest.msgpack"), state, epoch,
        best_miou=float(best_miou), best_miou_epoch=int(best_miou_epoch))


def load_ckpt(path: str, target=None):
    """Resume: returns (state, epoch, best_miou, best_miou_epoch)."""
    payload = load_checkpoint(path, target)
    return (payload["state"], int(payload["epoch"]),
            float(payload.get("best_miou", 0.0)),
            int(payload.get("best_miou_epoch", 0)))


def get_best_checkpoint(ckpt_dir: str, key: str = "mIoU_test") -> str:
    """The epoch checkpoint with the best metric ``key`` in ``logs.csv``
    (first row on ties, as ``pandas.idxmax``)."""
    with open(os.path.join(ckpt_dir, "logs.csv"), newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get(key, "") != ""]
    if not rows:
        raise ValueError(f"no {key} in {ckpt_dir}/logs.csv")
    values = np.array([float(r[key]) for r in rows])
    best = rows[int(values.argmax())]
    epoch = int(float(best["epoch"]))
    path = os.path.join(ckpt_dir, f"ckpt_epoch_{epoch}.msgpack")
    if not os.path.exists(path):
        raise FileNotFoundError(f"There is no weights file named {path}")
    print(f"Best {key}: {100 * values.max():0.2f} at epoch: {epoch}")
    return path
