"""Mesh construction and sharding rules over ``torch.distributed`` (port of
``dynmm_tpu/parallel/mesh.py``).

The JAX package runs one program over a ('data', 'model') device mesh
(GSPMD): the batch shards over 'data', parameters are replicated, and the
wide kernels' output channels shard over 'model'; XLA inserts the
collectives, and the sharded step computes what the one-device step
computes. The port keeps that contract with one process a mesh position
(a rank), ranks laid out data-major (rank = d·M + m):

* the batch: each rank keeps (``shard_batch``) or is fed
  (``make_global_batch``, with a ``ProcessShard`` loader) the contiguous
  rows of its 'data' index;
* the rules: ``param_spec`` splits a conv's or linear layer's ``weight``
  along its output channels (torch dim 0, flax's last) over 'model' where
  that dim is ≥ ``min_out`` and divisible by the axis; biases, BN and
  everything else are replicated. ``shard_params`` leaves each rank only
  its slice (a ``torch.nn.utils.parametrize`` parametrization whose
  ``original`` is the slice and whose value is the gathered weight, for
  the readers of a whole weight); the port's ``Conv2d`` computes its own
  output slice in training and gathers the output
  (``nn/layers.py::Conv2d.forward_model_shard``), while a split linear
  layer (and any other reader) computes the whole output from the
  gathered weight, whose backward hands each rank its slice's gradient;
* ``place_model``: replicate from rank 0, shard, and sum the train-mode BN
  statistics over 'data' (``BatchNorm2d.sync_group``);
* the step's reductions (``train/seg.py``): the loss terms summed over
  'data' before their quotients, the gradients summed over 'data'
  (``sum_gradients``) for the global loss, each rank's loss its 1/D share.

Every collective is an all-reduce (``parallel/collectives.py``), so the same
code runs on gloo with CPU tensors, on gloo with CUDA tensors (ranks that
share a card) and on NCCL. The ranks start through
``parallel/launch.py::run_ranks`` or ``torchrun``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

from dynmm_tpu_torch.parallel.collectives import all_sum, gather_slices
from dynmm_tpu_torch.utils.device import resolve_device

# Minimum output-channel width before a kernel is worth sharding over 'model'
MODEL_SHARDING_RULES = {"min_out_channels": 256}
_SLICE = ".parametrizations.weight.original"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh: its coordinates, the
    process groups of its 'data' column and 'model' row (None where the
    axis has one rank), the group of every rank of the mesh, and its
    device."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    group: Any
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n``."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.n_data} data ranks")
        per = n // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """Σ over the 'data' axis (differentiable)."""
        return all_sum(t, self.data_group)

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The global batch of every 'data' rank's equal rows."""
        return gather_slices(local, self.data_group, self.data_index, 0)


def rank_device(device=None) -> torch.device:
    """The device of this rank: the CPU, or the card ``LOCAL_RANK`` (else
    the rank) modulo the number of cards."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def _group(ranks) -> Any:
    """A process group of ``ranks`` (every rank of the world calls this in
    the same order), or None for one rank."""
    ranks = [int(r) for r in ranks]
    return dist.new_group(ranks) if len(ranks) > 1 else None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Optional[Mesh]:
    """The (data, model) mesh over the first ``n_data · n_model`` ranks of
    the live world (``n_data`` None: world // n_model). Every rank of the
    world must call it; a rank outside the mesh gets None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    grid = np.arange(n_data * n_model).reshape(n_data, n_model)
    data_groups = [_group(grid[:, m]) for m in range(n_model)]
    model_groups = [_group(grid[d]) for d in range(n_data)]
    everyone = (dist.group.WORLD if n_data * n_model == world
                else _group(grid.reshape(-1)))
    if rank >= n_data * n_model:
        return None
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d],
                everyone, rank_device(device))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tensor(x, device) -> torch.Tensor:
    return (x if torch.is_tensor(x)
            else torch.as_tensor(np.asarray(x))).to(device)


def replicate(tree, mesh: Mesh):
    """Rank 0's value on every rank of the mesh: the arrays of a tree (on
    the mesh's device), or a module's parameters and buffers, in place."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in itertools.chain(tree.parameters(), tree.buffers()):
                dist.broadcast(t.data, src=0, group=mesh.group)
        return tree

    def put(x):
        t = _tensor(x, mesh.device).contiguous()
        dist.broadcast(t, src=0, group=mesh.group)
        return t

    return _map(put, tree)


def shard_batch(tree, mesh: Mesh):
    """This rank's contiguous rows of every array of a global batch, on the
    mesh's device."""
    def put(x):
        return _tensor(x[mesh.rows(x.shape[0])], mesh.device)

    return _map(put, tree)


def make_global_batch(tree, mesh: Mesh):
    """The global batch from the rows each rank is fed (a loader over a
    ``ProcessShard`` view): this rank's rows, on the mesh's device. No rank
    reads another's rows."""
    return _map(lambda x: _tensor(x, mesh.device), tree)


class ProcessShard:
    """Dataset view exposing only THIS process's contiguous slice (the
    host-local half of the input pipeline; pair with
    ``make_global_batch``). Non-index attributes delegate to the wrapped
    dataset. ``process_index``/``process_count`` default to the live
    world's rank and size (0 and 1 without one); pass them to lay out a
    world in tests."""

    def __init__(self, dataset, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        live = dist.is_available() and dist.is_initialized()
        self._ds = dataset
        self._count = (process_count if process_count is not None
                       else dist.get_world_size() if live else 1)
        self._index = (process_index if process_index is not None
                       else dist.get_rank() if live else 0)
        per = len(dataset) // self._count  # equal shards: the tail drops
        self._start = self._index * per
        self._len = per

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int):
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        return self._ds[self._start + idx]

    def __getattr__(self, name):
        return getattr(self._ds, name)


def param_spec(name: str, leaf: torch.Tensor, n_model: int,
               min_out: int) -> Optional[int]:
    """The dim of parameter ``name`` that shards over 'model' (0: the
    output channels of a conv's or linear layer's weight), or None for a
    replicated one (biases, BN, narrow kernels)."""
    if (n_model > 1 and name.rpartition(".")[2] == "weight"
            and leaf.dim() >= 2 and leaf.shape[0] >= min_out
            and leaf.shape[0] % n_model == 0):
        return 0
    return None


class _ModelSlice(nn.Module):
    """Parametrization of a weight split over 'model': ``original`` is
    this rank's slice, the value the gathered weight."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh

    def forward(self, local):
        return gather_slices(local, self.mesh.model_group,
                             self.mesh.model_index, 0)

    def right_inverse(self, full):
        return local_slice(full, self.mesh)


def local_slice(full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a tensor split over 'model' along dim 0."""
    return full.chunk(mesh.n_model, 0)[mesh.model_index].clone()


def local_flax_slice(leaf, mesh: Mesh):
    """This rank's slice of a flax kernel (or any array shaped like one,
    e.g. its optimizer moment) whose torch weight splits over 'model':
    torch's dim 0 is flax's last axis. A lazy leaf
    (``utils/orbax.py::OrbaxArray``) reads only the chunks it covers."""
    k = leaf.shape[-1] // mesh.n_model
    return leaf[..., mesh.model_index * k:(mesh.model_index + 1) * k]


def canonical_name(name: str) -> str:
    """A parameter's name as the unsharded model names it."""
    return name.replace(_SLICE, ".weight")


def slice_name(name: str) -> str:
    """The state_dict key of a split weight's slice (``name`` ends with
    ``.weight``): the inverse of ``canonical_name``."""
    return name[:-len(".weight")] + _SLICE


def shard_params(model: nn.Module, mesh: Mesh,
                 min_out: Optional[int] = None) -> list[str]:
    """Leave this rank only its 'model' slice of every weight
    ``param_spec`` shards; returns their names. A sharded ``Conv2d``
    computes its output slice in training (``model_shard``); a sharded
    linear layer reads the gathered weight."""
    if min_out is None:
        min_out = MODEL_SHARDING_RULES["min_out_channels"]
    names = []
    for name, p in list(model.named_parameters()):
        if param_spec(name, p, mesh.n_model, min_out) is None:
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        if hasattr(type(module), "model_shard"):  # the port's Conv2d
            if module.padding_mode != "zeros" or (
                    module.groups > 1 and module.groups % mesh.n_model):
                raise ValueError(f"{name}: no output split for this conv")
            module.model_shard = mesh
        parametrize.register_parametrization(module, leaf, _ModelSlice(mesh),
                                             unsafe=True)
        names.append(name)
    return names


def place_model(model: nn.Module, mesh: Mesh,
                min_out: Optional[int] = None) -> list[str]:
    """Put ``model`` on the mesh for training: rank 0's weights and
    statistics everywhere, the 'model' slices of ``shard_params``, and
    train-mode BN over the global batch. Returns the sharded names."""
    replicate(model, mesh)
    names = shard_params(model, mesh, min_out)
    for m in model.modules():
        if hasattr(type(m), "sync_group"):  # the port's BatchNorm2d
            m.sync_group = mesh.data_group
    return names


def is_sharded(model: nn.Module) -> bool:
    return any(n.endswith(_SLICE) for n, _ in model.named_parameters())


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the unsharded model: every sharded weight gathered
    over 'model' (a collective: every rank of the mesh calls it)."""
    out = {}
    for key, value in model.state_dict().items():
        if key.endswith(_SLICE):
            owner = model.get_submodule(key[:-len(_SLICE)])
            value = owner.weight
        out[canonical_name(key)] = value
    return out


def sum_gradients(params, mesh: Mesh) -> None:
    """Sum the gradients of ``params`` over 'data' in one all-reduce a
    dtype (a missing gradient counts as zeros)."""
    if mesh.data_group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for dtype in sorted({p.dtype for p in params}, key=str):
        same = [p for p in params if p.dtype == dtype]
        flat = torch.cat([p.grad.reshape(-1) for p in same])
        dist.all_reduce(flat, group=mesh.data_group)
        for p, g in zip(same, flat.split([p.numel() for p in same])):
            p.grad.copy_(g.view(p.shape))
