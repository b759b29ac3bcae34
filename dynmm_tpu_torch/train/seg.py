"""Segmentation training and validation engine (port of
``dynmm_tpu/train/seg.py``; the reference's ``FusionDynMM/train.py`` and
the eval core of ``eval.py``).

* SGD (momentum 0.9, Nesterov) or Adam with L2 weight decay added to the
  gradient (optax's ``add_decayed_weights`` before ``sgd``/``adam``); the
  learning rate follows optax's ``cosine_onecycle_schedule`` stepped once per
  epoch (``onecycle_lr``); ``grad_accum`` follows ``optax.MultiSteps`` (the
  running mean of k gradients, one update every k-th batch); ``freeze``
  updates only the parameters whose name holds ``gate``.
* Loss: class-weighted multi-scale CE plus the FLOP-budget hinge,
  ``Σ CE_scale + loss_ratio · max(0, loss_flop − flop_budget)``.
* Temperature anneals exponentially; the stage flags per epoch are
  ``hard = epoch ≥ epoch_hard`` and ``ini = epoch < epoch_ini`` (the
  latter carries into validation).
* Validation per camera: eval forward → bilinear resize to the label size →
  first argmax → void mask → label − 1 → confusion matrix, mIoU. eval.py's
  chains: seeded noise injection (``noise_mode``, ``noise``, ``run_seed``:
  one ``np.random.default_rng(run_seed)`` across the cameras of a run, the
  noise on the raw layout, packed after), ``low_res_eval`` (argmax of the
  H/4 logits, nearest-resized at pixel centres to the label size, no valid
  loss) and ``serve_capacity_factor`` (``forward_routed_compact`` on the
  strict ``capacity_ladders`` of ``serve_ratios``, per batch size).
* ``fit`` writes what the JAX trainer writes: ``logs.csv`` (same header),
  ``confusion_matrices/cm_epoch_*.pickle``, the rolling
  ``ckpt_latest.msgpack``, periodic and best ``ckpt_epoch_*.msgpack`` and
  ``finished.txt``.

The train step runs the model in ``train()`` mode: every cell takes its
plain PyTorch version under autograd (the port's kernels, like the JAX
package's, are inference-only). A model in bf16 (``ESANetConfig.dtype``)
trains in bf16 with fp32 parameters, as the JAX trainer at ``--dtype
bfloat16``; its checkpoints hold the fp32 parameters. The optimizer state
is optax's layout (``SegOptimizer``), so a checkpoint resumes in either
package. Validation runs ``eval()`` after
``pack_weights``, so on the card the eval forward launches the kernels on
the trained weights. The engine trains every model of the family, on raw
or 2×2 packed stem inputs (``packed_stem``): the global-gate
SkipGateESANet (``dynamic``, ``global_gate``; FLOP loss), the local-gate
SkipESANet (``dynamic``: its Gumbel gates draw from the epoch's
generator; validation samples hard under ``test`` from a generator seeded
0 each batch, the JAX trainer's fixed key), the static ESANet and
ESANetOneModality (``modality`` rgb | depth, one input); the last three
have a zero FLOP loss. ``calibrate_quant`` is the int8 PTQ calibration
of eval.py's ``--quant int8`` (the global-gate net and the static ESANet).

Under a mesh (``SegTrainer(mesh=...)``, ``parallel/mesh.py``; one process a
rank) the step computes the one-process step on the global batch: the
model is placed before the first step (rank 0's weights everywhere, the
'model' slices of ``shard_params`` with their optimizer state, BN
statistics over the global batch); each rank takes its rows of every batch
(an eval batch that does not split runs whole on every rank, as in JAX);
the class-weighted CE's sums, the FLOP loss's mean and the gate's random
draws are the global batch's; each rank's loss is its 1/D share and the
gradients are summed over 'data'. Validation sums the confusion matrices
and the loss sums over 'data'. Only rank 0 writes logs and checkpoints;
every rank takes part in gathering the state it writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from torch.nn.utils import parametrize

from dynmm_tpu_torch.core.gates import batch_rows
from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.core.schedules import ExpDecayTemp
from dynmm_tpu_torch.data.seg_preprocessing import (inject_eval_noise,
                                                    pack_stem_batch)
from dynmm_tpu_torch.models.skip_gate import capacity_ladders
from dynmm_tpu_torch.nn.layers import (first_argmax, pack_weights,
                                       resize_bilinear, resize_nearest_centers)
from dynmm_tpu_torch.parallel.collectives import gather_slices
from dynmm_tpu_torch.parallel.mesh import (canonical_name, full_state_dict,
                                           is_sharded, local_slice,
                                           place_model, shard_batch,
                                           sum_gradients)
from dynmm_tpu_torch.train.metrics import ConfusionMatrix, confusion_update_counts
from dynmm_tpu_torch.train.seg_losses import StreamingValidLoss, multiscale_ce
from dynmm_tpu_torch.utils.checkpoint import save_ckpt, save_ckpt_every_epoch
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.logger import CSVLogger
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           flax_params_tree,
                                           load_flax_variables,
                                           tensors_from_flax_tree)

DOWN_RATES = (8, 16, 32)
# the opt_state layout PRs before the optax one wrote (still read)
OPT_STATE_FORMAT = "dynmm_tpu_torch"
# optax state key → torch.optim state key, per optimizer
_MOMENTS = {"SGD": {"trace": "momentum_buffer"},
            "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"}}
# the same for the port's former layout
_OLD_MOMENTS = {**_MOMENTS, "SGD": {"momentum": "momentum_buffer"}}


@dataclasses.dataclass
class SegTrainConfig:
    epochs: int = 500
    lr: float = 0.01
    optimizer: str = "SGD"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    batch_size: int = 8
    loss_ratio: float = 0.0
    flop_budget: float = 0.0
    temp: float = 1.0
    end_temp: float = 0.001
    epoch_ini: int = 0
    epoch_hard: int = 500
    eval_every: int = 2
    save_every: int = 100
    baseline: bool = False
    freeze: bool = False
    soft_eval: bool = False
    dynamic: bool = True
    global_gate: bool = True
    grad_accum: int = 1  # optimizer step every N batches (optax.MultiSteps)
    modality: str = "rgbd"
    debug: bool = False  # one batch per train/valid pass
    # 2×2 space-to-depth packed stem inputs (raw batches are packed in the
    # loops; a loader with the pack_stem_batch hook packs them already)
    packed_stem: bool = False
    # eval.py --output_res quarter: argmax the H/4 logits, nearest-resize
    # the class map to the label size; no valid loss
    low_res_eval: bool = False
    # > 0: eval through forward_routed_compact on the strict capacity
    # schedule of the trainer's serve_ratios (eval.py --capacity_factor)
    serve_capacity_factor: float = 0.0


def onecycle_lr(cfg: SegTrainConfig) -> Callable[[int], float]:
    """Per-epoch learning rate: optax's ``cosine_onecycle_schedule`` over
    ``cfg.epochs`` (pct_start 0.1, div_factor 25, final_div_factor 1e4),
    computed as optax computes it (cosine interpolation between cumulative
    values on [0, ⌊0.1·E⌋), [⌊0.1·E⌋, E), the last value after). Below 5
    epochs, and wherever the schedule is not finite (optax gives NaN when
    ⌊0.1·E⌋ = 0, i.e. for 5 ≤ E < 10), the constant ``cfg.lr``, as the JAX
    trainer falls back."""
    if cfg.epochs < 5:
        return lambda epoch: cfg.lr
    bounds = np.array([0, int(0.1 * cfg.epochs), int(cfg.epochs)])
    values = np.cumprod([cfg.lr / 25.0, 25.0, 1.0 / (25.0 * 1e4)])
    sizes = bounds[1:] - bounds[:-1]

    def schedule(epoch: int) -> float:
        with np.errstate(invalid="ignore", divide="ignore"):
            inside = (bounds[:-1] <= epoch) & (epoch < bounds[1:])
            pct = (epoch - bounds[:-1]) / sizes
            interp = values[1:] + (values[:-1] - values[1:]) / 2.0 * (
                np.cos(np.pi * pct) + 1)
            lr = float(inside.dot(interp) + (bounds[-1] <= epoch) * values[-1])
        return lr if math.isfinite(lr) else cfg.lr

    return schedule


class SegOptimizer:
    """The JAX trainer's optimizer on the port's parameters.

    SGD: ``torch.optim.SGD(nesterov=True, weight_decay=wd)``, which is
    optax's ``add_decayed_weights(wd)`` then ``sgd(lr, momentum,
    nesterov=True)`` (the momentum buffer starts at the first gradient,
    optax's trace at 0: the same first step). Adam: ``torch.optim.Adam``
    with ``weight_decay`` (L2 on the gradient, not AdamW), optax's
    ``add_decayed_weights`` then ``adam(b1=0.9, b2=0.999, eps=1e-8)``.
    Every trained parameter takes a step each update, a zero gradient where
    the forward did not reach it (the gate under ``baseline`` or
    ``ini_stage``), so weight decay reaches it as in optax.

    ``grad_accum`` = k > 1: the gradients are averaged as
    ``optax.MultiSteps`` does (``acc += (g − acc)/(n + 1)``) and the update
    is applied at every k-th ``step``. ``freeze`` (dynamic models): only
    parameters whose name holds ``gate`` are trained; the others get
    ``requires_grad=False`` and no update, not even weight decay.

    ``state_tree()`` is the checkpoint's ``opt_state`` in the layout the
    JAX trainer writes, ``flax.serialization.to_state_dict`` of its optax
    state (``dynmm_tpu/train/seg.py::make_seg_optimizer``), so either
    package resumes the other's checkpoint::

        base = {count, hyperparams: {learning_rate}, hyperparams_states: {},
                inner_state: {"0": {}, "1": {"0": X, "1": {}}}}
        X    = {trace}                  (SGD: the momentum buffers)
             | {count, mu, nu}          (Adam: exp_avg, exp_avg_sq, step)
        grad_accum > 1: {mini_step, gradient_step, inner_opt_state: base,
                         acc_grads, skip_state: {}}
        freeze: {inner_states: {train: {inner_state: <the above>},
                                freeze: {inner_state: {}}}}

    ``trace``, ``mu``, ``nu`` and ``acc_grads`` are params trees
    (``utils/weights.py::flax_params_tree``; zeros where the torch state is
    not made yet), a frozen parameter's leaf an empty dict (optax's
    ``MaskedNode``); the counters are int32, ``learning_rate`` the last
    ``set_lr`` in the parameters' float dtype (float32; float64 for a
    float64 model, as optax under x64). ``load_state_tree`` reads this
    layout, and the port's former ``{"format": "dynmm_tpu_torch", ...}``
    one; a layout that does not fit the config raises ``ValueError``.
    """

    def __init__(self, cfg: SegTrainConfig, model: nn.Module):
        self.cfg = cfg
        named = dict(model.named_parameters())
        self.frozen: dict[str, torch.Tensor] = {}
        if cfg.freeze and cfg.dynamic:
            for name, p in named.items():
                if "gate" not in name:
                    p.requires_grad_(False)
            self.frozen = {n: p for n, p in named.items() if "gate" not in n}
            named = {n: p for n, p in named.items() if "gate" in n}
        self.named = named
        params = list(named.values())
        if cfg.optimizer == "SGD":
            self.opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                                       nesterov=True,
                                       weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "Adam":
            self.opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                        eps=1e-8,
                                        weight_decay=cfg.weight_decay)
        else:
            raise NotImplementedError(
                "Currently only SGD and Adam as optimizers are supported. "
                f"Got {cfg.optimizer}")
        self.count = 0
        self.mini_step = 0
        self.acc: dict[str, torch.Tensor] = {}
        self.mesh, self.sharded = None, frozenset()

    def place(self, model: nn.Module, mesh, sharded) -> None:
        """Re-point at ``model``'s parameters after ``place_model`` left
        this rank only its 'model' slices of the weights named in
        ``sharded``: their moments and accumulated gradients are sliced
        too."""
        self.mesh, self.sharded = mesh, frozenset(sharded)

        def cut(name, t):
            if name in self.sharded and torch.is_tensor(t) and t.dim():
                return local_slice(t, mesh)
            return t

        params = {canonical_name(n): p for n, p in model.named_parameters()}
        state = {n: {k: cut(n, v) for k, v in self.opt.state[p].items()}
                 for n, p in self.named.items() if p in self.opt.state}
        lr = self.opt.param_groups[0]["lr"]
        self.named = {n: params[n] for n in self.named}
        self.frozen = {n: params[n] for n in self.frozen}
        self.opt = type(self.opt)(list(self.named.values()),
                                  **{**self.opt.defaults, "lr": lr})
        for n, st in state.items():
            self.opt.state[self.named[n]] = st
        self.acc = {n: cut(n, t) for n, t in self.acc.items()}

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` of parameter ``name`` whole: a sharded one's slices
        gathered over 'model' (every rank of the mesh calls this)."""
        if name not in self.sharded:
            return t
        with torch.no_grad():
            return gather_slices(t, self.mesh.model_group,
                                 self.mesh.model_index, 0)

    def set_lr(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Apply (or, under ``grad_accum``, accumulate) the gradients that
        ``backward`` left on the trained parameters."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.named.items()}
        k = self.cfg.grad_accum
        if k > 1:
            n = self.mini_step
            for name, g in grads.items():
                acc = self.acc.get(name)
                self.acc[name] = (g.clone() if acc is None
                                  else acc + (g - acc) / (n + 1))
            self.mini_step = (n + 1) % k
            if self.mini_step:
                self.zero_grad()
                return
            grads, self.acc = self.acc, {}
        for name, p in self.named.items():
            p.grad = grads[name]
        self.opt.step()
        self.zero_grad()
        self.count += 1

    # ------------------------------------------------------------ checkpoint
    def _tree(self, key: str | None = None) -> dict:
        """The params tree of the torch state ``key`` of every trained
        parameter (zeros where not made yet; None: ``acc``)."""
        if key is None:
            values = {n: self.acc.get(n, torch.zeros_like(p))
                      for n, p in self.named.items()}
        else:
            values = {n: self.opt.state.get(p, {}).get(key,
                                                       torch.zeros_like(p))
                      for n, p in self.named.items()}
        values = {n: self._full(n, t) for n, t in values.items()}
        return flax_params_tree(values, self.frozen)

    def state_tree(self) -> dict:
        count = np.asarray(self.count, np.int32)
        p = next(iter(self.named.values()))
        dtype = torch.empty((), dtype=p.dtype).numpy().dtype
        inner: dict = {k: self._tree(v)
                       for k, v in _MOMENTS[self.cfg.optimizer].items()}
        if self.cfg.optimizer == "Adam":
            inner = {"count": count, **inner}
        out = {"count": count,
               "hyperparams": {"learning_rate": np.asarray(
                   self.opt.param_groups[0]["lr"], dtype)},
               "hyperparams_states": {},
               "inner_state": {"0": {}, "1": {"0": inner, "1": {}}}}
        if self.cfg.grad_accum > 1:
            out = {"mini_step": np.asarray(self.mini_step, np.int32),
                   "gradient_step": count, "inner_opt_state": out,
                   "acc_grads": self._tree(), "skip_state": {}}
        if self.frozen:
            out = {"inner_states": {"train": {"inner_state": out},
                                    "freeze": {"inner_state": {}}}}
        return out

    def load_state_tree(self, tree) -> None:
        """Restore an ``opt_state`` of ``state_tree``'s layout (written by
        either package) or of the port's former one. Raises ``ValueError``,
        naming both layouts, on one that does not fit this config, as the
        JAX trainer's ``load_ckpt`` does."""
        if isinstance(tree, dict) and tree.get("format") == OPT_STATE_FORMAT:
            self._load_former(tree)
            return
        want = self.state_tree()
        where = _layout_mismatch(tree, want)
        if where is not None:
            raise ValueError(
                f"checkpoint opt_state is {layout_name(tree)}, this trainer's "
                f"optimizer is {layout_name(want)} (they differ at {where})")
        if self.frozen:
            tree = tree["inner_states"]["train"]["inner_state"]
        mini_step, acc = 0, None
        if self.cfg.grad_accum > 1:
            mini_step, acc = int(tree["mini_step"]), tree["acc_grads"]
            tree = tree["inner_opt_state"]
        inner = tree["inner_state"]["1"]["0"]
        self._restore(int(tree["count"]), mini_step, inner, acc,
                      _MOMENTS[self.cfg.optimizer])
        self.set_lr(float(tree["hyperparams"]["learning_rate"]))

    def _load_former(self, tree: dict) -> None:
        if tree["optimizer"] != self.cfg.optimizer:
            raise ValueError(f"checkpoint optimizer {tree['optimizer']} "
                             f"!= {self.cfg.optimizer}")
        self._restore(int(tree["count"]), int(tree["mini_step"]), tree,
                      tree.get("acc_grads"), _OLD_MOMENTS[self.cfg.optimizer])

    def _restore(self, count: int, mini_step: int, moments: dict, acc,
                 keys: dict) -> None:
        self.count, self.mini_step = count, mini_step
        self.opt.state.clear()
        for tree_key, state_key in keys.items():
            if tree_key not in moments:
                continue
            for name, t in tensors_from_flax_tree(moments[tree_key],
                                                  self.named).items():
                p = self.named[name]
                self.opt.state[p][state_key] = t.to(p.device, p.dtype)
        if self.cfg.optimizer == "Adam":
            for st in self.opt.state.values():
                st["step"] = torch.tensor(float(self.count))
        self.acc = ({} if acc is None else {
            n: t.to(self.named[n].device, self.named[n].dtype)
            for n, t in tensors_from_flax_tree(acc, self.named).items()})


def layout_name(tree) -> str:
    """A readable name of an optax ``opt_state`` tree's layout."""
    if not isinstance(tree, dict):
        return f"a {type(tree).__name__}"
    if tree.get("format") == OPT_STATE_FORMAT:
        return f"the port's former layout ({tree.get('optimizer')})"
    if "inner_states" in tree:
        branches = tree["inner_states"]
        parts = [f"{k}: {layout_name(v.get('inner_state'))}"
                 if v.get("inner_state") else k for k, v in branches.items()]
        return f"multi_transform({', '.join(parts)})"
    if "inner_opt_state" in tree:
        return f"MultiSteps({layout_name(tree['inner_opt_state'])})"
    if "hyperparams" in tree:
        inner = tree.get("inner_state", {}).get("1", {}).get("0", {})
        if "trace" in inner:
            return "SGD"
        if "mu" in inner:
            return "Adam"
        return "inject_hyperparams(?)"
    return f"an optax state with keys {sorted(tree)}"


def _layout_mismatch(got, want, path: str = "") -> str | None:
    """The first path where ``got`` differs from ``want`` in keys or leaf
    shapes, or None."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return path or "/"
        if set(got) != set(want):
            return f"{path or '/'} (keys {sorted(got)} vs {sorted(want)})"
        for k in want:
            where = _layout_mismatch(got[k], want[k], f"{path}/{k}")
            if where is not None:
                return where
        return None
    if isinstance(got, dict) or np.shape(got) != np.shape(want):
        return path
    return None


def make_seg_optimizer(cfg: SegTrainConfig, model: nn.Module) -> SegOptimizer:
    """The optimizer of ``cfg`` over ``model``'s parameters (the JAX
    package's name for it)."""
    return SegOptimizer(cfg, model)


class TrainState:
    """The model and its optimizer; ``tree()`` is the checkpoint's ``state``
    (``{params, model_state: {batch_stats}, opt_state}``, flax layout, numpy
    copies on the host) and ``load_tree`` restores one written by either
    package."""

    def __init__(self, model: nn.Module, optimizer: SegOptimizer):
        self.model = model
        self.optimizer = optimizer

    def tree(self) -> dict:
        v = flax_from_state_dict(full_state_dict(self.model))
        return {"params": v["params"],
                "model_state": {"batch_stats": v["batch_stats"]},
                "opt_state": self.optimizer.state_tree()}

    def load_tree(self, tree: dict) -> None:
        """Load the optimizer state (first: a layout that does not fit
        raises before anything changes) and the weights."""
        if "opt_state" not in tree:
            raise ValueError("checkpoint state holds no opt_state")
        if is_sharded(self.model):
            raise ValueError("load a checkpoint before the mesh places the "
                             "model (before the first step)")
        self.optimizer.load_state_tree(tree["opt_state"])
        load_flax_variables(self.model, {
            "params": tree["params"],
            "batch_stats": tree.get("model_state", {}).get("batch_stats")})


def _quiet(*args, **kwargs) -> None:
    """The log of a mesh rank other than 0."""


class SegTrainer:
    """Engine for the segmentation models on one device (``None``: the
    card; pass ``device="cpu"`` for the CPU), or on this rank's place of a
    ``mesh`` (``parallel/mesh.py``; its device; weights of at least
    ``min_out`` output channels split over its 'model' axis, by default
    ``MODEL_SHARDING_RULES``). The model moves there in channels_last
    memory."""

    def __init__(self, model: nn.Module, cfg: SegTrainConfig, class_weights,
                 device=None, mesh=None, min_out: Optional[int] = None):
        if cfg.dynamic and cfg.modality != "rgbd":
            raise ValueError("the dynamic models take --modality rgbd")
        self.cfg = cfg
        self.mesh, self.min_out = mesh, min_out
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.class_weights = torch.as_tensor(
            np.asarray(class_weights, np.float32), device=self.device)
        # estimated branch ratios for serve_capacity_factor's schedule (set
        # by the eval CLI before validation)
        self.serve_ratios = None

    def init_state(self) -> TrainState:
        """The model (which holds its weights already, where the JAX
        trainer initialises them here) and a fresh optimizer. Under a mesh
        the first step places them (``place``): load checkpoints before."""
        return TrainState(self.model, make_seg_optimizer(self.cfg, self.model))

    def place(self, state) -> None:
        """Under a mesh, once: the model (a ``TrainState``'s, with its
        optimizer, or a bare one) on the mesh (``parallel/mesh.py::
        place_model``)."""
        model = state.model if hasattr(state, "model") else state
        if self.mesh is None or getattr(model, "mesh_placed", False):
            return
        sharded = place_model(model, self.mesh, self.min_out)
        if hasattr(state, "optimizer"):
            state.optimizer.place(model, self.mesh, sharded)
        model.mesh_placed = True

    @contextlib.contextmanager
    def _on_mesh(self, start: int, total: int):
        """A forward over rows ``start:`` of a global batch of ``total``:
        the gathered weights cached for the pass, the random draws the
        global batch's rows."""
        if self.mesh is None:
            yield
            return
        with parametrize.cached(), batch_rows(start, total):
            yield

    def _shard(self, n: int) -> Optional[slice]:
        """This rank's rows of a batch of ``n``, or None: no mesh, or a
        batch that does not split over 'data' (it runs whole)."""
        if self.mesh is None or n % self.mesh.n_data:
            return None
        return self.mesh.rows(n)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _packed(self, image, depth):
        """``(image, depth)`` 2×2-packed under ``packed_stem``
        (``pack_stem_batch``: raw inputs of even size only)."""
        if not self.cfg.packed_stem:
            return image, depth
        batch = pack_stem_batch({"image": image, "depth": depth})
        return batch["image"], batch["depth"]

    def _inputs(self, image, depth) -> tuple:
        """The model's positional inputs for ``modality`` (rgbd | rgb |
        depth)."""
        if self.cfg.modality == "rgbd":
            return image, depth
        return (image,) if self.cfg.modality == "rgb" else (depth,)

    @property
    def _global(self) -> bool:
        return self.cfg.dynamic and self.cfg.global_gate

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ steps
    def train_step(self, state: TrainState, image, depth, targets, temp: float,
                   hard: bool, ini: bool, generator: torch.Generator):
        """One forward/backward/update on a batch: (total, per-scale losses
        (4,), loss_flop), as tensors."""
        cfg, mesh = self.cfg, self.mesh
        model = state.model
        model.train()
        inputs = self._inputs(image, depth)
        n = image.shape[0]
        start = 0 if mesh is None else mesh.data_index * n
        with self._on_mesh(start, n if mesh is None else n * mesh.n_data):
            if self._global:
                preds, loss_flop = model(*inputs, temp=temp, hard=hard,
                                         baseline=cfg.baseline, ini_stage=ini,
                                         generator=generator)
            else:
                if cfg.dynamic:  # local gates: sampled, no resource loss
                    preds = model(*inputs, generator, temp=temp, hard=hard,
                                  ini_stage=ini)
                else:
                    preds = model(*inputs)
                loss_flop = preds[0].new_zeros(())
        reduce = None
        if mesh is not None and mesh.n_data > 1:
            reduce = mesh.sum_data
            if self._global:  # the mean over the global batch
                loss_flop = reduce(loss_flop) / mesh.n_data
        loss_seg, per_scale = multiscale_ce(preds, targets, self.class_weights,
                                            reduce)
        total = loss_seg
        if cfg.loss_ratio > 0:
            total = total + cfg.loss_ratio * torch.clamp(
                loss_flop - cfg.flop_budget, min=0.0)
        state.optimizer.zero_grad()
        if mesh is None:
            total.backward()
        else:  # every rank's share of the global loss; Σ over 'data'
            (total / mesh.n_data).backward()
            sum_gradients(state.optimizer.named.values(), mesh)
        state.optimizer.step()
        return total.detach(), torch.stack(per_scale).detach(), loss_flop.detach()

    # ------------------------------------------------------------------ loops
    def train_one_epoch(self, state: TrainState, loader, epoch: int,
                        lr: float, temp: float):
        cfg = self.cfg
        hard, ini = epoch >= cfg.epoch_hard, epoch < cfg.epoch_ini
        self.place(state)
        state.optimizer.set_lr(lr)
        generator = torch.Generator().manual_seed(epoch)
        t0 = time.time()
        totals, per_scales, flops = [], [], []
        for batch in loader:
            targets = [batch["label"]] + [batch["label_down"][r]
                                          for r in DOWN_RATES]
            image, depth = self._packed(batch["image"], batch["depth"])
            arrays = [image, depth, *targets]
            # a mesh rank's rows (a batch that does not split raises)
            image, depth, *targets = (
                [self._tensor(a) for a in arrays] if self.mesh is None
                else shard_batch(arrays, self.mesh))
            total, per_scale, loss_flop = self.train_step(
                state, image, depth, targets, temp, hard, ini, generator)
            total = float(total)
            if np.isnan(total):
                raise ValueError("Loss is None")
            totals.append(total)
            per_scales.append(per_scale.cpu().numpy())
            flops.append(float(loss_flop))
            if cfg.debug:
                break
        per_scales = np.mean(per_scales, axis=0)
        logs = {
            "epoch": epoch,
            "lr_0": lr,
            "time_training": time.time() - t0,
            "loss_train_total": float(np.mean(totals)),
            "loss_flop": float(np.mean(flops)) if cfg.loss_ratio > 0 else 0.0,
            "loss_train_full_size": float(per_scales[0]),
        }
        for i, r in enumerate(DOWN_RATES):
            logs[f"loss_train_down_{r}"] = float(per_scales[i + 1])
        return state, logs

    def calibrate_quant(self, state, loader, n_batches: int = 8,
                        estimator: str = "absmax", percentile: float = 99.9):
        """int8 PTQ calibration (``utils/quantize.py``) of the model (a
        ``TrainState`` or the model) over the first ``n_batches`` clean
        batches of ``loader``, with the serving input prep (modality
        selection, ``packed_stem`` packing): the dense forward, hard-gated
        for the global-gate net (``baseline`` as configured), in fp32
        whatever the model's compute dtype; then ``select_scales`` and
        ``pack_int8`` (``utils/quantize.py::quantize_int8``). The model's
        quantized convs hold the scales and int8 weights afterwards;
        returns the model."""
        from dynmm_tpu_torch.utils.quantize import quantize_int8

        model = state.model if hasattr(state, "model") else state

        def batches():
            for batch in itertools.islice(iter(loader), n_batches):
                image, depth = self._packed(batch["image"], batch["depth"])
                yield self._inputs(self._tensor(image), self._tensor(depth))

        kwargs = {}
        if self._global:
            kwargs = dict(hard=True, baseline=bool(self.cfg.baseline))
        quantize_int8(model, batches(), estimator, percentile, **kwargs)
        return model

    def validate(self, state, loader, logs: Optional[dict] = None,
                 noise_mode: int = -1, noise: float = 0.0, run_seed: int = 0,
                 valid_loss: Optional[StreamingValidLoss] = None,
                 collect_weights: Optional[GateStats] = None,
                 ini_stage: bool = False, out_cms: Optional[dict] = None):
        """Per-camera eval: returns ({camera: miou}, logs). ``noise_mode``
        ≥ 0 injects eval.py's noise (``inject_eval_noise``) from one
        generator seeded with ``run_seed``. ``out_cms`` (if given) is filled
        with {camera: confusion matrix array}. Under a mesh every rank
        calls it and gets the global results."""
        self.place(state)
        cached = (parametrize.cached() if self.mesh is not None
                  else contextlib.nullcontext())
        with cached:  # a sharded weight gathered once for the pass
            return self._validate(state, loader, logs, noise_mode, noise,
                                  run_seed, valid_loss, collect_weights,
                                  ini_stage, out_cms)

    def _validate(self, state, loader, logs, noise_mode, noise, run_seed,
                  valid_loss, collect_weights, ini_stage, out_cms):
        logs = logs if logs is not None else {}
        n_classes = int(self.class_weights.shape[0])
        cameras = getattr(loader.dataset, "cameras", ("kv1",))
        split = getattr(loader.dataset, "split", "test")
        model = state.model if hasattr(state, "model") else state
        model.eval()
        pack_weights(model)  # the kernels' weight copies from the trained ones
        rng = np.random.default_rng(run_seed)

        t_val0 = time.time()
        self._phase_forward = self._phase_post = self._phase_cm = 0.0
        miou = {}
        if valid_loss is not None:
            valid_loss.reset()
        for camera in cameras:
            cm = ConfusionMatrix(n_classes)
            camera_ctx = (loader.dataset.filter_camera(camera)
                          if hasattr(loader.dataset, "filter_camera")
                          else contextlib.nullcontext())
            with camera_ctx:
                self._validate_camera(model, loader, cm, noise_mode, noise,
                                      rng, valid_loss, collect_weights,
                                      ini_stage)
            if self.mesh is not None:
                cm.matrix = self._sum_data(cm.matrix)
            miou[camera] = cm.miou()
            logs[f"mIoU_{split}_{camera}"] = miou[camera]
            if out_cms is not None:
                out_cms[camera] = np.asarray(cm.matrix)
        logs["time_validation"] = time.time() - t_val0
        logs["time_forward"] = self._phase_forward
        logs["time_post_processing"] = self._phase_post
        logs["time_confusion_matrix"] = self._phase_cm
        if valid_loss is not None:
            if self.mesh is not None:
                valid_loss.total, valid_loss.pixels = (float(v) for v in (
                    self._sum_data(np.array([valid_loss.total,
                                             valid_loss.pixels]))))
            logs[f"loss_{split}"] = valid_loss.compute()
        return miou, logs

    def _sum_data(self, a: np.ndarray) -> np.ndarray:
        """Σ of a host array over the mesh's 'data' axis."""
        t = torch.as_tensor(a).to(self.device)
        return self.mesh.sum_data(t).cpu().numpy().astype(a.dtype)

    def _eval_forward(self, model, image, depth, ini_stage, generator):
        """(logits, weight) of the eval chain: the dense forward, or under
        ``serve_capacity_factor`` the strict compact one with caps from this
        batch's size (a ragged tail batch gets its own schedule)."""
        cfg = self.cfg
        hard = not cfg.soft_eval
        inputs = self._inputs(image, depth)
        if not self._global:
            if cfg.dynamic:
                if cfg.low_res_eval:
                    raise ValueError("low_res_eval supports global-gate / "
                                     "static models only")
                # the JAX trainer's fixed key: the same draws every batch
                logits, weights = model(
                    *inputs, torch.Generator().manual_seed(0), hard=hard,
                    test=True, return_weights=True)
                return logits, weights[-1]
            logits = model(*inputs, low_res=cfg.low_res_eval)
            return logits, logits.new_zeros((logits.shape[0], 0))
        if cfg.serve_capacity_factor > 0:
            if not hard or cfg.baseline or ini_stage:
                raise ValueError(
                    "serve_capacity_factor needs hard non-baseline non-ini "
                    "eval (it scores the serving chain)")
            if self.serve_ratios is None:
                raise ValueError(
                    "set trainer.serve_ratios (estimated branch ratios) "
                    "before capacity-factor validation")
            caps = capacity_ladders(self.serve_ratios, image.shape[0],
                                    capacity_factor=cfg.serve_capacity_factor)
            return model.forward_routed_compact(
                image, depth, caps=caps, strict_caps=True,
                low_res=cfg.low_res_eval, return_weight=True)
        return model(image, depth, hard=hard, baseline=cfg.baseline,
                     return_weight=True, low_res=cfg.low_res_eval,
                     ini_stage=ini_stage, generator=generator)

    def _validate_camera(self, model, loader, cm, noise_mode, noise, rng,
                         valid_loss, collect_weights, ini_stage):
        cfg = self.cfg
        n_classes = cm.n_classes
        # the reference's ini_stage flag persists into validation
        generator = torch.Generator().manual_seed(0) if ini_stage else None
        for batch in loader:
            image, depth = batch["image"], batch["depth"]
            if noise_mode >= 0:
                image, depth = inject_eval_noise(image, depth, noise_mode,
                                                 noise, rng)
            # packed after the noise: the draws are those of the raw layout
            image, depth = self._packed(image, depth)
            label_orig = batch.get("label_orig", batch.get("label"))
            label = batch.get("label")
            n = len(image)
            # a mesh rank scores its rows; a batch that does not split runs
            # whole everywhere and counts on the first data rank only
            rows = self._shard(n)
            counts = rows is not None or self.mesh is None or (
                self.mesh.data_index == 0)
            if rows is not None:
                image, depth, label_orig = (image[rows], depth[rows],
                                            label_orig[rows])
                label = None if label is None else label[rows]
            draws = (batch_rows(rows.start, n) if rows is not None
                     else contextlib.nullcontext())
            out_hw = (label_orig.shape[1], label_orig.shape[2])
            t0 = time.time()
            with torch.inference_mode():
                with draws:
                    logits, weight = self._eval_forward(
                        model, self._tensor(image), self._tensor(depth),
                        ini_stage, generator)
                if cfg.low_res_eval:
                    pred_full = resize_nearest_centers(first_argmax(logits),
                                                       out_hw)
                else:
                    pred_full = first_argmax(resize_bilinear(logits, out_hw))
                self._sync()
                self._phase_forward += time.time() - t0

                t0 = time.time()
                if (valid_loss is not None and label is not None and counts
                        and not cfg.low_res_eval):  # H/4 logits: no loss
                    valid_loss.add_batch(logits, self._tensor(label))
                if collect_weights is not None:
                    if rows is not None:
                        weight = self.mesh.gather_rows(weight.contiguous())
                    collect_weights.append(weight)
                label = self._tensor(label_orig)
                mask = label > 0
                lab, pred_m = label[mask] - 1, pred_full[mask]
                self._sync()
                self._phase_post += time.time() - t0

                t0 = time.time()
                if counts:
                    cm.matrix += confusion_update_counts(
                        lab, pred_m, n_classes).cpu().numpy()
                self._phase_cm += time.time() - t0
            if cfg.debug:
                break

    # ------------------------------------------------------------------- fit
    def fit(self, state: TrainState, train_loader, valid_loader, ckpt_dir: str,
            start_epoch: int = 0, best_miou: float = 0.0,
            best_miou_epoch: int = 0, log_fn=print):
        """Train ``cfg.epochs`` epochs from ``start_epoch``; returns
        (best state tree, best mIoU, its epoch). ``state`` holds the last
        epoch's model and optimizer afterwards. Under a mesh only rank 0
        logs and writes files."""
        cfg = self.cfg
        writes = self.mesh is None or self.mesh.rank == 0
        if not writes:
            log_fn = _quiet
        else:
            os.makedirs(os.path.join(ckpt_dir, "confusion_matrices"),
                        exist_ok=True)
        lr_sched = onecycle_lr(cfg)
        temp_sched = ExpDecayTemp(cfg.temp, cfg.end_temp, cfg.epoch_hard)
        cameras = getattr(valid_loader.dataset, "cameras", ("kv1",))
        split = getattr(valid_loader.dataset, "split", "test")

        log_keys = (
            [f"mIoU_{split}_{c}" for c in cameras]
            + ["epoch", "lr_0", "loss_train_total", "loss_train_full_size",
               "loss_flop"]
            + [f"loss_train_down_{r}" for r in DOWN_RATES]
            + [f"loss_{split}"]
            + ["time_training", "time_validation", "time_forward",
               "time_post_processing", "time_confusion_matrix"]
        )
        csvlogger = (CSVLogger(log_keys, os.path.join(ckpt_dir, "logs.csv"))
                     if writes else None)
        self.place(state)
        best_tree = state.tree()
        try:
            for epoch in range(start_epoch, cfg.epochs):
                assert cfg.epoch_ini <= cfg.epoch_hard
                lr = float(lr_sched(epoch))
                temp = float(temp_sched(epoch))
                state, logs = self.train_one_epoch(state, train_loader, epoch,
                                                   lr, temp)
                log_fn(f"Epoch {epoch} | Train loss "
                       f"{logs['loss_train_total']:.4f} | Flop loss "
                       f"{logs['loss_flop']:.4f} | Temperature {temp:.5f} | "
                       f"lr {lr:.6f}")
                if epoch == start_epoch or epoch % cfg.eval_every == 0:
                    cms: dict = {}
                    miou, logs = self.validate(
                        state, valid_loader, logs,
                        valid_loss=StreamingValidLoss(self.class_weights),
                        ini_stage=epoch < cfg.epoch_ini, out_cms=cms)
                    if writes:
                        with open(os.path.join(ckpt_dir, "confusion_matrices",
                                               f"cm_epoch_{epoch}.pickle"),
                                  "wb") as f:
                            pickle.dump(cms, f,
                                        protocol=pickle.HIGHEST_PROTOCOL)
                    cam0 = cameras[0]
                    if miou[cam0] > best_miou:
                        best_miou = miou[cam0]
                        best_miou_epoch = epoch
                        best_tree = state.tree()
                    log_fn(f"Test mIoU {miou[cam0]:.4f} | Best mIoU "
                           f"{best_miou:.4f} | Best epoch {best_miou_epoch}")
                tree = state.tree()  # under a mesh: gathered on every rank
                if writes:
                    csvlogger.write_logs(logs)
                    save_ckpt_every_epoch(ckpt_dir, tree, epoch, best_miou,
                                          best_miou_epoch)
                    if epoch >= 10 and (epoch % cfg.save_every
                                        == cfg.save_every - 1):
                        save_ckpt(ckpt_dir, tree, epoch)
            if writes:
                save_ckpt(ckpt_dir, best_tree, best_miou_epoch)
                with open(os.path.join(ckpt_dir, "finished.txt"), "w") as f:
                    f.write(f"best miou: {best_miou}\n")
                    f.write(f"best miou epoch: {best_miou_epoch}\n")
        finally:
            if csvlogger is not None:
                csvlogger.close()
        return best_tree, best_miou, best_miou_epoch
