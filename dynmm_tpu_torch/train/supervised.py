"""Supervised multimodal trainer (port of ``dynmm_tpu/train/supervised.py``;
the reference's ``training_structures/Supervised_Learning.py``).

* The optimizer steps the trainable parameters only (``trainable_pred`` on
  each parameter's flax path, the JAX trainer's freeze mask): a frozen
  parameter is left out of the optimizer and gets neither an update nor
  weight decay (optax's ``set_to_zero``). AdamW by default.
* Gradients are clipped to a global norm of ``clip_val`` as optax's
  ``clip_by_global_norm`` does (``g / ‖g‖ · max`` where ‖g‖ ≥ max, the
  norm over the trainable gradients); ``torch.nn.utils.clip_grad_norm_``
  divides by ‖g‖ + 1e-6 instead.
* Every trainable parameter gets a gradient each step, zeros where the
  forward did not reach it (the IMDB image branch), so weight decay reaches
  it as in optax.
* MoE models return ``(out, loss2, weight)``; the loss is ``loss1 +
  lossw · loss2`` (``lossw`` is the paper's λ).
* Model selection per task (accuracy, f1-macro, or −loss for regression),
  early stop once patience exceeds ``patience``; ``fit`` keeps a copy of the
  best epoch's weights and optimizer state and restores them at the end.
* Evaluation drops the padded rows of a tail batch (``Batch.valid``) and
  collects the gate weights in ``GateStats``.

Dropout draws from the ``torch.Generator`` given to ``train_epoch``/``fit``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.data.loader import ArrayLoader, Batch
from dynmm_tpu_torch.nn.mlp import set_dropout_generator
from dynmm_tpu_torch.train import metrics as M
from dynmm_tpu_torch.train.objectives import get_objective
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_flax_variables,
                                           tree_flax_path)


@dataclasses.dataclass
class SupervisedConfig:
    task: str = "classification"  # classification|multilabel|regression|posneg-classification
    objective: str = "cross_entropy"
    epochs: int = 50
    lr: float = 1e-4
    weight_decay: float = 0.01
    optimizer: str = "adamw"
    clip_val: float = 8.0
    early_stop: bool = True
    patience: int = 7
    lossw: float = 0.0          # λ on the resource loss
    additional_loss: bool = False  # model returns (out, loss2, weight)
    auprc: bool = False         # report AUPRC for binary classification


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` with optax's defaults: ``nu = (1 − decay)·g²
    + decay·nu`` from ``nu = 0``, then ``p −= lr · g / sqrt(nu + eps)``
    (decay 0.9, eps 1e-8 inside the square root; no momentum, not
    centred). ``torch.optim.RMSprop`` adds eps outside the square root."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                g = p.grad
                nu.copy_((1 - decay) * g.square() + decay * nu)
                p.sub_(group["lr"] * (g * torch.rsqrt(nu + eps)))


def make_optimizer(cfg: SupervisedConfig, params) -> torch.optim.Optimizer:
    """optax's ``adamw``/``adam`` (b1 0.9, b2 0.999, eps 1e-8),
    ``sgd(momentum=0.9, nesterov=True)`` and ``rmsprop`` over ``params``."""
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9,
                               nesterov=True)
    if cfg.optimizer == "rmsprop":
        return RMSprop(params, lr=cfg.lr)
    raise ValueError(cfg.optimizer)


class SupervisedOptimizer:
    """Global-norm clipping then ``make_optimizer`` over the named
    trainable parameters."""

    def __init__(self, cfg: SupervisedConfig,
                 named: dict[str, torch.nn.Parameter]):
        self.named = named
        self.clip_val = cfg.clip_val
        self.opt = make_optimizer(cfg, list(named.values()))

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.named.values()]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = norm < self.clip_val
        for p, g in zip(self.named.values(), grads):
            p.grad = torch.where(clip, g, g / norm * self.clip_val)
        self.opt.step()
        self.zero_grad()


class SupervisedState:
    """The model and its optimizer; ``variables()`` is the checkpoint's
    ``{params, model_state}`` in the flax layout."""

    def __init__(self, model: torch.nn.Module, optimizer: SupervisedOptimizer):
        self.model, self.optimizer = model, optimizer

    def variables(self) -> dict:
        """As the JAX trainer's state: ``model_state`` is empty for a model
        without BN statistics."""
        v = flax_variables(self.model)
        return {"params": v["params"],
                "model_state": ({"batch_stats": v["batch_stats"]}
                                if v["batch_stats"] else {})}

    def snapshot(self) -> dict:
        """Copies of the weights and the optimizer state, taken now."""
        return {"model": {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()},
                "optimizer": copy.deepcopy(self.optimizer.opt.state_dict())}

    def restore(self, snap: dict) -> None:
        self.model.load_state_dict(snap["model"])
        self.optimizer.opt.load_state_dict(snap["optimizer"])


class SupervisedTrainer:
    """Trainer for MMDL-style and DynMM (MoE) models on one device
    (``None``: the card; ``device="cpu"`` for the CPU).

    ``model_call(batch, train) -> (out, loss2, weight)`` adapts a model's
    signature (``train/adapters.py``); its model (``model_call.model``) moves
    to the device. ``trainable_pred(path)`` takes a parameter's flax path
    tuple (e.g. ``("gate", "fc1", "kernel")``).
    """

    def __init__(self, model_call: Callable, cfg: SupervisedConfig,
                 trainable_pred: Optional[Callable] = None, device=None):
        self.model_call = model_call
        self.cfg = cfg
        self.objective = get_objective(cfg.objective)
        self.trainable_pred = trainable_pred
        self.device = resolve_device(device)
        self.model = model_call.model.to(self.device)

    def init_state(self, variables: Optional[dict] = None) -> SupervisedState:
        """The state over the model, after loading flax ``variables`` into
        it when given. Frozen parameters get ``requires_grad=False``."""
        if variables is not None:
            load_flax_variables(self.model, variables)
        named = {}
        for name, p in self.model.named_parameters():
            path, _ = tree_flax_path(name, p.dim())
            train = self.trainable_pred is None or self.trainable_pred(path)
            p.requires_grad_(train)
            if train:
                named[name] = p
        return SupervisedState(self.model,
                               SupervisedOptimizer(self.cfg, named))

    # ------------------------------------------------------------------ steps
    def to_device_batch(self, batch: Batch) -> dict:
        """Float arrays in the model's dtype, lengths as int64, on the
        device."""
        dtype = next(self.model.parameters()).dtype

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            return t.to(dtype) if t.is_floating_point() else t.long()

        return {"inputs": [put(x) for x in batch.inputs],
                "label": put(batch.label),
                "lengths": ([put(l) for l in batch.lengths]
                            if batch.lengths else None)}

    def train_step(self, state: SupervisedState, batch: dict):
        """One update on a device batch; returns (loss, loss1) tensors."""
        out, loss2, _ = self.model_call(batch, train=True)
        loss1 = self.objective(out, batch["label"])
        loss = (loss1 + self.cfg.lossw * loss2 if self.cfg.additional_loss
                else loss1)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        return loss.detach(), loss1.detach()

    def _generator(self, generator: Optional[torch.Generator]):
        return (generator if generator is not None
                else torch.Generator(device=self.device).manual_seed(0))

    def train_epoch(self, state: SupervisedState, loader: ArrayLoader,
                    generator: Optional[torch.Generator] = None
                    ) -> tuple[SupervisedState, float]:
        set_dropout_generator(self.model, self._generator(generator))
        total, count = 0.0, 0
        for batch in loader:
            loss, _ = self.train_step(state, self.to_device_batch(batch))
            total += float(loss) * len(batch.label)
            count += len(batch.label)
        return state, total / max(count, 1)

    @torch.no_grad()
    def evaluate(self, state: SupervisedState, loader: ArrayLoader,
                 collect_weights: bool = False) -> dict:
        cfg = self.cfg
        stats = GateStats()
        preds, trues, losses, totals = [], [], 0.0, 0
        for batch in loader:
            dev = self.to_device_batch(batch)
            out, _loss2, w = self.model_call(dev, train=False)
            loss1 = float(self.objective(out, dev["label"]))
            out = out.float().cpu().numpy()
            w = None if w is None else w.float().cpu().numpy()
            label = batch.label
            if batch.valid is not None:
                out, label = out[batch.valid], label[batch.valid]
                if w is not None:
                    w = w[batch.valid]
            if collect_weights and w is not None:
                stats.append(w)
            losses += loss1 * len(label)
            totals += len(label)
            preds.append(out)
            trues.append(label)
        preds = np.concatenate(preds)
        trues = np.concatenate(trues)
        out = {"loss": losses / max(totals, 1)}
        if cfg.task == "classification":
            out["accuracy"] = M.accuracy(trues, preds.argmax(-1))
            if cfg.auprc and preds.shape[-1] == 2:
                exp = np.exp(preds - preds.max(-1, keepdims=True))
                scores = (exp / exp.sum(-1, keepdims=True))[:, 1]
                out["auprc"] = M.auprc(scores, trues)
        elif cfg.task == "multilabel":
            hard = (1 / (1 + np.exp(-preds)) >= 0.5).astype(np.int64)
            out["f1_micro"] = M.f1_score(trues, hard, "micro")
            out["f1_macro"] = M.f1_score(trues, hard, "macro")
        elif cfg.task == "posneg-classification":
            acc, corr = M.posneg_accuracy_corr(trues, preds)
            out["accuracy"], out["corr"] = acc, corr
        if collect_weights:
            out["gate_stats"] = stats
        return out

    def _selection_metric(self, metrics: dict) -> float:
        """Higher is better."""
        task = self.cfg.task
        if task in ("classification", "posneg-classification"):
            return metrics["accuracy"]
        if task == "multilabel":
            return metrics["f1_macro"]
        return -metrics["loss"]  # regression: lower val loss

    def fit(self, state: SupervisedState, train_loader: ArrayLoader,
            valid_loader: ArrayLoader,
            generator: Optional[torch.Generator] = None,
            log_fn: Callable[[str], None] = print
            ) -> tuple[SupervisedState, list[dict]]:
        """Train with early stopping; returns the state with the best
        epoch's weights and optimizer state restored, and the logs."""
        cfg = self.cfg
        generator = self._generator(generator)
        best = state.snapshot()
        best_metric = -np.inf
        patience = 0
        logs = []
        for epoch in range(cfg.epochs):
            state, train_loss = self.train_epoch(state, train_loader,
                                                 generator)
            metrics = self.evaluate(state, valid_loader)
            sel = self._selection_metric(metrics)
            record = {"epoch": epoch, "train_loss": train_loss, **metrics}
            logs.append(record)
            if sel > best_metric:
                best_metric = sel
                best = state.snapshot()
                patience = 0
                log_fn(f"epoch {epoch}: {record} (new best)")
            else:
                patience += 1
                log_fn(f"epoch {epoch}: {record} (patience {patience})")
            if cfg.early_stop and patience > cfg.patience:
                break
        state.restore(best)
        return state, logs
