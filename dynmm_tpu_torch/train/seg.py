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
package's, are inference-only). Validation runs ``eval()`` after
``pack_weights``, so on the card the eval forward launches the kernels on
the trained weights. The global-gate SkipGateESANet is the model this
engine trains, on raw or 2×2 packed stem inputs (``packed_stem``); the
mesh and int8 calibration are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.core.schedules import ExpDecayTemp
from dynmm_tpu_torch.data.seg_preprocessing import (inject_eval_noise,
                                                    pack_stem_batch)
from dynmm_tpu_torch.models.skip_gate import capacity_ladders
from dynmm_tpu_torch.nn.layers import (first_argmax, pack_weights,
                                       resize_bilinear, resize_nearest_centers)
from dynmm_tpu_torch.train.metrics import ConfusionMatrix, confusion_update_counts
from dynmm_tpu_torch.train.seg_losses import StreamingValidLoss, multiscale_ce
from dynmm_tpu_torch.utils.checkpoint import save_ckpt, save_ckpt_every_epoch
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.logger import CSVLogger
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_flax_variables,
                                           tensors_from_flax_tree)

DOWN_RATES = (8, 16, 32)
OPT_STATE_FORMAT = "dynmm_tpu_torch"
# opt_state tree key → torch.optim state key, per optimizer
_MOMENTS = {"SGD": {"momentum": "momentum_buffer"},
            "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"}}


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

    ``state_tree()`` is the checkpoint's ``opt_state``::

        {"format": "dynmm_tpu_torch", "optimizer": "SGD" | "Adam",
         "count": updates applied, "mini_step": batches accumulated,
         "momentum": tree (SGD, after the first update),
         "mu": tree, "nu": tree (Adam, after the first update),
         "acc_grads": tree (grad_accum > 1, while batches are accumulated)}

    each tree the trained parameters' flax params tree
    (``utils/weights.py::flax_from_state_dict``).
    """

    def __init__(self, cfg: SegTrainConfig, model: nn.Module):
        self.cfg = cfg
        named = dict(model.named_parameters())
        if cfg.freeze and cfg.dynamic:
            for name, p in named.items():
                if "gate" not in name:
                    p.requires_grad_(False)
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
    def _buffers(self, key: str) -> dict[str, torch.Tensor]:
        return {n: self.opt.state[p][key] for n, p in self.named.items()
                if key in self.opt.state.get(p, {})}

    def state_tree(self) -> dict:
        out = {"format": OPT_STATE_FORMAT, "optimizer": self.cfg.optimizer,
               "count": self.count, "mini_step": self.mini_step}
        for tree_key, state_key in _MOMENTS[self.cfg.optimizer].items():
            bufs = self._buffers(state_key)
            if bufs:
                out[tree_key] = flax_from_state_dict(bufs)["params"]
        if self.acc:
            out["acc_grads"] = flax_from_state_dict(self.acc)["params"]
        return out

    def load_state_tree(self, tree) -> bool:
        """Restore ``state_tree()``; returns False (and leaves the optimizer
        fresh) for an ``opt_state`` the port did not write."""
        if not (isinstance(tree, dict)
                and tree.get("format") == OPT_STATE_FORMAT):
            return False
        if tree["optimizer"] != self.cfg.optimizer:
            raise ValueError(f"checkpoint optimizer {tree['optimizer']} "
                             f"!= {self.cfg.optimizer}")
        self.count = int(tree["count"])
        self.mini_step = int(tree["mini_step"])
        self.opt.state.clear()
        for tree_key, state_key in _MOMENTS[self.cfg.optimizer].items():
            if tree_key not in tree:
                continue
            for name, t in tensors_from_flax_tree(tree[tree_key],
                                                  self.named).items():
                p = self.named[name]
                self.opt.state[p][state_key] = t.to(p.device, p.dtype)
        if self.cfg.optimizer == "Adam":
            for st in self.opt.state.values():
                st["step"] = torch.tensor(float(self.count))
        self.acc = ({} if "acc_grads" not in tree else {
            n: t.to(self.named[n].device)
            for n, t in tensors_from_flax_tree(tree["acc_grads"],
                                               self.named).items()})
        return True


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
        v = flax_from_state_dict(self.model.state_dict())
        return {"params": v["params"],
                "model_state": {"batch_stats": v["batch_stats"]},
                "opt_state": self.optimizer.state_tree()}

    def load_tree(self, tree: dict) -> bool:
        """Load weights and, when the port wrote it, the optimizer state;
        returns whether the optimizer state was restored."""
        load_flax_variables(self.model, {
            "params": tree["params"],
            "batch_stats": tree.get("model_state", {}).get("batch_stats")})
        restored = self.optimizer.load_state_tree(tree.get("opt_state"))
        if not restored:
            print("checkpoint optimizer state is not the port's (a JAX "
                  "checkpoint): weights loaded, optimizer starts fresh")
        return restored


class SegTrainer:
    """Engine for the global-gate SkipGateESANet on one device (``None``:
    the card; pass ``device="cpu"`` for the CPU). The model moves there in
    channels_last memory."""

    def __init__(self, model: nn.Module, cfg: SegTrainConfig, class_weights,
                 device=None):
        if not (cfg.dynamic and cfg.global_gate and cfg.modality == "rgbd"):
            raise NotImplementedError(
                "the port trains the global-gate SkipGateESANet (dynamic, "
                "global_gate, rgbd); the static, local-gate and one-modality "
                "models wait (ROADMAP A7)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.class_weights = torch.as_tensor(
            np.asarray(class_weights, np.float32), device=self.device)
        # estimated branch ratios for serve_capacity_factor's schedule (set
        # by the eval CLI before validation)
        self.serve_ratios = None

    def init_state(self) -> TrainState:
        """The model (which holds its weights already, where the JAX
        trainer initialises them here) and a fresh optimizer."""
        return TrainState(self.model, make_seg_optimizer(self.cfg, self.model))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _packed(self, image, depth):
        """``(image, depth)`` 2×2-packed under ``packed_stem``
        (``pack_stem_batch``: raw inputs of even size only)."""
        if not self.cfg.packed_stem:
            return image, depth
        batch = pack_stem_batch({"image": image, "depth": depth})
        return batch["image"], batch["depth"]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ steps
    def train_step(self, state: TrainState, image, depth, targets, temp: float,
                   hard: bool, ini: bool, generator: torch.Generator):
        """One forward/backward/update on a batch: (total, per-scale losses
        (4,), loss_flop), as tensors."""
        cfg = self.cfg
        model = state.model
        model.train()
        preds, loss_flop = model(image, depth, temp=temp, hard=hard,
                                 baseline=cfg.baseline, ini_stage=ini,
                                 generator=generator)
        loss_seg, per_scale = multiscale_ce(preds, targets, self.class_weights)
        total = loss_seg
        if cfg.loss_ratio > 0:
            total = total + cfg.loss_ratio * torch.clamp(
                loss_flop - cfg.flop_budget, min=0.0)
        state.optimizer.zero_grad()
        total.backward()
        state.optimizer.step()
        return total.detach(), torch.stack(per_scale).detach(), loss_flop.detach()

    # ------------------------------------------------------------------ loops
    def train_one_epoch(self, state: TrainState, loader, epoch: int,
                        lr: float, temp: float):
        cfg = self.cfg
        hard, ini = epoch >= cfg.epoch_hard, epoch < cfg.epoch_ini
        state.optimizer.set_lr(lr)
        generator = torch.Generator().manual_seed(epoch)
        t0 = time.time()
        totals, per_scales, flops = [], [], []
        for batch in loader:
            targets = [self._tensor(batch["label"])] + [
                self._tensor(batch["label_down"][r]) for r in DOWN_RATES]
            image, depth = self._packed(batch["image"], batch["depth"])
            total, per_scale, loss_flop = self.train_step(
                state, self._tensor(image), self._tensor(depth), targets,
                temp, hard, ini, generator)
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

    def validate(self, state, loader, logs: Optional[dict] = None,
                 noise_mode: int = -1, noise: float = 0.0, run_seed: int = 0,
                 valid_loss: Optional[StreamingValidLoss] = None,
                 collect_weights: Optional[GateStats] = None,
                 ini_stage: bool = False, out_cms: Optional[dict] = None):
        """Per-camera eval: returns ({camera: miou}, logs). ``noise_mode``
        ≥ 0 injects eval.py's noise (``inject_eval_noise``) from one
        generator seeded with ``run_seed``. ``out_cms`` (if given) is filled
        with {camera: confusion matrix array}."""
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
            miou[camera] = cm.miou()
            logs[f"mIoU_{split}_{camera}"] = miou[camera]
            if out_cms is not None:
                out_cms[camera] = np.asarray(cm.matrix)
        logs["time_validation"] = time.time() - t_val0
        logs["time_forward"] = self._phase_forward
        logs["time_post_processing"] = self._phase_post
        logs["time_confusion_matrix"] = self._phase_cm
        if valid_loss is not None:
            logs[f"loss_{split}"] = valid_loss.compute()
        return miou, logs

    def _eval_forward(self, model, image, depth, ini_stage, generator):
        """(logits, weight) of the eval chain: the dense forward, or under
        ``serve_capacity_factor`` the strict compact one with caps from this
        batch's size (a ragged tail batch gets its own schedule)."""
        cfg = self.cfg
        hard = not cfg.soft_eval
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
            out_hw = (label_orig.shape[1], label_orig.shape[2])
            t0 = time.time()
            with torch.inference_mode():
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
                if (valid_loss is not None and "label" in batch
                        and not cfg.low_res_eval):  # H/4 logits: no loss
                    valid_loss.add_batch(logits, self._tensor(batch["label"]))
                if collect_weights is not None:
                    collect_weights.append(weight)
                label = self._tensor(label_orig)
                mask = label > 0
                lab, pred_m = label[mask] - 1, pred_full[mask]
                self._sync()
                self._phase_post += time.time() - t0

                t0 = time.time()
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
        epoch's model and optimizer afterwards."""
        cfg = self.cfg
        os.makedirs(os.path.join(ckpt_dir, "confusion_matrices"), exist_ok=True)
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
        csvlogger = CSVLogger(log_keys, os.path.join(ckpt_dir, "logs.csv"))
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
                    with open(os.path.join(ckpt_dir, "confusion_matrices",
                                           f"cm_epoch_{epoch}.pickle"),
                              "wb") as f:
                        pickle.dump(cms, f, protocol=pickle.HIGHEST_PROTOCOL)
                    cam0 = cameras[0]
                    if miou[cam0] > best_miou:
                        best_miou = miou[cam0]
                        best_miou_epoch = epoch
                        best_tree = state.tree()
                    log_fn(f"Test mIoU {miou[cam0]:.4f} | Best mIoU "
                           f"{best_miou:.4f} | Best epoch {best_miou_epoch}")
                csvlogger.write_logs(logs)
                save_ckpt_every_epoch(ckpt_dir, state, epoch, best_miou,
                                      best_miou_epoch)
                if epoch >= 10 and epoch % cfg.save_every == cfg.save_every - 1:
                    save_ckpt(ckpt_dir, state, epoch)
            save_ckpt(ckpt_dir, best_tree, best_miou_epoch)
            with open(os.path.join(ckpt_dir, "finished.txt"), "w") as f:
                f.write(f"best miou: {best_miou}\n")
                f.write(f"best miou epoch: {best_miou_epoch}\n")
        finally:
            csvlogger.close()
        return best_tree, best_miou, best_miou_epoch
