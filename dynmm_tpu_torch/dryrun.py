"""Multi-rank dry run of the flagship (the twin of
``__graft_entry__.py::dryrun_multichip``):

    python -m dynmm_tpu_torch.dryrun 4 [--device cpu]

``dryrun_multichip(n)`` starts ``n`` ranks (``parallel/launch.py``) on
the card (it raises without one; ``device="cpu"`` runs them on the CPU
over gloo) on a (data, model) mesh, with
M = 2 'model' ranks when n is even and at least 4, as JAX's does. On it:

1. one train step of the flagship (``SkipGateESANet`` R34-NBt1D, 40
   classes, torch's default initialisation drawn after
   ``torch.manual_seed(0)``, as ``cli.train`` builds a model; rank 0's
   weights everywhere) at 64×64, the weights of at least 128 output
   channels split
   over 'model': SGD with Nesterov momentum (lr 1e-3, momentum 0.9), the
   multi-scale class-weighted CE plus 1e-4 · max(FLOP loss, 0), on zero
   images and all-ones labels, one sample a data rank, each rank fed its
   own rows (``make_global_batch``);
2. one ``forward_routed_compact`` eval batch under the same mesh (live
   gate, the whole weights gathered);
3. both sharded routed forwards (``parallel/routing.py``:
   ``forward_switch_batched`` and ``forward_routed_compact`` with caps
   (0, 1)) on a data-only mesh of all n ranks.

It checks that every output is finite and of the global batch, and prints
JAX's OK line (the feed named ``make_global_batch``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.nn.utils import parametrize

from dynmm_tpu_torch.kernels import build_all
from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.parallel.launch import run_ranks
from dynmm_tpu_torch.parallel.mesh import (full_state_dict, make_global_batch,
                                           make_mesh)
from dynmm_tpu_torch.parallel.routing import make_sharded_routed_forward
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.train.seg import DOWN_RATES, SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.device import resolve_device

HEIGHT = WIDTH = 64  # tiny spatial dims; the structure is the 480×640 net's
CLASSES = 40


def flagship() -> SkipGateESANet:
    torch.manual_seed(0)
    return SkipGateESANet(ESANetConfig(height=HEIGHT, width=WIDTH,
                                       num_classes=CLASSES))


def _rank(n_devices: int, n_model: int, device: str) -> str:
    mesh = make_mesh(n_devices // n_model, n_model, device=device)
    batch = mesh.n_data  # one sample a data rank
    model = flagship()
    cfg = SegTrainConfig(epochs=1, lr=1e-3, optimizer="SGD", momentum=0.9,
                         weight_decay=0.0, loss_ratio=1e-4, flop_budget=0.0)
    trainer = SegTrainer(model, cfg, np.ones(CLASSES, np.float32),
                         mesh=mesh, min_out=128)
    state = trainer.init_state()
    trainer.place(state)
    rgb, depth, *labels = make_global_batch(
        [np.zeros((1, HEIGHT, WIDTH, 3), np.float32),
         np.zeros((1, HEIGHT, WIDTH, 1), np.float32),
         np.ones((1, HEIGHT, WIDTH), np.int32)]
        + [np.ones((1, HEIGHT // r, WIDTH // r), np.int32)
           for r in DOWN_RATES], mesh)
    state.optimizer.set_lr(cfg.lr)
    loss = float(trainer.train_step(state, rgb, depth, labels, temp=1.0,
                                    hard=False, ini=False,
                                    generator=torch.Generator())[0])
    if not np.isfinite(loss):
        raise RuntimeError(f"the mesh step's loss is {loss}")

    # one routed-compact eval batch under the same mesh (live gate)
    model.eval()
    with parametrize.cached(), torch.inference_mode():
        pack_weights(model)
        out, weight = model.forward_routed_compact(rgb, depth,
                                                   return_weight=True)
        out, weight = mesh.gather_rows(out), mesh.gather_rows(weight)
    if not (bool(torch.isfinite(out).all()) and out.shape[0] == batch
            and weight.shape == (batch, 5)):
        raise RuntimeError(f"routed eval under the mesh: {tuple(out.shape)}")

    # device-local routing on a data-only mesh of every rank, on the
    # trained weights gathered whole
    whole = flagship().to(mesh.device, memory_format=torch.channels_last)
    whole.load_state_dict(full_state_dict(model))
    whole.eval()
    dmesh = make_mesh(n_devices, 1, device=device)
    zeros = (torch.zeros((n_devices, HEIGHT, WIDTH, 3)),
             torch.zeros((n_devices, HEIGHT, WIDTH, 1)))
    shapes = {}
    for variant in ("forward_switch_batched", "forward_routed_compact"):
        kwargs = ({"caps": (0, 1)} if variant == "forward_routed_compact"
                  else {})
        fn = make_sharded_routed_forward(whole, dmesh, variant, **kwargs)
        out_v = fn(*zeros)
        if not (bool(torch.isfinite(out_v).all())
                and out_v.shape[0] == n_devices):
            raise RuntimeError(f"sharded {variant}: {tuple(out_v.shape)}")
        shapes[variant] = tuple(out_v.shape)
    return (f"dryrun_multichip OK: mesh={mesh.shape} batch={batch} "
            f"loss={loss:.4f} routed_eval={tuple(out.shape)} "
            f"shard_map_batchmax={shapes['forward_switch_batched']} "
            f"shard_map_compact={shapes['forward_routed_compact']} "
            "feed=make_global_batch")


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 600.0) -> str:
    """Run the dry run on ``n_devices`` ranks (on ``device``: None is the
    card, "cpu" the CPU); prints and returns the OK line (raises if any
    rank fails)."""
    device = resolve_device(device).type
    if device == "cuda":
        build_all()  # once, before the ranks load the kernels
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    line = run_ranks(_rank, n_devices, (n_devices, n_model, device),
                     device=device, timeout=timeout)[0]
    print(line)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the card; "
                         "cpu: gloo on the CPU)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
