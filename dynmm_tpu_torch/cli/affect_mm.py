"""Train and evaluate the tri-modal CMU-MOSEI fusion experts (the twin of
``examples/affect/affect_mm.py``; the reference's
``ModalityDynMM/affect/affect_mm.py``), with the same flags plus
``--device``:

    python -m dynmm_tpu_torch.cli.affect_mm --synthetic --fusion 3

``--fusion`` 0 = ef_gru (the concatenated streams through a GRU), 1 =
lf_gru (a GRU a stream, ``Concat``), 2 = ef_tran, 3 = lf_tran (a
Transformer a stream, ``Concat``: the router's branch 2), 4 = mult (MulT,
embed 40, 10 heads, 4 layers), 5 = lrtf (``GRUWithLinear`` encoders,
``LowRankTensorFusion`` rank 32). L1 regression evaluated as posneg
classification; AdamW (lr 1e-4, wd 1e-4). The trained model is written to
``./log/<data>/<name>.msgpack`` (flax's msgpack layout), where
``affect_dyn`` grafts ``lf_tran``. As in the JAX package, ``MMDL`` calls
the fusion with no lengths and no train flag: the early-fusion heads and
MulT run over all padded steps, and MulT trains without dropout. It runs
on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from dynmm_tpu_torch.data.affect import (AUDIO_DIM, TEXT_DIM, VISUAL_DIM,
                                         mosei_loaders,
                                         synthetic_mosei_loaders)
from dynmm_tpu_torch.models.modality import MMDL, EncoderHead, init_model
from dynmm_tpu_torch.models.mult import MULTModel
from dynmm_tpu_torch.nn.fusions import Concat, ConcatEarly, LowRankTensorFusion
from dynmm_tpu_torch.nn.mlp import MLP
from dynmm_tpu_torch.nn.sequence import GRU, GRUWithLinear, Transformer
from dynmm_tpu_torch.train.adapters import mmdl_adapter
from dynmm_tpu_torch.train.experts import save_state_expert
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.device import resolve_device

FUSION_NAMES = {0: "ef_gru", 1: "lf_gru", 2: "ef_tran", 3: "lf_tran",
                4: "mult", 5: "lrtf"}
DIMS = (VISUAL_DIM, AUDIO_DIM, TEXT_DIM)


class SeqIdentity(nn.Module):
    """A sequence encoder that returns its input (the JAX example's
    ``SeqIdentity``)."""

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x


def build_expert(fusion: int) -> MMDL:
    """The ``--fusion`` expert, as the JAX ``build_expert``; the early
    fusions' heads are ``EncoderHead(..., sequence=True)`` (the example's
    ``SeqHead``), to which ``MMDL`` hands no lengths."""
    early = sum(DIMS)
    if fusion == 0:  # early fusion + GRU
        return MMDL([SeqIdentity() for _ in DIMS], ConcatEarly(),
                    EncoderHead(GRU(early, 512, dropout=True),
                                MLP(512, 256, 1), sequence=True),
                    has_padding=True)
    if fusion == 1:  # late fusion + GRU
        return MMDL([GRU(d, h, dropout=True) for d, h in zip(DIMS,
                                                             (64, 128, 512))],
                    Concat(), MLP(64 + 128 + 512, 512, 1), has_padding=True)
    if fusion == 2:  # early fusion + transformer
        return MMDL([SeqIdentity() for _ in DIMS], ConcatEarly(),
                    EncoderHead(Transformer(early, 300), MLP(300, 128, 1),
                                sequence=True),
                    has_padding=True)
    if fusion == 3:  # late fusion + transformer (DynMM branch 2)
        return MMDL([Transformer(d, h) for d, h in zip(DIMS, (60, 120, 120))],
                    Concat(), MLP(300, 128, 1), has_padding=True)
    if fusion == 4:  # MulT cross-modal transformer
        return MMDL([SeqIdentity() for _ in DIMS],
                    MULTModel(DIMS, embed_dim=40, num_heads=10, layers=4,
                              output_dim=1),
                    SeqIdentity(), has_padding=True)
    # low-rank tensor fusion over GRUWithLinear encodings
    return MMDL([GRUWithLinear(d, h, o, dropout=True)
                 for d, h, o in zip(DIMS, (64, 128, 512), (32, 32, 128))],
                LowRankTensorFusion((32, 32, 128), 128, rank=32),
                MLP(128, 512, 1), has_padding=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "multimodal network on mosi/mosei",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--data", type=str, default="mosei")
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--fusion", type=int, default=3, help="0-5")
    ap.add_argument("--n-epochs", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--data-path", type=str,
                    default="./data/mosei_senti_data.pkl")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the card (cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.synthetic or not os.path.exists(args.data_path):
        print("using synthetic MOSEI data")
        loaders = synthetic_mosei_loaders(batch_size=32)
    else:
        loaders = mosei_loaders(args.data_path, batch_size=32)
    train_loader, valid_loader, test_loader = loaders

    name = FUSION_NAMES[args.fusion]
    print(f"Fusion model {name}")
    log = np.zeros((args.n_runs, 3))
    for n in range(args.n_runs):
        model = init_model(build_expert(args.fusion), seed=n, device=device)
        cfg = SupervisedConfig(
            task="posneg-classification", objective="l1",
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.wd)
        trainer = SupervisedTrainer(mmdl_adapter(model), cfg, device=device)
        state = trainer.init_state()
        if not args.eval_only:
            state, _ = trainer.fit(
                state, train_loader, valid_loader,
                generator=torch.Generator(device=device).manual_seed(n))
            save_state_expert(f"./log/{args.data}/{name}.msgpack",
                              state.variables())
        metrics = trainer.evaluate(state, test_loader)
        print(f"run {n}: {metrics}")
        log[n] = metrics["accuracy"], metrics["loss"], metrics["corr"]

    print(f"Test Accuracy {log[:,0].mean()*100:.2f} ± {log[:,0].std()*100:.2f}")
    print(f"Loss {log[:,1].mean():.4f} ± {log[:,1].std():.4f}")
    print(f"Corr {log[:,2].mean():.4f} ± {log[:,2].std():.4f}")


if __name__ == "__main__":
    main()
