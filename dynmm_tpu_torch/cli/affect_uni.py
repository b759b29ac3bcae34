"""Train and evaluate the unimodal CMU-MOSEI/MOSI experts (the twin of
``examples/affect/affect_uni.py``; the reference's
``ModalityDynMM/affect/affect_uni.py``), with the same flags plus
``--device``:

    python -m dynmm_tpu_torch.cli.affect_uni --synthetic --mod 2 --enc transformer

A GRU or a Transformer encoder over one stream (visual 35-d: gru 64/32,
transformer 120/64; audio 74-d: gru 128/64, transformer 120/64; text
300-d: gru 512/256, transformer 120/64) and an MLP head; L1 regression
evaluated as posneg classification, or with ``--clf`` cross-entropy over
the binarised sentiment; AdamW (lr 1e-4, wd 0.01). The encoder and head
are written to ``./log/<data>/reg_<enc>_{encoder,head}_<modality>.msgpack``
(flax's msgpack layout), where ``affect_dyn`` grafts the text transformer.
It runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dynmm_tpu_torch.data.affect import (AUDIO_DIM, TEXT_DIM, VISUAL_DIM,
                                         mosei_loaders,
                                         synthetic_mosei_loaders)
from dynmm_tpu_torch.data.loader import ArrayLoader
from dynmm_tpu_torch.models.modality import EncoderHead, init_model
from dynmm_tpu_torch.nn.mlp import MLP
from dynmm_tpu_torch.nn.sequence import GRU, Transformer
from dynmm_tpu_torch.train.adapters import unimodal_adapter
from dynmm_tpu_torch.train.experts import save_state_expert
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.device import resolve_device

HIDDEN = {  # (gru h1, gru h2, tran h1, tran h2)
    0: (64, 32, 120, 64),
    1: (128, 64, 120, 64),
    2: (512, 256, 120, 64),
}
MOD_NAMES = {0: "visual", 1: "audio", 2: "text"}
MOD_DIMS = {0: VISUAL_DIM, 1: AUDIO_DIM, 2: TEXT_DIM}


def build_expert(mod: int, enc: str, h1: int, h2: int,
                 output_dim: int) -> EncoderHead:
    if enc == "gru":
        encoder = GRU(MOD_DIMS[mod], h1, dropout=True)
    else:
        encoder = Transformer(MOD_DIMS[mod], h1)
    return EncoderHead(encoder, MLP(h1, h2, output_dim), sequence=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "unimodal network on mosi/mosei",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--mod", type=int, default=2,
                    help="0 visual / 1 audio / 2 text")
    ap.add_argument("--enc", type=str, default="transformer",
                    help="gru | transformer")
    ap.add_argument("--hidden-dim1", type=int, default=0)
    ap.add_argument("--hidden-dim2", type=int, default=0)
    ap.add_argument("--data", type=str, default="mosei")
    ap.add_argument("--n-epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--data-path", type=str,
                    default="./data/mosei_senti_data.pkl")
    ap.add_argument("--clf", action="store_true",
                    help="classification model (CE, 2 classes); else "
                         "regression")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the card (cuda)")
    return ap.parse_args(argv)


def _binarize(loader: ArrayLoader, shuffle: bool) -> ArrayLoader:
    """The loader with the scalar sentiment as posneg classes."""
    return ArrayLoader(
        loader.inputs, (loader.label.reshape(-1) >= 0).astype(np.int64),
        lengths=loader.lengths, batch_size=loader.batch_size,
        shuffle=shuffle, drop_last=shuffle, pad_tail=not shuffle)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.synthetic or not os.path.exists(args.data_path):
        print("using synthetic MOSEI data")
        loaders = synthetic_mosei_loaders(batch_size=32)
    else:
        loaders = mosei_loaders(args.data_path, batch_size=32)
    train_loader, valid_loader, test_loader = loaders
    if args.clf:
        train_loader = _binarize(train_loader, True)
        valid_loader = _binarize(valid_loader, False)
        test_loader = _binarize(test_loader, False)

    g1, g2, t1, t2 = HIDDEN[args.mod]
    h1 = args.hidden_dim1 or (g1 if args.enc == "gru" else t1)
    h2 = args.hidden_dim2 or (g2 if args.enc == "gru" else t2)
    mod_name = MOD_NAMES[args.mod]

    log = np.zeros((args.n_runs, 3))
    for n in range(args.n_runs):
        model = init_model(build_expert(args.mod, args.enc, h1, h2,
                                        2 if args.clf else 1),
                           seed=n, device=device)
        if args.clf:
            cfg = SupervisedConfig(
                task="classification", objective="cross_entropy",
                epochs=args.n_epochs, lr=args.lr, weight_decay=0.01)
        else:
            cfg = SupervisedConfig(
                task="posneg-classification", objective="l1",
                epochs=args.n_epochs, lr=args.lr, weight_decay=0.01)
        trainer = SupervisedTrainer(unimodal_adapter(model, args.mod), cfg,
                                    device=device)
        state = trainer.init_state()
        if not args.eval_only:
            state, _ = trainer.fit(
                state, train_loader, valid_loader,
                generator=torch.Generator(device=device).manual_seed(n))
            variables = state.variables()
            for sub in ("encoder", "head"):
                save_state_expert(
                    f"./log/{args.data}/reg_{args.enc}_{sub}_{mod_name}"
                    ".msgpack", variables, sub)
        metrics = trainer.evaluate(state, test_loader)
        print(f"run {n}: {metrics}")
        log[n] = metrics["accuracy"], metrics["loss"], metrics.get("corr", 0.0)

    print(f"Test Accuracy {log[:,0].mean()*100:.2f} ± {log[:,0].std()*100:.2f}")
    print(f"Loss {log[:,1].mean():.4f} ± {log[:,1].std():.2f}")
    print(f"Corr {log[:,2].mean():.4f} ± {log[:,2].std():.2f}")


if __name__ == "__main__":
    main()
