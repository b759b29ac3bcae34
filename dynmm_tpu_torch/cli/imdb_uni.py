"""Train and evaluate the unimodal MM-IMDB experts (the twin of
``examples/multimedia/imdb_uni.py``; the reference's
``ModalityDynMM/multimedia/imdb_uni.py``), with the same flags plus
``--device``:

    python -m dynmm_tpu_torch.cli.imdb_uni --synthetic --mod 0

The text expert is ``MLP(300, 512, 512)`` + ``MLP(512, 512, 23)``, the
image expert ``MLP(4096, 1024, 512)`` + ``MLP(512, 512, 23)``, trained on
multilabel BCE with AdamW (lr 1e-4, wd 0.01) and early stopping; the
result is f1 micro/macro over ``--n-runs`` runs. The encoder and head are
written to ``./log/imdb/{encoder,head}_<text|image>.msgpack`` (flax's
msgpack layout), where ``imdb_dyn`` grafts them. It runs on the card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dynmm_tpu_torch.data.imdb import (IMAGE_DIM, N_CLASSES, TEXT_DIM,
                                       imdb_loaders, synthetic_imdb_loaders)
from dynmm_tpu_torch.models.modality import EncoderHead, init_model
from dynmm_tpu_torch.nn.mlp import MLP
from dynmm_tpu_torch.train.adapters import unimodal_adapter
from dynmm_tpu_torch.train.experts import save_state_expert
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.device import resolve_device

MOD_NAMES = ("text", "image")


def build_expert(mod: int) -> EncoderHead:
    if mod == 0:
        return EncoderHead(MLP(TEXT_DIM, 512, 512), MLP(512, 512, N_CLASSES))
    return EncoderHead(MLP(IMAGE_DIM, 1024, 512), MLP(512, 512, N_CLASSES))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "imdb_uni", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--mod", type=int, default=0, help="0: text, 1: image")
    ap.add_argument("--n-epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--wd", type=float, default=1e-2)
    ap.add_argument("--data-path", type=str,
                    default="./data/multimodal_imdb.hdf5")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no hdf5 needed)")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the card (cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.synthetic or not os.path.exists(args.data_path):
        print("using synthetic MM-IMDB data")
        loaders = synthetic_imdb_loaders(batch_size=128)
    else:
        loaders = imdb_loaders(args.data_path, batch_size=128)
    train_loader, valid_loader, test_loader = loaders

    mod_name = MOD_NAMES[args.mod]
    log = np.zeros((args.n_runs, 2))
    for n in range(args.n_runs):
        model = init_model(build_expert(args.mod), seed=n, device=device)
        cfg = SupervisedConfig(
            task="multilabel", objective="bce_with_logits",
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.wd,
            early_stop=True)
        trainer = SupervisedTrainer(unimodal_adapter(model, args.mod), cfg,
                                    device=device)
        state = trainer.init_state()
        if not args.eval_only:
            state, _ = trainer.fit(
                state, train_loader, valid_loader,
                generator=torch.Generator(device=device).manual_seed(n))
            variables = state.variables()
            for sub in ("encoder", "head"):
                save_state_expert(f"./log/imdb/{sub}_{mod_name}.msgpack",
                                  variables, sub)
        metrics = trainer.evaluate(state, test_loader)
        print(f"run {n}: {metrics}")
        log[n] = metrics["f1_micro"], metrics["f1_macro"]

    print(f"Test f1 micro {log[:,0].mean()*100:.2f} ± {log[:,0].std()*100:.2f} | "
          f"f1 macro {log[:,1].mean()*100:.2f} ± {log[:,1].std()*100:.2f}")


if __name__ == "__main__":
    main()
