"""Train and evaluate the two-modality MM-IMDB fusion experts (the twin of
``examples/multimedia/imdb_mm.py``; the reference's
``ModalityDynMM/multimedia/imdb_mm.py``), with the same flags plus
``--device``:

    python -m dynmm_tpu_torch.cli.imdb_mm --synthetic --fuse 1

``--fuse`` 0 = ef (concatenated features into a ``MaxOut_MLP``), 1 = lf
(``MaxOut_MLP`` encoders, ``Concat``, linear head: the router's branch 3),
2 = lrtf (``LowRankTensorFusion``, rank 16), 3 = mim
(``MultiplicativeInteractions2Modal``). Multilabel BCE, AdamW (lr 8e-3, wd
0.01); the trained model is written to ``./log/imdb/best_<name>.msgpack``
(flax's msgpack layout), where ``imdb_dyn`` grafts ``best_lf``. It runs on
the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dynmm_tpu_torch.data.imdb import (IMAGE_DIM, N_CLASSES, TEXT_DIM,
                                       imdb_loaders, synthetic_imdb_loaders)
from dynmm_tpu_torch.models.modality import MMDL, init_model
from dynmm_tpu_torch.nn.fusions import (Concat, LowRankTensorFusion,
                                        MultiplicativeInteractions2Modal)
from dynmm_tpu_torch.nn.mlp import Identity, LinearHead, MaxOut_MLP
from dynmm_tpu_torch.train.adapters import mmdl_adapter
from dynmm_tpu_torch.train.experts import save_state_expert
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.device import resolve_device

FUSION_NAMES = ("ef", "lf", "lrtf", "mim")


def build_expert(fuse: int) -> tuple[MMDL, str]:
    """The ``--fuse`` expert and its name, as the JAX ``build_expert``."""
    if fuse == 0:  # early fusion
        return MMDL(encoders=[Identity(), Identity()], fusion=Concat(),
                    head=MaxOut_MLP(N_CLASSES, 512, TEXT_DIM + IMAGE_DIM,
                                    512)), "ef"
    encoders = [MaxOut_MLP(512, 512, TEXT_DIM, linear_layer=False),
                MaxOut_MLP(512, 1024, IMAGE_DIM, 512, linear_layer=False)]
    if fuse == 1:  # late fusion (the DynMM branch-3 expert)
        return MMDL(encoders=encoders, fusion=Concat(),
                    head=LinearHead(1024, N_CLASSES)), "lf"
    if fuse == 2:  # low-rank tensor fusion
        return MMDL(encoders=encoders,
                    fusion=LowRankTensorFusion((512, 512), 512, rank=16),
                    head=LinearHead(512, N_CLASSES)), "lrtf"
    return MMDL(encoders=encoders,  # multiplicative interactions
                fusion=MultiplicativeInteractions2Modal((512, 512), 512),
                head=LinearHead(512, N_CLASSES)), "mim"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "imdb_mm", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--fuse", type=int, default=1,
                    help="0 ef / 1 lf / 2 lrtf / 3 mim")
    ap.add_argument("--n-epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=8e-3)
    ap.add_argument("--wd", type=float, default=1e-2)
    ap.add_argument("--data-path", type=str,
                    default="./data/multimodal_imdb.hdf5")
    ap.add_argument("--synthetic", action="store_true")
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

    log = np.zeros((args.n_runs, 2))
    for n in range(args.n_runs):
        model, name = build_expert(args.fuse)
        model = init_model(model, seed=n, device=device)
        cfg = SupervisedConfig(
            task="multilabel", objective="bce_with_logits",
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.wd)
        trainer = SupervisedTrainer(mmdl_adapter(model), cfg, device=device)
        state, _ = trainer.fit(
            trainer.init_state(), train_loader, valid_loader,
            generator=torch.Generator(device=device).manual_seed(n))
        save_state_expert(f"./log/imdb/best_{name}.msgpack", state.variables())
        metrics = trainer.evaluate(state, test_loader)
        print(f"run {n}: {metrics}")
        log[n] = metrics["f1_micro"], metrics["f1_macro"]

    print(f"Test f1 micro {log[:,0].mean()*100:.2f} ± {log[:,0].std()*100:.2f} | "
          f"f1 macro {log[:,1].mean()*100:.2f} ± {log[:,1].std()*100:.2f}")


if __name__ == "__main__":
    main()
