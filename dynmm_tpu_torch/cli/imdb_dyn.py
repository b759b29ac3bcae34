"""Train and evaluate modality-level DynMM on MM-IMDB (the twin of
``examples/multimedia/imdb_dyn.py``; the reference's
``ModalityDynMM/multimedia/imdb_dyn.py``), with the same flags plus
``--device``:

    python -m dynmm_tpu_torch.cli.imdb_dyn --synthetic --freeze --reg 0.1

The router is text expert vs image+text late fusion under an
``MLP(4396, 128, 2)`` gate, trained with soft gates (``--hard`` for hard)
and the λ resource loss (``--reg``); evaluation forces hard gates and
prints f1 micro/macro, the expected FLOPs and the branch ratio. Experts are
grafted from ``./log/imdb/*.msgpack`` when present (``--no-pretrain``
skips them) and the trained router is written to
``./log/<data>/DynMMNet_freeze<F>_reg_<λ>.msgpack``, all in flax's msgpack
layout, so either package reads the other's files (``imdb_uni --mod 0|1``
and ``imdb_mm --fuse 1`` write the experts). ``--robust`` sweeps Gaussian
feature noise over the test set per modality group (text, image, both;
``train/robustness.py``) and prints each group's f1-macro curve. It runs on
the card; ``--device cpu`` runs on the CPU. ``--measure``/``--routed`` are
not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dynmm_tpu_torch.data.imdb import imdb_loaders, synthetic_imdb_loaders
from dynmm_tpu_torch.models.modality import IMDB_FLOPS_M, build_router
from dynmm_tpu_torch.train.adapters import dynmm_adapter
from dynmm_tpu_torch.train.experts import inject_expert, load_expert
from dynmm_tpu_torch.train.robustness import (relative_robustness,
                                              robustness_sweep)
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
from dynmm_tpu_torch.utils import profiling
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_checkpoint_into,
                                           load_flax_variables)

EXPERTS = (("text_encoder", "./log/imdb/encoder_text.msgpack"),
           ("text_head", "./log/imdb/head_text.msgpack"),
           ("image_encoder", "./log/imdb/encoder_image.msgpack"),
           ("image_head", "./log/imdb/head_image.msgpack"),
           ("branch3", "./log/imdb/best_lf.msgpack"))


def print_robustness(curves: dict, metric: str) -> None:
    """The JAX CLIs' ``--robust`` lines: each group's curve of ``metric``
    and its relative robustness."""
    for mod, curve in curves.items():
        rr = relative_robustness(curve[metric])
        print(f"robustness ({mod}): {metric} curve "
              f"{[round(v, 3) for v in curve[metric]]} | "
              f"relative robustness {rr:.3f}")


def measure(model, loader, trainer, routed: bool,
            lengths: bool = False) -> None:
    """``--measure``: time the hard-gated eval forward of ``model`` (the
    dense one, or ``forward_routed_compact`` under ``routed``) over
    ``loader`` and print the JAX CLI's line. ``lengths``: the router takes
    the batch's sequence lengths (MOSEI)."""
    model.eval()

    def forward(batch):
        args = ((batch["inputs"], batch["lengths"]) if lengths
                else (batch["inputs"],))
        with torch.inference_mode():
            if routed:
                return model.forward_routed_compact(*args)[0]
            return model(*args, hard=True)[0]

    mean, std = profiling.test_time(forward, loader, trainer.to_device_batch)
    print(f"Time measured over 10 reps: {mean:.4f} ± {std:.4f}s per pass")


def add_eval_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--robust", action="store_true",
                    help="noise-robustness sweep over the test set")
    ap.add_argument("--measure", action="store_true",
                    help="measure inference latency")
    ap.add_argument("--routed", action="store_true",
                    help="with --measure: time the bucket-compacted routed "
                         "forward")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the card (cuda)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "imdb", formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--data", type=str, default="imdb")
    ap.add_argument("--n-epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--wd", type=float, default=1e-2)
    ap.add_argument("--reg", type=float, default=0.1, help="reg loss weight (λ)")
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--hard", action="store_true", help="hard gates in training")
    ap.add_argument("--no-pretrain", action="store_true")
    ap.add_argument("--infer-mode", type=int, default=0)
    ap.add_argument("--data-path", type=str,
                    default="./data/multimodal_imdb.hdf5")
    add_eval_flags(ap)
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

    log1, log2 = np.zeros((args.n_runs, 1)), np.zeros((args.n_runs, 3))
    for n in range(args.n_runs):
        model = build_router("imdb", seed=n, device=device)
        if not args.no_pretrain:
            variables = flax_variables(model)
            for sub, path in EXPERTS:
                if os.path.exists(path):
                    variables = inject_expert(variables, sub, load_expert(path))
                    print(f"loaded expert {path}")
            load_flax_variables(model, variables)

        filename = os.path.join(
            "./log", args.data,
            f"DynMMNet_freeze{args.freeze}_reg_{args.reg}.msgpack")
        cfg = SupervisedConfig(
            task="multilabel", objective="bce_with_logits",
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.wd,
            additional_loss=True, lossw=args.reg, early_stop=True)
        trainer = SupervisedTrainer(
            dynmm_adapter(model, temp=1.0, hard=args.hard,
                          infer_mode=args.infer_mode),
            cfg, trainable_pred=(lambda p: "gate" in p) if args.freeze else None,
            device=device)
        state = trainer.init_state()
        if not args.eval_only:
            state, _ = trainer.fit(
                state, train_loader, valid_loader,
                generator=torch.Generator(device=device).manual_seed(n))
            save_checkpoint(filename, state.variables(), epoch=0)
        elif os.path.exists(filename):
            load_checkpoint_into(model, filename)

        print(f"Testing model {filename}:")
        hard_trainer = SupervisedTrainer(
            dynmm_adapter(model, temp=1.0, hard=True,
                          infer_mode=args.infer_mode), cfg, device=device)
        metrics = hard_trainer.evaluate(state, test_loader,
                                        collect_weights=True)
        stats = metrics["gate_stats"]
        ratio = stats.branch_ratios()[1] if stats.weights.size else 0.0
        flops = stats.expected_flops(IMDB_FLOPS_M) if stats.weights.size else 0.0
        print(f"f1_micro: {metrics['f1_micro']*100:.2f} | "
              f"f1_macro: {metrics['f1_macro']*100:.2f} | "
              f"Total Flops {flops:.2f}M | branch ratio {ratio:.3f}")
        log1[n] = ratio
        log2[n] = metrics["f1_micro"], metrics["f1_macro"], flops

        if args.robust:
            curves = robustness_sweep(
                lambda loader: hard_trainer.evaluate(state, loader),
                test_loader, {"text": [0], "image": [1], "both": [0, 1]})
            print_robustness(curves, "f1_macro")
        if args.measure:
            measure(model, test_loader, hard_trainer, args.routed)

    print("-" * 60)
    print(f"Finish {args.n_runs} runs")
    print(f"Test f1 micro {log2[:,0].mean()*100:.2f} ± {log2[:,0].std()*100:.2f} | "
          f"f1 macro {log2[:,1].mean()*100:.2f} ± {log2[:,1].std()*100:.2f} | "
          f"Flop saving {log2[:,2].mean():.2f} ± {log2[:,2].std():.2f}M | "
          f"Branch selection ratio {log1.mean():.3f} ± {log1.std():.3f}")


if __name__ == "__main__":
    main()
