"""Train and evaluate modality-level DynMM on CMU-MOSEI (the twin of
``examples/affect/affect_dyn.py``; the reference's
``ModalityDynMM/affect/affect_dyn.py``), with the same flags plus two of
the port's own, which the JAX twin lacks: ``--device`` and
``--no-pretrain`` (train the router without grafting the experts):

    python -m dynmm_tpu_torch.cli.affect_dyn --synthetic --freeze --reg 0.01

The router is ``MoseiDynMMNetV2`` (text transformer vs tri-modal late
fusion, gate ``Transformer(409, 10)`` + ``Linear``), trained on L1
regression with the λ resource loss (``--reg``) and evaluated with hard
gates as posneg classification: accuracy, loss, correlation, expected FLOPs
and branch ratio. Experts are grafted from ``./log/<data>/*.msgpack`` when
present and the trained router is written to
``./log/<data>/dyn_enc_<enc>_reg_<λ>freeze<F>.msgpack``, in flax's msgpack
layout (``affect_uni --mod 2 --enc transformer`` and ``affect_mm --fusion
3`` write the experts). With ``--enc gru`` the CLI grafts
``reg_gru_encoder_text.msgpack`` into the text transformer, as the JAX
CLI does: where that file exists, the graft raises ``ValueError`` in both
packages (a GRU tree is not a transformer's). ``--robust`` sweeps Gaussian
feature noise over the test set per modality (visual, audio, text;
``train/robustness.py``) and prints each accuracy curve. ``--measure``
(``--routed``) times the dense (bucket-compacted) hard eval over the test
set and prints the JAX CLI's line, as ``imdb_dyn`` does. It runs on the
card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dynmm_tpu_torch.cli.imdb_dyn import (add_eval_flags, measure,
                                          print_robustness)
from dynmm_tpu_torch.data.affect import mosei_loaders, synthetic_mosei_loaders
from dynmm_tpu_torch.models.modality import MOSEI_FLOPS_M, build_router
from dynmm_tpu_torch.train.adapters import dynmm_adapter
from dynmm_tpu_torch.train.experts import inject_expert, load_expert
from dynmm_tpu_torch.train.robustness import robustness_sweep
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_checkpoint_into,
                                           load_flax_variables)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        "dynamic multimodal network on mosei",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--data", type=str, default="mosei")
    ap.add_argument("--n-runs", type=int, default=1)
    ap.add_argument("--enc", type=str, default="transformer")
    ap.add_argument("--n-epochs", type=int, default=50)
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--hard-gate", action="store_true")
    ap.add_argument("--reg", type=float, default=0.0, help="reg loss weight (λ)")
    ap.add_argument("--lr", type=float, default=1e-6)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--infer-mode", type=int, default=0)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--no-pretrain", action="store_true",
                    help="do not graft experts from ./log/<data>/")
    ap.add_argument("--data-path", type=str,
                    default="./data/mosei_senti_data.pkl")
    add_eval_flags(ap)
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

    log = np.zeros((args.n_runs, 5))
    for n in range(args.n_runs):
        model = build_router("mosei", seed=n, device=device)
        # two-step workflow: graft pretrained expert branches when available
        experts = (
            ("text_encoder",
             f"./log/{args.data}/reg_{args.enc}_encoder_text.msgpack"),
            ("text_head", f"./log/{args.data}/reg_{args.enc}_head_text.msgpack"),
            ("branch2", f"./log/{args.data}/lf_tran.msgpack"))
        if not args.no_pretrain:
            variables = flax_variables(model)
            for sub, path in experts:
                if os.path.exists(path):
                    variables = inject_expert(variables, sub, load_expert(path))
                    print(f"Loading model {path}")
            load_flax_variables(model, variables)

        filename = os.path.join(
            "./log", args.data,
            f"dyn_enc_{args.enc}_reg_{args.reg}freeze{args.freeze}.msgpack")
        cfg = SupervisedConfig(
            task="posneg-classification", objective="l1",
            epochs=args.n_epochs, lr=args.lr, weight_decay=args.wd,
            additional_loss=True, lossw=args.reg, early_stop=True)
        trainer = SupervisedTrainer(
            dynmm_adapter(model, temp=args.temp, hard=args.hard_gate,
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
            dynmm_adapter(model, temp=args.temp, hard=True,
                          infer_mode=args.infer_mode), cfg, device=device)
        metrics = hard_trainer.evaluate(state, test_loader,
                                        collect_weights=True)
        stats = metrics["gate_stats"]
        flops = stats.expected_flops(MOSEI_FLOPS_M) if stats.weights.size else 0.0
        ratio = stats.branch_ratios()[1] if stats.weights.size else 0.0
        print(f"Accuracy {metrics['accuracy']*100:.2f} | Loss "
              f"{metrics['loss']:.4f} | Corr {metrics['corr']:.3f} | "
              f"Total Flops {flops:.2f}M | ratio {ratio:.3f}")
        log[n] = (metrics["accuracy"], metrics["loss"], metrics["corr"], flops,
                  ratio)

        if args.robust:
            curves = robustness_sweep(
                lambda loader: hard_trainer.evaluate(state, loader),
                test_loader, {"visual": [0], "audio": [1], "text": [2]})
            print_robustness(curves, "accuracy")
        if args.measure:
            measure(model, test_loader, hard_trainer, args.routed,
                    lengths=True)

    print("-" * 60)
    print(f"Finish {args.n_runs} runs")
    print(f"Test Accuracy {log[:,0].mean()*100:.2f} ± {log[:,0].std()*100:.2f}")
    print(f"Loss {log[:,1].mean():.4f} ± {log[:,1].std():.4f}")
    print(f"Corr {log[:,2].mean():.4f} ± {log[:,2].std():.4f}")
    print(f"FLOP {log[:,3].mean():.2f} ± {log[:,3].std():.2f}")
    print(f"Ratio {log[:,4].mean():.3f} ± {log[:,4].std():.2f}")


if __name__ == "__main__":
    main()
