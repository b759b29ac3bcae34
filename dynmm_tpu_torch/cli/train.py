"""Segmentation training CLI of the port, the twin of the repo's ``train.py``
(the reference's ``FusionDynMM/train.py``), with the same flags:

    python -m dynmm_tpu_torch.cli.train --dataset synthetic --dynamic \\
        --global-gate --loss-ratio 1e-4 --temp 1.0 --end-temp 0.001 \\
        --epoch-hard 60 --epochs 60

It trains on the card; ``--device cpu`` runs on the CPU. The lr is scaled by
batch_size/8 as in the reference; the args are written to ``args.json`` and
``argsv.txt`` in the checkpoint directory
``<results_dir>/<dataset>/checkpoints_<time>/``. ``--last_ckpt`` resumes
from a checkpoint of either package (a JAX one restarts the optimizer);
``--finetune`` loads the weights of a flax msgpack checkpoint, or of a
``.pth`` in the reference's torch names, merged as the JAX importer merges
(``utils/torch_import.py``); ``--pretrained_scenenet`` warm-starts from a
SceneNet ``.pth`` without its heads; ``--he_init`` re-draws the conv
kernels. ``--dataset`` reads the prepared on-disk layouts
(``cli/seg_build.py::make_dataset``); ``--packed_stem`` trains on batches
packed 2×2 in the loader's prefetch thread. Every model of the JAX CLI
trains: ``--dynamic --global-gate`` (SkipGateESANet), ``--dynamic``
(local-gate SkipESANet, ``--block-rule``), the static ESANet and
``--modality rgb|depth`` (ESANetOneModality), each on relu, swish or
hswish (``--activation``); ``--freeze`` applies to the dynamic models
only. Flags of features the port does not have yet raise
(``cli/seg_build.py::check_supported``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from datetime import datetime

import torch

from dynmm_tpu_torch.cli.seg_args import ArgumentParserRGBDSegmentation
from dynmm_tpu_torch.cli.seg_build import (build_model, check_supported,
                                           compute_class_weights, prepare_data)
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.checkpoint import load_ckpt
from dynmm_tpu_torch.utils.init import apply_he_init
from dynmm_tpu_torch.utils.torch_import import (import_scenenet_pretrain,
                                                load_any_checkpoint)


def parse_args(argv=None):
    parser = ArgumentParserRGBDSegmentation(
        description="Efficient RGBD Indoor Semantic Segmentation (Training, "
                    "PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.set_common_args()
    parser.add_argument("--device", default=None,
                        help="torch device; the default is the card (cuda)")
    args = parser.parse_args(argv)
    check_supported(args, training=True)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.batch_size != 8:
        args.lr = args.lr * args.batch_size / 8
        warnings.warn(
            f"Adapting learning rate to {args.lr} because provided batch size "
            "differs from default batch size of 8.")

    training_starttime = datetime.now().strftime("%d_%m_%Y-%H_%M_%S-%f")
    ckpt_dir = os.path.join(args.results_dir, args.dataset,
                            f"checkpoints_{training_starttime}")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "args.json"), "w") as f:
        json.dump(vars(args), f, sort_keys=True, indent=4)
    with open(os.path.join(ckpt_dir, "argsv.txt"), "w") as f:
        f.write(" ".join(sys.argv if argv is None else ["train"] + list(argv))
                + "\n")

    print("preparing data")
    train_loader, valid_loader, *_ = prepare_data(args)
    n_classes = train_loader.dataset.n_classes_without_void
    class_weights = compute_class_weights(
        train_loader.dataset, n_classes, args.class_weighting,
        args.c_for_logarithmic_weighting)

    print("building model")
    model = build_model(args, n_classes)
    cfg = SegTrainConfig(
        epochs=args.epochs, lr=args.lr, optimizer=args.optimizer,
        momentum=args.momentum, weight_decay=args.weight_decay,
        batch_size=args.batch_size, loss_ratio=args.loss_ratio,
        flop_budget=args.flop_budget, temp=args.temp, end_temp=args.end_temp,
        epoch_ini=args.epoch_ini, epoch_hard=args.epoch_hard,
        eval_every=args.eval_every, save_every=args.save_every,
        baseline=args.baseline, freeze=args.freeze, soft_eval=args.soft_eval,
        dynamic=args.dynamic, global_gate=args.global_gate,
        grad_accum=args.grad_accum, modality=args.modality, debug=args.debug,
        packed_stem=args.packed_stem)
    trainer = SegTrainer(model, cfg, class_weights, device=args.device)
    # train.py draws a sample batch for its init here, which moves the
    # loader's shuffle and augmentation stream: drawn too, the same flags
    # train on the same batches
    train_loader.draw_sample()
    state = trainer.init_state()

    start_epoch, best_miou, best_miou_epoch = 0, 0.0, 0
    if args.last_ckpt:
        state, epoch_last, best_miou, best_miou_epoch = load_ckpt(
            args.last_ckpt, state)
        start_epoch = epoch_last + 1
        print(f"=> loaded checkpoint '{args.last_ckpt}' (epoch {epoch_last})")
    if args.pretrained_scenenet:
        import_scenenet_pretrain(model, args.pretrained_scenenet,
                                 context_module=args.context_module)
        print(f"Loaded pretrained SceneNet weights: {args.pretrained_scenenet}")
    if args.finetune:
        load_any_checkpoint(model, args.finetune)
        print(f"Loaded weights for finetuning: {args.finetune}")
    if args.he_init:
        apply_he_init(model, torch.Generator().manual_seed(42), n_classes)
        print("Applied He init.")

    if args.freeze and args.dynamic:
        print("Freeze everything but the soft gates")

    print("start training")
    trainer.fit(state, train_loader, valid_loader, ckpt_dir,
                start_epoch=start_epoch, best_miou=best_miou,
                best_miou_epoch=best_miou_epoch)
    print("Training completed")


if __name__ == "__main__":
    main()
