"""Segmentation evaluation CLI of the port, the twin of the repo's
``eval.py`` (the reference's ``FusionDynMM/eval.py``), with its flags and
printed lines:

    python -m dynmm_tpu_torch.cli.eval --dynamic --global-gate --hard \\
        --dataset nyuv2 --dataset_dir datasets/nyuv2 --ckpt_path ckpt.msgpack
    python -m dynmm_tpu_torch.cli.eval ... --num_runs 10 --mode 0|1|2 \\
        --noise 0.3                                   # robustness
    python -m dynmm_tpu_torch.cli.eval ... --output_res quarter
    python -m dynmm_tpu_torch.cli.eval ... --capacity_factor 1.25

It runs on the card; ``--device cpu`` runs on the CPU. ``--ckpt_path``
reads a flax ``.msgpack`` checkpoint of either package or a torch ``.pth``
(``utils/torch_import.py``). Run r seeds its noise generator with r; noise
is injected per batch with probability 1/3, scaled by noise·mean(|x|), on
the raw layout (``--packed_stem`` packs after). ``--output_res quarter``
scores the quarter-resolution serving chain, ``--capacity_factor`` the
strict capacity-factor compact forward on branch ratios estimated with
``gate_only`` over ``--calib_batches`` batches. Prints the mIoU of each run
(per camera on multi-camera datasets), the branch ratios with the depth
encoder's and the whole net's GFLOPs, then the mean and std over runs.
Flags of features the port does not have yet raise
(``cli/seg_build.py::check_supported``: ``--quant int8`` ROADMAP A6,
``--dtype bfloat16`` A3).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools

import numpy as np
import torch

from dynmm_tpu_torch.cli.seg_args import ArgumentParserRGBDSegmentation
from dynmm_tpu_torch.cli.seg_build import (build_model, check_supported,
                                           prepare_data)
from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.models.skip_gate import capacity_ladders, flop_table
from dynmm_tpu_torch.train.metrics import ConfusionMatrix
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint


def build_parser() -> ArgumentParserRGBDSegmentation:
    parser = ArgumentParserRGBDSegmentation(
        description="Efficient RGBD Indoor Semantic Segmentation (Evaluation, "
                    "PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.set_common_args()
    parser.add_argument("--ckpt_path", required=True, type=str,
                        help="Path to the checkpoint of the trained model "
                             "(.msgpack or .pth torch).")
    parser.add_argument("--hard", action="store_true",
                        help="use hard gates during inference time")
    parser.add_argument("--mode", type=int, default=-1,
                        help="-1: no noise, 0: rgb, 1: depth, 2: both")
    parser.add_argument("--num_runs", "--num-runs", type=int, default=1)
    parser.add_argument("--noise", type=float, default=0.0)
    parser.add_argument("--ini", action="store_true")
    parser.add_argument("--per_class_iou", "--per-class-iou",
                        action="store_true",
                        help="print the per-class IoU table of the last run")
    parser.add_argument(
        "--output_res", default="full", choices=("full", "quarter"),
        help="'quarter' scores the quarter-res serving chain: argmax the "
             "H/4 logits, nearest-resize the class map to label "
             "resolution; 'full' is the reference's chain (full-res logits "
             "-> bilinear resize -> argmax).")
    parser.add_argument(
        "--capacity_factor", type=float, default=0.0,
        help="> 0 scores the strict capacity-factor serving mode: branch "
             "ratios estimated on --calib_batches clean batches (gate_only), "
             "each depth stage then runs at one capacity "
             "ceil(bs*P(k>=i)*F); overflow samples lose that stage's depth "
             "contribution. Requires --dynamic --global-gate --hard.")
    parser.add_argument("--device", default=None,
                        help="torch device; the default is the card (cuda)")
    return parser


def main(argv=None) -> np.ndarray:
    """Run the evaluation; returns the per-run mIoU (percent)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.capacity_factor > 0 and not (
            args.dynamic and args.global_gate and args.hard
            and not args.baseline and args.modality == "rgbd"):
        parser.error("--capacity_factor requires --dynamic --global-gate "
                     "--hard (non-baseline, rgbd)")
    check_supported(args)

    _, data_loader, *extra_loaders = prepare_data(args)
    if args.valid_full_res:
        # evaluate at the dataset's native resolution (reference eval.py:51-54)
        data_loader = extra_loaders[0]
    n_classes = data_loader.dataset.n_classes_without_void

    model = build_model(args, n_classes)
    load_any_checkpoint(model, args.ckpt_path)
    print(f"Loaded checkpoint from {args.ckpt_path}")
    cfg = SegTrainConfig(
        dynamic=args.dynamic, global_gate=args.global_gate,
        baseline=args.baseline, soft_eval=not args.hard,
        modality=args.modality, debug=args.debug,
        packed_stem=args.packed_stem,
        low_res_eval=args.output_res == "quarter")
    trainer = SegTrainer(model, cfg, np.ones(n_classes, np.float32),
                         device=args.device)

    if args.capacity_factor > 0:
        # deployment branch ratios on clean batches (stems + gate only),
        # then the strict capacity schedule in the eval chain
        model.eval()
        stats = GateStats()
        with torch.inference_mode():
            for b in itertools.islice(iter(data_loader), args.calib_batches):
                stats.append(model.gate_only(trainer._tensor(b["image"]),
                                             trainer._tensor(b["depth"])))
        ratios = stats.branch_ratios()
        sched = capacity_ladders(ratios, args.batch_size,
                                 capacity_factor=args.capacity_factor)
        print(f"capacity-factor serving: estimated ratios "
              f"{np.round(ratios, 3)}, strict schedule {sched} "
              f"(factor {args.capacity_factor})")
        trainer.cfg = dataclasses.replace(
            cfg, serve_capacity_factor=args.capacity_factor)
        trainer.serve_ratios = ratios

    result = np.zeros(args.num_runs)
    cms: dict = {}
    for r in range(args.num_runs):
        stats = GateStats() if args.dynamic else None
        cms = {}
        miou, _ = trainer.validate(
            trainer.model, data_loader, noise_mode=args.mode,
            noise=args.noise, run_seed=r, collect_weights=stats,
            ini_stage=args.ini, out_cms=cms)
        camera = list(miou)[0]
        result[r] = miou[camera] * 100
        print(f"Run {r}, mIoU: {result[r]:0.2f}")
        if len(miou) > 1:  # multi-camera datasets: per-camera breakdown
            per_cam = " | ".join(f"{c}: {v*100:0.2f}" for c, v in miou.items())
            print(f"  per-camera mIoU  {per_cam}")
        if args.dynamic and args.global_gate and stats.weights.size:
            table = flop_table(args.encoder, "depth_enc")
            total = flop_table(args.encoder, "total")
            print(f"  branch ratios {np.round(stats.branch_ratios(), 3)} | "
                  f"Depth Encoder Flop {stats.selection_flops(table):.4f}G | "
                  f"Total Flop {stats.selection_flops(total):.4f}G")
    print(result)
    print(f"Mean {result.mean():.2f}, Std {result.std():.2f}")
    if args.per_class_iou and cms:
        names = getattr(data_loader.dataset, "class_names",
                        [f"class_{i}" for i in range(n_classes)])
        total = ConfusionMatrix(n_classes)
        for m in cms.values():
            total.matrix += m
        print("per-class IoU (last run, all cameras):")
        for name, v in zip(names, total.iou()):
            print(f"  {name:<20} {v*100:6.2f}")
    return result


if __name__ == "__main__":
    main()
