"""Batch inference CLI of the port, the twin of the repo's ``predict.py``:
runs a trained fusion-level DynMM over a prepared-dataset split and writes
coloured segmentation maps plus a routing and throughput report.

    python -m dynmm_tpu_torch.cli.predict --ckpt_path ckpt.msgpack \\
        --dataset_dir datasets/nyuv2 --split test --out_dir preds/ \\
        [--num 16] [--serve_mode batchmax|dense|compact|switch|switch_host] \\
        [--capacity_factor 1.25] [--output_res quarter] [--packed_stem]

It runs on the card; ``--device cpu`` runs on the CPU. Requests go through
``serve.py::serve`` with the mode of ``--serve_mode`` (the switch modes at
``--batch_size 1``); ``--capacity_factor`` (compact only) serves the strict
schedule of branch ratios estimated with ``gate_only`` over
``--calib_batches`` batches, caps from each batch's size;
``--output_res quarter`` takes the class map of the H/4 logits and repeats
it ×4 on the host; ``--packed_stem`` packs the inputs 2×2 in the loader's
prefetch thread. Writes ``pred_00000.png`` … (colour
``class_colors(n + 1)[pred + 1]``, through ``data/png.py``) and prints the
path distribution, the expected GFLOPs a sample and frames/s (host clock,
forward to class map on the host). ``--export_path`` / ``--export_platforms``
(``torch.export``) and ``--quant int8`` raise, naming ROADMAP A6;
``--dtype bfloat16`` names A3.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np
import torch

from dynmm_tpu_torch.cli.seg_args import ArgumentParserRGBDSegmentation
from dynmm_tpu_torch.cli.seg_build import (build_model, check_supported,
                                           make_dataset)
from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.data import png
from dynmm_tpu_torch.data.nyuv2 import class_colors
from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader, SegPreprocessor,
                                                    pack_stem_batch)
from dynmm_tpu_torch.models.skip_gate import capacity_ladders, flop_table
from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.serve import SERVE_MODES, serve
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint


def build_parser() -> ArgumentParserRGBDSegmentation:
    parser = ArgumentParserRGBDSegmentation(
        description="Batch RGB-D segmentation inference (PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.set_common_args()
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--out_dir", default="./preds")
    parser.add_argument("--num", type=int, default=0,
                        help="limit sample count")
    parser.add_argument("--export_path", default="",
                        help="not ported (torch.export, ROADMAP A6)")
    parser.add_argument("--export_platforms", default="",
                        help="not ported (torch.export, ROADMAP A6)")
    parser.add_argument(
        "--serve_mode", default="batchmax", choices=SERVE_MODES,
        help="execution strategy: batchmax = batch-adaptive depth skipping; "
             "dense = every branch, hard gate weights; compact = per-sample "
             "bucket compaction (forward_routed_compact); switch / "
             "switch_host = per-stage skipping at batch_size 1")
    parser.add_argument(
        "--output_res", default="full", choices=("full", "quarter"),
        help="'quarter' serves the decoder's H/4 logits and repeats the "
             "class map x4 on the host; 'full' matches the reference")
    parser.add_argument(
        "--capacity_factor", type=float, default=0.0,
        help="with --serve_mode compact: > 0 serves the strict capacity-"
             "factor schedule from branch ratios estimated on "
             "--calib_batches batches; 0 keeps the exact (0, bs/2, bs) "
             "ladder")
    parser.add_argument("--device", default=None,
                        help="torch device; the default is the card (cuda)")
    return parser


def main(argv=None) -> dict:
    """Run the predictions; returns {"n": written, "ratios": path
    distribution, "fps": frames/s}."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.capacity_factor > 0 and args.serve_mode != "compact":
        parser.error("--capacity_factor applies to --serve_mode compact")
    args.dynamic = True
    args.global_gate = True
    if args.export_path or args.export_platforms:
        raise NotImplementedError(
            "not ported yet: --export_path/--export_platforms (a serialized "
            "serving forward through torch.export, ROADMAP A6)")
    check_supported(args)

    ds = make_dataset(args, args.split)
    n_classes = ds.n_classes_without_void
    pre = SegPreprocessor(getattr(ds, "depth_mean", 0.0),
                          getattr(ds, "depth_std", 1.0),
                          args.height, args.width, phase="test")
    # pack in the prefetch thread (overlapped with the device step)
    post = (pack_stem_batch if args.packed_stem and args.height % 2 == 0
            and args.width % 2 == 0 else None)
    loader = SegLoader(ds, pre, batch_size=args.batch_size, post=post)
    model = build_model(args, n_classes)
    load_any_checkpoint(model, args.ckpt_path)
    print(f"Loaded checkpoint from {args.ckpt_path}")
    if args.serve_mode in ("switch", "switch_host") and args.batch_size != 1:
        parser.error(f"--serve_mode {args.serve_mode} requires --batch_size 1 "
                     "(forward_switch routes the whole batch by sample 0)")
    device = resolve_device(args.device)
    model = model.to(device, memory_format=torch.channels_last).eval()
    # the kernels' weight layouts computed where they are served (as
    # SegTrainer.validate does): a CPU-folded BN differs in the last bits
    pack_weights(model)
    to_dev = lambda x: torch.as_tensor(np.asarray(x)).to(device)
    low_res = args.output_res == "quarter"

    ratios = None
    if args.capacity_factor > 0:
        # strict capacity-factor serving: the deployment's branch ratios
        # (stems + gate only), then the single-rung schedule
        gstats = GateStats()
        with torch.inference_mode():
            for b in itertools.islice(iter(loader), args.calib_batches):
                gstats.append(model.gate_only(to_dev(b["image"]),
                                              to_dev(b["depth"])))
        ratios = gstats.branch_ratios()
        print(f"capacity-factor serving: estimated ratios "
              f"{np.round(ratios, 3)}, strict schedule "
              f"{capacity_ladders(ratios, args.batch_size, capacity_factor=args.capacity_factor)}")

    colors = class_colors(n_classes + 1)
    os.makedirs(args.out_dir, exist_ok=True)
    stats = GateStats()
    n_done, t_model = 0, 0.0
    for batch in loader:
        t0 = time.perf_counter()
        rgb, depth = to_dev(batch["image"]), to_dev(batch["depth"])
        kw = {}
        if ratios is not None:
            # caps from this batch's size: a ragged tail batch gets its
            # own (smaller) schedule
            kw = dict(caps=capacity_ladders(
                ratios, rgb.shape[0], capacity_factor=args.capacity_factor),
                strict_caps=True)
        class_map, weight = serve(model, rgb, depth, mode=args.serve_mode,
                                  low_res=low_res, **kw)
        pred = class_map.cpu().numpy()
        t_model += time.perf_counter() - t0
        stats.append(weight)
        for img in pred:
            # prediction class c = label c+1
            png.write(os.path.join(args.out_dir, f"pred_{n_done:05d}.png"),
                      colors[img + 1])
            n_done += 1
            if args.num and n_done >= args.num:
                break
        if args.num and n_done >= args.num:
            break

    dist = stats.branch_ratios()
    table = flop_table(args.encoder, "total")
    fps = n_done / max(t_model, 1e-9)
    print(f"wrote {n_done} predictions to {args.out_dir}")
    print(f"path distribution: {np.round(dist, 3)}")
    print(f"expected total GFLOPs/sample: {stats.expected_flops(table):.3f}")
    print(f"model throughput: {fps:.2f} frames/sec "
          "(incl. host sync and the class map's copy to the host)")
    return {"n": n_done, "ratios": dist, "fps": fps}


if __name__ == "__main__":
    main()
