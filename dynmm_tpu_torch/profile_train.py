"""Where a train step of the flagship spends its card time.

    python3 -m dynmm_tpu_torch.profile_train [--dtype float32|bfloat16]

Builds the 480×640 flagship (in ``--dtype``, fp32 by default; parameters
stay fp32) with seeded random weights on the card and the trainer of
``chip_smoke.py``'s phase 6 (SGD, lr 0.01, loss ratio 1e-4, soft gate), takes
3 steps on one synthetic B=8 batch to warm up, then traces 3 more with
``torch.profiler``. It prints the card's name and power
limit, each step's host-clock time (profiler on, ending in a synchronize),
the device's busy share of the traced window (union of kernel intervals),
device time and kernel launches per step, by group (cuDNN/cuBLAS
convolutions and GEMMs, other PyTorch ops) and for the top kernels. Writes
the same to ``chiprun_out/profile_train_<dtype>.json`` at the root of the
checkout. TF32 is off for convolutions and matmuls, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset
from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
from dynmm_tpu_torch.profile_serve import _busy_us, _group
from dynmm_tpu_torch.serve import build_flagship
from dynmm_tpu_torch.train.seg import DOWN_RATES, SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.device import card_line

BATCH, HEIGHT, WIDTH, CLASSES = 8, 480, 640, 40
WARMUP = STEPS = 3  # steps before the trace, steps traced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the model's compute dtype (parameters stay fp32)")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; {args.dtype}", flush=True)
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=3, dtype=(
        torch.bfloat16 if args.dtype == "bfloat16" else None))
    cfg = SegTrainConfig(epochs=2, lr=0.01, optimizer="SGD", loss_ratio=1e-4,
                         epoch_hard=60, batch_size=BATCH)
    trainer = SegTrainer(model, cfg, torch.ones(CLASSES))
    state = trainer.init_state()
    ds = SyntheticSegDataset(n=BATCH, height=HEIGHT, width=WIDTH,
                             split="train", mixed_modality_frac=0.5)
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                          phase="train")
    batch = next(iter(SegLoader(ds, pre, batch_size=BATCH, prefetch=0)))
    cuda = lambda a: torch.from_numpy(a).cuda()
    step_args = (cuda(batch["image"]), cuda(batch["depth"]),
                 [cuda(batch["label"])]
                 + [cuda(batch["label_down"][r]) for r in DOWN_RATES],
                 1.0, False, False, torch.Generator())

    def step() -> float:
        t0 = time.perf_counter()
        trainer.train_step(state, *step_args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(WARMUP):
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        step_ms = [step() for _ in range(STEPS)]
        wall_us = (time.perf_counter() - t_start) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device events")
    n = STEPS
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    by_group: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        for table, key in ((by_name, e.name), (by_group, _group(e.name))):
            table[key][0] += dur / n
            table[key][1] += 1
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    result = {
        "card": card, "dtype": args.dtype, "batch": BATCH,
        "step_ms": step_ms, "device_busy_share": busy / wall_us,
        "device_ms_per_step": sum(v[0] for v in by_name.values()) / 1e3,
        "launches_per_step": len(kernels) // n,
        "groups_per_step": {k: {"ms": v[0] / 1e3, "launches": v[1] // n}
                            for k, v in sorted(by_group.items(),
                                               key=lambda kv: -kv[1][0])},
        "top_kernels_per_step": [
            {"name": k[:120], "ms": v[0] / 1e3, "launches": v[1] // n}
            for k, v in sorted(by_name.items(),
                               key=lambda kv: -kv[1][0])[:25]],
    }
    print(f"B={BATCH} train steps {[round(x, 2) for x in step_ms]} ms "
          f"(profiler on); device busy {result['device_busy_share'] * 100:.1f}"
          f" % of the window; device time {result['device_ms_per_step']:.2f} "
          f"ms and {result['launches_per_step']} kernel launches a step "
          f"[{card}]")
    for k, v in result["groups_per_step"].items():
        print(f"   {v['ms']:8.3f} ms  x{v['launches']:<5d} {k}")
    for t in result["top_kernels_per_step"][:12]:
        print(f"     {t['ms']:8.3f} ms  x{t['launches']:<5d} {t['name'][:90]}")
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_train_{args.dtype}.json").write_text(
        json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
