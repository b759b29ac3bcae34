"""Where a served flagship forward spends its card time.

    python3 -m dynmm_tpu_torch.profile_serve [--mode MODE] [--low_res]
        [--dtype float32|bfloat16] [--quant int8]

Builds the 480×640 flagship (in ``--dtype``, fp32 by default; with
``--quant int8`` the int8 net, calibrated on two seeded B=8 batches and
packed) with seeded random weights on the card, warms
up, then traces 3 requests at B=8 and 3 at B=1 served through ``--mode``
(``serve``'s modes; ``dense`` by default, the switch modes at B=1 only)
with ``torch.profiler``. It prints the card's name and power limit and, for
each batch size, the host-clock latency (profiler on),
the device's busy share of the traced window (union of kernel intervals
over the window) and device time by kernel, grouped into the port's
kernels, cuDNN/cuBLAS convolutions and other PyTorch ops. Writes the same to
``chiprun_out/profile_serve_<mode>[_low_res][_bf16][_int8].json`` at the
root of the checkout. TF32 is off for convolutions and matmuls, as in
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

from dynmm_tpu_torch.serve import SERVE_MODES, build_flagship, serve
from dynmm_tpu_torch.utils.device import card_line
from dynmm_tpu_torch.utils.quantize import quantize_int8

PORT_KERNELS = ("nbt1d_block_kernel", "nbt1d_conv_kernel", "sums_kernel",
                "se_squeeze_kernel", "se_mlp_kernel", "se_mix_kernel",
                "stem_fuse_pool_kernel", "learned_upsample_kernel")
CONV_MARKS = ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "fft")


def _group(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return "port:" + k
    low = name.lower()
    if any(m in low for m in CONV_MARKS):
        return "cudnn/cublas conv+gemm"
    return "other torch ops"


def _busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_batch(model, batch: int, n: int = 3, **serve_kw) -> dict:
    g = torch.Generator(device="cuda").manual_seed(batch)
    reqs = [(torch.randn(batch, 480, 640, 3, generator=g, device="cuda"),
             torch.randn(batch, 480, 640, 1, generator=g, device="cuda"))
            for _ in range(n)]
    for rgb, depth in reqs[:2]:
        serve(model, rgb, depth, **serve_kw)
    torch.cuda.synchronize()
    lat = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for rgb, depth in reqs:
            t0 = time.perf_counter()
            serve(model, rgb, depth, **serve_kw)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        wall_us = (time.perf_counter() - t_start) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the trace holds no device events")
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    by_group: dict[str, float] = defaultdict(float)
    intervals = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name][0] += dur / n
        by_name[e.name][1] += 1
        by_group[_group(e.name)] += dur / n
        intervals.append((e.time_range.start, e.time_range.end))
    busy = _busy_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    return {
        "batch": batch, "requests": n, "latency_ms": lat,
        "device_busy_share": busy / wall_us,
        "device_ms_per_request": sum(v[0] for v in by_name.values()) / 1e3,
        "groups_ms_per_request": {k: v / 1e3 for k, v in
                                  sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_request": [
            {"name": k[:120], "ms": v[0] / 1e3, "launches": v[1] // n}
            for k, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="dense", choices=SERVE_MODES)
    ap.add_argument("--low_res", action="store_true",
                    help="serve from the H/4 logits")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the model's compute dtype (parameters stay fp32)")
    ap.add_argument("--quant", default="none", choices=("none", "int8"),
                    help="int8: the int8 net (quantized convs)")
    args = ap.parse_args(argv)
    bf16 = args.dtype == "bfloat16"
    int8 = args.quant == "int8"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}; mode {args.mode}"
          f"{', low_res' if args.low_res else ''}; {args.dtype}"
          f"{', int8' if int8 else ''}", flush=True)
    model = build_flagship(seed=0, dtype=torch.bfloat16 if bf16 else None,
                           quant="int8" if int8 else None)
    if int8:
        g = torch.Generator(device="cuda").manual_seed(99)
        quantize_int8(model, [
            (torch.randn(8, 480, 640, 3, generator=g, device="cuda"),
             torch.randn(8, 480, 640, 1, generator=g, device="cuda"))
            for _ in range(2)], hard=True)
    batches = (1,) if args.mode.startswith("switch") else (8, 1)
    results = [profile_batch(model, b, mode=args.mode, low_res=args.low_res)
               for b in batches]
    for r in results:
        print(f"B={r['batch']}: latency {[round(x, 2) for x in r['latency_ms']]}"
              f" ms; device busy {r['device_busy_share'] * 100:.1f} % of the "
              f"window; device time {r['device_ms_per_request']:.2f} ms/request")
        for k, v in r["groups_ms_per_request"].items():
            print(f"   {v:8.3f} ms  {k}")
        for t in r["top_kernels_ms_per_request"][:12]:
            print(f"     {t['ms']:8.3f} ms  x{t['launches']:<4d} {t['name'][:90]}")
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = (f"profile_serve_{args.mode}{'_low_res' if args.low_res else ''}"
            f"{'_bf16' if bf16 else ''}{'_int8' if int8 else ''}")
    (out / f"{name}.json").write_text(json.dumps(
        {"card": card, "mode": args.mode, "low_res": args.low_res,
         "dtype": args.dtype, "quant": args.quant, "results": results},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
