"""Time eager served requests of the 480×640 flagship, per serve mode.

    python3 dynmm_tpu_torch/bench_requests.py [--root DIR] [--tag NAME]
        [--reps N]

Builds the flagship with seeded random weights and the recipe gate
(``bench_assets/gate_recipe.msgpack``) on the card and serves the recipe
eval batch (``make_recipe_eval_batch(8, 480, 640)``, half of it
depth-needed) through ``serve`` in the modes ``dense``, ``batchmax``,
``compact`` at B=8 and B=1 and ``switch`` at B=1; a B=1 request takes the
batch's samples in turn. For each: the median over ``--reps`` requests of
the host's ms from the call to the class map (``torch.cuda.synchronize``
on both sides, as ``chip_smoke.py`` times a request), the 10th and 90th
percentiles, and the port's kernel launches of one request (``LAUNCHES``,
the last one's). ``--root`` takes the whole package from another checkout
(for example a ``git archive`` of a parent commit under ``build/parent``),
timed with this file's loop, so two trees can be timed in turns in one
call on one card: parent, change, change, parent. Prints the card's name
and power limit and writes the same to
``chiprun_out/bench_requests_<tag>.json`` beside this file's checkout.
TF32 is off for convolutions and matmuls, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = (("dense", 8), ("dense", 1), ("batchmax", 8), ("batchmax", 1),
         ("compact", 8), ("compact", 1), ("switch", 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose dynmm_tpu_torch package is timed")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
    from dynmm_tpu_torch.kernels import LAUNCHES, build_all, reset_launches
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import load_recipe_gate

    if not torch.cuda.is_available():
        print("bench_requests: no CUDA device", file=sys.stderr)
        return 1
    import dynmm_tpu_torch
    package = str(Path(dynmm_tpu_torch.__file__).resolve().parent)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_all()
    model = build_flagship(480, 640, 40, seed=0)
    load_recipe_gate(model)
    rgb, depth = (torch.from_numpy(a).cuda()
                  for a in make_recipe_eval_batch(8, 480, 640))
    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(8)]
    rows = []
    print(f"{args.tag}: {package}; {card}")
    for mode, b in CASES:
        feeds = [(rgb, depth)] if b == 8 else singles
        for i in range(2 * len(feeds)):  # warm-up (cuDNN's algorithm picks)
            serve(model, *feeds[i % len(feeds)], mode=mode)
        ms = []
        for i in range(args.reps):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(model, *feeds[i % len(feeds)], mode=mode)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        row = {"mode": mode, "batch": b, "median_ms": float(np.median(ms)),
               "p10_ms": float(np.percentile(ms, 10)),
               "p90_ms": float(np.percentile(ms, 90)),
               "launches_last": {k: v for k, v in LAUNCHES.items() if v}}
        rows.append(row)
        print(f"  {mode:8s} B={b}: median {row['median_ms']:.3f} ms "
              f"(p10 {row['p10_ms']:.3f}, p90 {row['p90_ms']:.3f}) over "
              f"{args.reps} requests; launches {row['launches_last']}",
              flush=True)
    out = HERE / "chiprun_out" / f"bench_requests_{args.tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"tag": args.tag, "package": package,
                               "card": card, "torch": torch.__version__,
                               "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
