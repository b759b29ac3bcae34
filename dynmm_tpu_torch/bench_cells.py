"""Time the port's small-cell kernels at the flagship's shapes, B=8 and B=1.

    python3 dynmm_tpu_torch/bench_cells.py [--root DIR] [--tag NAME]

Runs ``learned_upsample`` at the five upsample sites and ``se_fuse_mixed``
at the four fusion levels of the 480×640 flagship, on seeded inputs on the
card, each beside its plain PyTorch version: the max error over max |plain|
(fails above 1e-4), and per call and per dense forward (each shape's time
times its calls) the device time of kernel and plain version (``device_ms``:
calls replayed from a CUDA graph) and the kernel's time when the host
issues each call (``time_ms``: back-to-back eager calls, which a short call
leaves host-bound). ``--root`` takes the kernels from another checkout (for
example a ``git archive`` of a parent commit), timed with this checkout's
helpers, so two trees can be timed in turns in one call on one card.
Prints the card's name and power limit and writes the same to
``chiprun_out/bench_cells_<tag>.json`` beside this file's checkout.
TF32 is off for convolutions and matmuls, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
UPSAMPLE_SITES = ((512, 15, 20), (256, 30, 40), (128, 60, 80),
                  (40, 120, 160), (40, 240, 320))
SE_LEVELS = ((64, 120, 160), (128, 60, 80), (256, 30, 40), (512, 15, 20))
TOL = 1e-4


def cases(gen: torch.Generator, batch: int):
    """(kernel, shape, kernel call, plain call) at every site."""
    from dynmm_tpu_torch.kernels import se, upsample

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = []
    for c, h, w in UPSAMPLE_SITES:
        x = randn(batch, h, w, c)
        k, b = randn(3, 3, c, scale=0.3), randn(c, scale=0.1)
        out.append(("learned_upsample", f"{batch}x{h}x{w}x{c}",
                    lambda x=x, k=k, b=b: upsample.learned_upsample(x, k, b),
                    lambda x=x, k=k, b=b: upsample.learned_upsample_plain(
                        x, k, b)))
    for c, h, w in SE_LEVELS:
        r, d = randn(batch, h, w, c), randn(batch, h, w, c)
        cr = c // 16
        ws = []
        for _ in range(2):
            ws += [randn(c, cr, scale=1 / math.sqrt(c)), randn(cr, scale=0.1),
                   randn(cr, c, scale=1 / math.sqrt(cr)), randn(c, scale=0.1)]
        wr = torch.rand(batch, generator=gen, device="cuda")
        out.append(("se_fuse_mixed", f"{batch}x{h}x{w}x{c}",
                    lambda r=r, d=d, wr=wr, ws=ws: se.se_fuse_mixed(
                        r, d, wr, *ws),
                    lambda r=r, d=d, wr=wr, ws=ws: se.se_fuse_mixed_plain(
                        r, d, wr, *ws)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels to time")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_cells: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from dynmm_tpu_torch.utils.device import card_line, device_ms, time_ms

    root = Path(args.root).resolve()
    if root != HERE:  # the kernels of the other checkout
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "dynmm_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(root))
    from dynmm_tpu_torch.kernels import build_all

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_all()
    rows, per_forward = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for batch in (8, 1):
            for name, shape, kern, plain in cases(gen, batch):
                out_k, out_p = kern(), plain()
                rel = ((out_k - out_p).abs().max()
                       / out_p.abs().max()).item()
                if not rel <= TOL:
                    raise RuntimeError(f"{name} {shape}: error {rel:.3g} of "
                                       f"max |plain| > {TOL}")
                ms, plain_ms = device_ms(kern, iters=20), device_ms(plain)
                host_ms = time_ms(kern, iters=20)
                rows.append({"kernel": name, "shape": shape, "batch": batch,
                             "ms": ms, "plain_ms": plain_ms,
                             "host_paced_ms": host_ms, "rel_err": rel})
                tot = per_forward.setdefault(f"{name} B={batch}", [0.0] * 3)
                tot[0] += ms
                tot[1] += plain_ms
                tot[2] += host_ms
                print(f"  [{args.tag}] {name:16s} {shape:16s} kernel "
                      f"{ms:.4f} ms  plain {plain_ms:.4f} ms  host-paced "
                      f"{host_ms:.4f} ms  rel err {rel:.3g}", flush=True)
    for key, (ms, plain_ms, host_ms) in per_forward.items():
        print(f"  [{args.tag}] {key} per dense forward: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, host-paced {host_ms:.4f} ms",
              flush=True)
    print(f"  [{args.tag}] card: {card}; root {args.root}", flush=True)
    out = HERE / "chiprun_out" / f"bench_cells_{args.tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "root": args.root, "rows": rows,
                               "per_forward": per_forward}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
