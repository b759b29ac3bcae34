"""Time the one-launch NonBottleneck1D block against two pair launches.

    python3 -m dynmm_tpu_torch.bench_nbt1d

On the card, at the flagship's four block levels (C = 64…512 at 120×160 …
15×20) and B = 8 and 1, with seeded inputs: ``nbt1d_fused`` at each tile
height (``band_rows``; 0 = the kernel's own rule; a height whose tile does
not fit in shared memory is skipped), two ``nbt1d_pair`` calls and the
plain version, CUDA-event means of 10 calls after 2 warm-up, each kernel
checked against the plain version (≤ 1e-4 of max |plain|; every error is
kept). Bounds: the block's FLOP on fp32 CUDA cores, and as 3xTF32 on the
tensor cores (three TF32 products per fp32 product). Per level it prints
the ratio of the rule's one-launch time to the two pairs' at B=8 and B=1:
``NBT1D_FUSED_MAX_C`` is the widest level whose B=8 ratio is at most 1,
with every level below it under 1 too. This is the measurement behind
that constant and the kernel's tile rule; it prints the card's name and
power limit and writes ``chiprun_out/bench_nbt1d.json`` at the root of the
checkout.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch

from dynmm_tpu_torch.kernels import build_all, nbt1d
from dynmm_tpu_torch.utils.device import card_line, time_ms

LEVELS = ((64, 120, 160), (128, 60, 80), (256, 30, 40), (512, 15, 20))
TILE_ROWS = (0, 2, 4, 6, 8)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_nbt1d: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; built in {build_all():.2f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    rows = []
    for c, h, w in LEVELS:
        std = math.sqrt(2.0 / (3 * c))
        p = []
        for _ in range(2):
            p += [randn(3, c, c, scale=std), randn(c, scale=0.05),
                  randn(3, c, c, scale=std), randn(c, scale=0.05),
                  0.75 + 0.25 * randn(c).tanh(), randn(c, scale=0.1)]
        for b in (8, 1):
            x = randn(b, h, w, c)
            with torch.inference_mode():
                ref = nbt1d.nbt1d_fused_plain(x, *p)
                scale = ref.abs().max().item()
                flops = 24.0 * c * c * b * h * w

                def pairs():
                    return nbt1d.nbt1d_pair(nbt1d.nbt1d_pair(x, *p[:6]), *p[6:],
                                            identity=x)

                row = {"C": c, "H": h, "W": w, "B": b,
                       "bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
                       "bound_tf32x3_ms": 3 * flops / PEAK_TF32_FLOPS * 1e3,
                       "plain_ms": time_ms(lambda: nbt1d.nbt1d_fused_plain(x, *p)),
                       "two_pair_ms": time_ms(pairs)}
                runs = [("two_pair", pairs)] + [
                    (f"fused_T{t}",
                     lambda t=t: nbt1d.nbt1d_fused(x, *p, band_rows=t))
                    for t in TILE_ROWS]
                for what, fn in runs:
                    try:
                        out = fn()
                    except RuntimeError as e:  # the tile does not fit
                        print(f"  C={c} B={b} {what}: {e}", flush=True)
                        continue
                    err = (out - ref).abs().max().item() / scale
                    if not err <= 1e-4:
                        raise RuntimeError(f"{what} C={c} B={b}: error "
                                           f"{err:.3g} of max |plain|")
                    row[f"{what}_rel_err"] = err
                    if fn is not pairs:
                        row[f"{what}_ms"] = time_ms(fn)
                row["fused_over_two_pair"] = row["fused_T0_ms"] / row["two_pair_ms"]
            rows.append(row)
            print(" ".join(f"{k}={v:.3g}" if k.endswith("err") else
                           f"{k}={v:.4f}" if isinstance(v, float) else
                           f"{k}={v}" for k, v in row.items()), flush=True)
    for c, _, _ in LEVELS:
        ratio = {r["B"]: r["fused_over_two_pair"] for r in rows if r["C"] == c}
        print(f"C={c}: nbt1d_fused / two nbt1d_pair = {ratio[8]:.3f} at B=8, "
              f"{ratio[1]:.3f} at B=1", flush=True)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_nbt1d.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
