"""Time the one-launch NonBottleneck1D block against two pair launches.

    python3 -m dynmm_tpu_torch.bench_nbt1d

On the card, at the flagship's four block levels (C = 64…512 at 120×160 …
15×20) and B = 8 and 1, with seeded inputs: ``nbt1d_fused`` at each band
height (0 = the kernel's own choice), two ``nbt1d_pair`` calls and the
plain version, CUDA-event means of 10 calls after 2 warm-up, each kernel
checked against the plain version (≤ 1e-4 of max |plain|; the two pairs'
error is kept). Bounds: the block's FLOP on fp32 CUDA cores, and as 3xTF32
on the tensor cores (three TF32 products per fp32 product). This is the
measurement behind ``NBT1D_FUSED_MAX_C`` and the kernel's band rule; it
prints the card's name and power limit and writes
``chiprun_out/bench_nbt1d.json`` at the root of the checkout.
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
BANDS = (0, 2, 4, 8, 16)
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
                runs = [("two nbt1d_pair", pairs)] + [
                    (f"nbt1d_fused T={t}",
                     lambda t=t: nbt1d.nbt1d_fused(x, *p, band_rows=t))
                    for t in BANDS]
                for what, fn in runs:
                    err = (fn() - ref).abs().max().item() / scale
                    if not err <= 1e-4:
                        raise RuntimeError(f"{what} C={c} B={b}: error "
                                           f"{err:.3g} of max |plain|")
                    if fn is pairs:
                        row["two_pair_rel_err"] = err
                for t, (_, fn) in zip(BANDS, runs[1:]):
                    row[f"fused_T{t}_ms"] = time_ms(fn)
            rows.append(row)
            print(" ".join(f"{k}={v:.3g}" if k.endswith("err") else
                           f"{k}={v:.4f}" if isinstance(v, float) else
                           f"{k}={v}" for k, v in row.items()), flush=True)
    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_nbt1d.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
