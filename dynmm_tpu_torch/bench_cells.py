"""Time the port's small-cell kernels at the family's shapes, B=8 and B=1.

    python3 dynmm_tpu_torch/bench_cells.py [--root DIR] [--tag NAME]
        [--only KERNEL ...] [--set NAME=VALUE ...] [--trace]

Runs, on seeded inputs on the card, each beside its plain PyTorch version:
``learned_upsample`` at the five upsample sites of the 480×640 flagship;
``se_fuse_mixed`` at the flagship's four fusion levels and the R50 net's
four (C = 256 to 2048) and on the 1×1 probe at C = 2048, whose time is the
cell's fixed cost; ``fused_se`` at the R34 one-modality net's five cells
and at C = 2048; ``channel_sums`` at the stem (the flagship's one call)
and at the local gates (R34's four, R50's widest at C = 1024), beside two
``torch.sum`` calls. The SE cells and the sums run in fp32 and in bf16
(``<name>.bf16``). For each: the max error over max |plain| (fails above
1e-4 in fp32; in bf16 above 1e-5 for the sums and 8e-3 for the SE cells,
chip_smoke's ``BF16_TOL``), the bytes bound at the H100's 3.35 TB/s, and
per call and per forward of each net (each shape's time times its calls)
the device time of kernel, plain version and library call (``device_ms``:
calls replayed from a CUDA graph) and the kernel's time when the host
issues each call (``time_ms``: back-to-back eager calls, which a short
call leaves host-bound). ``--root`` takes the kernels from another
checkout (for example a ``git archive`` of a parent commit), timed with
this checkout's helpers, so two trees can be timed in turns in one call on
one card; ``--set`` overrides a constant of that checkout's
``kernels/se.py`` (``--set SUMS_BLOCKS_PER_SM=8``) to compare grid rules;
``--only`` keeps the named kernels; ``--trace`` adds each call's device
time by CUDA kernel (``torch.profiler`` over 10 calls; the SE cell's
squeeze, MLP and mix apart). Prints the card's name and power limit and
writes the same to
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
UPSAMPLE_SITES = ((512, 15, 20), (256, 30, 40), (128, 60, 80),
                  (40, 120, 160), (40, 240, 320))
# (C, H, W, calls a forward, net): the fusion cells, the single-map cells,
# the channel sums
SE_LEVELS = ((64, 120, 160, 1, "R34"), (128, 60, 80, 1, "R34"),
             (256, 30, 40, 1, "R34"), (512, 15, 20, 1, "R34"),
             (256, 120, 160, 1, "R50"), (512, 60, 80, 1, "R50"),
             (1024, 30, 40, 1, "R50"), (2048, 15, 20, 1, "R50"),
             (2048, 1, 1, 0, "probe"))
ONE_MODALITY = ((64, 240, 320, 1, "R34 one-modality"),
                (64, 120, 160, 1, "R34 one-modality"),
                (128, 60, 80, 1, "R34 one-modality"),
                (256, 30, 40, 1, "R34 one-modality"),
                (512, 15, 20, 1, "R34 one-modality"),
                (2048, 15, 20, 1, "R50 one-modality"))
SUMS_SITES = ((64, 240, 320, 1, "R34 stem"),
              (64, 240, 320, 1, "R34 local-gate"),
              (64, 120, 160, 1, "R34 local-gate"),
              (128, 60, 80, 1, "R34 local-gate"),
              (256, 30, 40, 1, "R34 local-gate"),
              (1024, 30, 40, 1, "R50 local-gate"))
TOL = {"fp32": 1e-4, "channel_sums.bf16": 1e-5, "se_fuse_mixed.bf16": 8e-3,
       "fused_se.bf16": 8e-3, "learned_upsample": 1e-4}


def se_weights(randn, c: int, maps: int) -> list:
    cr = c // 16
    ws = []
    for _ in range(maps):
        ws += [randn(c, cr, scale=1 / math.sqrt(c)), randn(cr, scale=0.1),
               randn(cr, c, scale=1 / math.sqrt(cr)), randn(c, scale=0.1)]
    return ws


def se_weight_bytes(c: int, maps: int) -> int:
    cr = c // 16
    return maps * (2 * c * cr + cr + c) * 4


def cases(gen: torch.Generator, batch: int):
    """(kernel, shape, net, calls, kernel call, plain call, library call,
    bytes) at every site."""
    from dynmm_tpu_torch.kernels import se, upsample

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = []
    for c, h, w in UPSAMPLE_SITES:
        x = randn(batch, h, w, c)
        k, b = randn(3, 3, c, scale=0.3), randn(c, scale=0.1)
        out.append(("learned_upsample", f"{batch}x{h}x{w}x{c}", "R34", 1,
                    lambda x=x, k=k, b=b: upsample.learned_upsample(x, k, b),
                    lambda x=x, k=k, b=b: upsample.learned_upsample_plain(
                        x, k, b), None, 5 * x.numel() * 4))
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, ".bf16")):
        esize = torch.finfo(dtype).bits // 8
        for c, h, w, calls, net in SE_LEVELS:
            r = randn(batch, h, w, c).to(dtype)
            d = randn(batch, h, w, c).to(dtype)
            ws = se_weights(randn, c, 2)
            wr = torch.rand(batch, generator=gen, device="cuda")
            out.append(("se_fuse_mixed" + sfx, f"{batch}x{h}x{w}x{c}", net,
                        calls,
                        lambda r=r, d=d, wr=wr, ws=ws: se.se_fuse_mixed(
                            r, d, wr, *ws),
                        lambda r=r, d=d, wr=wr, ws=ws: se.se_fuse_mixed_plain(
                            r, d, wr, *ws), None,
                        3 * r.numel() * esize + se_weight_bytes(c, 2)))
        for c, h, w, calls, net in ONE_MODALITY:
            x = randn(batch, h * w, c).to(dtype)
            ws = se_weights(randn, c, 1)
            out.append(("fused_se" + sfx, f"{batch}x{h}x{w}x{c}", net, calls,
                        lambda x=x, ws=ws: se.fused_se(x, *ws),
                        lambda x=x, ws=ws: se.se_reference(x, *ws), None,
                        2 * x.numel() * esize + se_weight_bytes(c, 1)))
        for c, h, w, calls, net in SUMS_SITES:
            r = randn(batch, h, w, c).to(dtype)
            d = randn(batch, h, w, c).to(dtype)
            out.append(("channel_sums" + sfx, f"{batch}x{h}x{w}x{c}", net,
                        calls,
                        lambda r=r, d=d: se.channel_sums(r, d),
                        lambda r=r, d=d: se.channel_sums_plain(r, d),
                        lambda r=r, d=d: (
                            torch.sum(r, dim=(1, 2), dtype=torch.float32),
                            torch.sum(d, dim=(1, 2), dtype=torch.float32)),
                        2 * r.numel() * esize + 2 * batch * c * 4))
    return out


def kernel_split(fn, calls: int = 10) -> dict:
    """Device ms a call of ``fn`` by CUDA kernel name (template arguments
    dropped), from ``torch.profiler`` over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("<")[0].split("(")[0]
            split[name] = (split.get(name, 0.0) + (e.time_range.end
                           - e.time_range.start) / 1e3 / calls)
    return split


def _tuple(o):
    return o if isinstance(o, tuple) else (o,)


def _rel(outs, refs) -> float:
    err = max((a.float() - p.float()).abs().max().item()
              for a, p in zip(outs, refs))
    return err / max(p.float().abs().max().item() for p in refs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels to time")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--only", nargs="*", default=None,
                    help="kernels to keep (names without .bf16 keep both)")
    ap.add_argument("--set", nargs="*", default=[], metavar="NAME=VALUE",
                    help="constants of kernels/se.py to override")
    ap.add_argument("--trace", action="store_true",
                    help="each call's device time by CUDA kernel")
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
    from dynmm_tpu_torch.kernels import build_all, se

    for item in args.set:
        name, value = item.split("=", 1)
        if not hasattr(se, name):
            raise SystemExit(f"bench_cells: kernels/se.py has no {name}")
        setattr(se, name, type(getattr(se, name))(int(value)))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    build_all()
    rows, per_forward = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for batch in (8, 1):
            for (name, shape, net, calls, kern, plain, lib,
                 n_bytes) in cases(gen, batch):
                if args.only and not ({name, name.split(".")[0]}
                                      & set(args.only)):
                    continue
                outs_k, outs_p = _tuple(kern()), _tuple(plain())
                rel = _rel(outs_k, outs_p)
                tol = TOL.get(name, TOL["fp32"])
                if not rel <= tol:
                    raise RuntimeError(f"{name} {shape}: error {rel:.3g} of "
                                       f"max |plain| > {tol}")
                ms, plain_ms = device_ms(kern, iters=20), device_ms(plain)
                lib_ms = None if lib is None else device_ms(lib)
                host_ms = time_ms(kern, iters=20)
                bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
                rows.append({"kernel": name, "shape": shape, "batch": batch,
                             "net": net, "calls": calls, "ms": ms,
                             "plain_ms": plain_ms, "library_ms": lib_ms,
                             "bound_ms": bound_ms, "host_paced_ms": host_ms,
                             "rel_err": rel})
                tot = per_forward.setdefault(f"{name} {net} B={batch}",
                                             [0.0] * 4)
                tot[0] += ms * calls
                tot[1] += bound_ms * calls
                tot[2] += plain_ms * calls
                tot[3] += host_ms * calls
                if args.trace:
                    rows[-1]["kernels_ms"] = kernel_split(kern)
                lib_s = "-" if lib_ms is None else f"{lib_ms:.4f} ms"
                print(f"  [{args.tag}] {name:18s} {net:17s} {shape:16s} "
                      f"kernel {ms:.4f} ms  bound {bound_ms:.4f} ms "
                      f"({bound_ms / ms:.0%})  plain {plain_ms:.4f} ms  "
                      f"library {lib_s}  host-paced {host_ms:.4f} ms  "
                      f"rel err {rel:.3g}", flush=True)
                if args.trace:
                    print(f"  [{args.tag}]   by kernel: " + ", ".join(
                        f"{k} {v:.4f} ms"
                        for k, v in rows[-1]["kernels_ms"].items()),
                        flush=True)
    for key, (ms, bound_ms, plain_ms, host_ms) in per_forward.items():
        if ms:
            print(f"  [{args.tag}] {key} per forward: kernel {ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"host-paced {host_ms:.4f} ms", flush=True)
    print(f"  [{args.tag}] card: {card}; root {args.root}; set {args.set}",
          flush=True)
    out = HERE / "chiprun_out" / f"bench_cells_{args.tag}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": card, "root": args.root,
                               "set": args.set, "rows": rows,
                               "per_forward": per_forward}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
