#!/usr/bin/env python3
"""Card check of the PyTorch/H100 port (``dynmm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

1. Device and build: prints the card's name and power limit, builds every
   CUDA source of the port with ``nvcc`` (sm_90a) and prints the seconds.
2. Kernels: calls each kernel's wrapper at the shapes the flagship's forward
   gives it at B=8, 480×640 (the NBt1D kernels at B=1 too), and holds the
   result against its plain PyTorch version on the same seeded inputs: max
   abs error and max abs error over max |plain| (≤ 1e-4 in fp32: the
   summation orders differ). Times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call on the device:
   10 calls captured in a CUDA graph, its replays timed with CUDA events, so
   the host's cost of issuing a short call is left out (``device_ms``); the
   one-launch block also beside two ``nbt1d_pair`` calls
   on the same inputs, at all four block levels (those it does not serve
   count 0 calls a forward). Both NBt1D kernels (3xTF32 on the tensor
   cores) get two bounds, fp32 on CUDA cores and three TF32 products per
   fp32 product on the tensor cores, and their fp32-equivalent TFLOP/s.
   ``learned_upsample`` and ``se_fuse_mixed`` run at B=1 too, and at every
   shape make 20 back-to-back calls whose outputs must be bit-identical
   (the SE squeeze's last-block tickets and fences race only on the card).
   The time of each kernel per dense forward is printed for B=8 and B=1.
3. Serve, dense: builds the 480×640 flagship with seeded random weights,
   serves 3 batches of 8 and 3 of 1 through ``dynmm_tpu_torch.serve.serve``
   (``mode="dense"``) with every launch count at 0 before, checks the
   counts of each forward, then runs the same requests with
   ``use_kernels=False`` (plain versions, same weights): identical gate
   choices, logits within 1e-3 relative, class maps identical on ≥ 99.9 %
   of pixels.
4. Serve, routed: the same model with a gate override that hands out fixed
   per-sample paths serves B=8 through ``batchmax`` and ``compact`` (the
   default ladder, ``capacity_schedule``'s per-stage ladders, a strict
   schedule that covers the batch), B=1 through ``switch`` for every path
   and with the live gate, and B=8 at ``low_res``. Counts at 0 before; each
   forward's launches must equal the counts its paths give (a skipped depth
   stage launches nothing), and each request must agree with the dense
   forward on the same paths as in phase 3.
5. Recipe gate: reads ``bench_assets/gate_recipe.msgpack`` with the port's
   own msgpack reader (it prints whether ``msgpack`` and ``flax`` could be
   imported; it needs neither), merges it into a seeded 480×640 flagship and
   serves ``make_recipe_eval_batch(8, 480, 640)`` (half depth-needed
   samples) through ``dense``, ``batchmax`` and ``compact`` and its samples
   one at a time through ``switch``. Prints the path mix beside the
   asset's branch ratios and each mode's request time; as in phases 3-4,
   each routed request must agree with the dense forward on the same input
   (its max abs error printed), every request launch the counts its paths
   give, and the kernels agree with the plain versions.
6. Train: ``SegTrainer.fit`` on the 480×640 flagship (seeded weights,
   SGD, lr 0.01, loss ratio 1e-4, temperature 1.0 → 0.001 over 60 epochs,
   so the gate stays soft) for 2 epochs of 2 steps of batch 8 on
   ``SyntheticSegDataset(mixed_modality_frac=0.5)``, validating each epoch.
   Requires finite losses, no kernel launch during a train step and the
   ``EXPECTED`` launches for each validation forward; then, on the trained
   weights, the kernel eval path against the plain one (gate choices
   identical, logits within 1e-3 relative), the rolling checkpoint loaded
   into a fresh model giving equal eval logits (error 0), and one step
   resumed from that checkpoint against one more step of the trained state
   (every parameter and BN statistic within 1e-5 relative). Prints the ms
   per train step (median after the first) and the peak memory.
7. Modality-level DynMM (no kernel of the port runs here; the six launch
   counters must not move). Serves the MM-IMDB router at B=4096 (text 300,
   image 4096) and the CMU-MOSEI router at B=1024, T=50, lengths full (the
   JAX bench's serving batches; seeded weights): dense soft, dense hard,
   ``infer_mode=2`` (the static late-fusion baseline), the compacted routed
   forward with ``force_k`` at 0/25/50 % on the expensive branch and with
   the live gate, and ``forward_switch`` at B=1 for each branch (a gate
   bias forces it). Each request is timed on the host clock ending in
   ``torch.cuda.synchronize()`` (median of 5 after a warm-up), and one more
   is traced with ``torch.profiler`` for its device time and the device's
   busy share of its window; every
   compact and switch request must equal dense eval of the same branches
   (max abs error over max |dense| ≤ 1e-5, the same branch per sample), and
   the card's dense forward the CPU's on the same weights (≤ 1e-4
   relative; MOSEI on its first 128 rows). Then runs each CLI's
   ``main(argv)`` (``imdb_dyn``, ``affect_dyn``: ``--synthetic --freeze
   --no-pretrain --n-epochs 3 --device cuda``) from a temporary working
   directory: finite losses, the result line, the frozen parameters
   bit-identical to the CLI's seeded start and the gate's changed (the
   IMDB fusion branch's BN statistics follow its train-mode forwards, as in
   the JAX trainer), and the checkpoint in a fresh router giving the CLI
   model's hard-eval outputs exactly (error 0). Prints ms per request and
   per train step (median after the first).
8. The eval and predict CLIs on prepared data: writes a NYUv2-layout test
   split of 16 samples at 480×640 (``SyntheticSegDataset``, half
   depth-needed) with the port's PNG codec, and the flagship with seeded
   weights and the recipe gate merged as ``.msgpack`` and ``.pth``. Runs
   ``cli.eval.main`` at B=8 (hard from each checkpoint: equal mIoU; two
   noise runs; quarter resolution; capacity factor 8.0, which must score
   the exact chain's mIoU; the packed stem) and ``cli.predict.main`` in
   every serve mode (batchmax, dense, compact, compact with capacity
   factor 1.25, switch and switch_host at B=1 on 4 samples, quarter
   resolution, packed stem). Counts at 0 before each run: the launches
   must be those the samples' paths give (the strict capacity runs add
   their ``gate_only`` calibration). Predict's PNGs, read back, must equal
   ``serve()``'s class maps of the same batches through the palette
   (error 0); the kernels' class maps of one batch must agree with the
   plain versions' on ≥ 99.9 % of pixels, raw and packed, and the packed
   stem's logits lie within 1e-4 relative of the raw stem's. Prints each
   eval run's seconds a batch, predict's frames/s, the path mix and the
   host's share of a batch (PNG decode, preprocessing, packing) beside the
   forward. Deletes its files.
9. Prints the kernels' JSON line (launches summed over phases 3-6 and 8),
   the card line, and last ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN convolutions and matmuls here, so the kernels
and their plain versions compare in fp32. Any failure exits non-zero before
the last line; without a card, or outside a checkout, it fails at once.
Details go to ``chiprun_out/chip_smoke.json`` beside this script.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

ROOT = Path(__file__).resolve().parent
BATCH = 8
HEIGHT, WIDTH, CLASSES = 480, 640, 40
# H100 SXM data-sheet peaks: HBM3 bytes/s, fp32 (non-tensor) FLOP/s and
# dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# fp32 FLOP/s of fp32-accurate work on the tensor cores in 3xTF32: three
# TF32 products per fp32 product
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
KERNEL_TOL = 1e-4
REPEATS = 20  # back-to-back calls that must give bit-identical outputs
# launches of one dense hard-gate forward of the flagship: its stride-1
# NBt1D blocks up to NBT1D_FUSED_MAX_C channels (6 at C = 64) take one
# launch each, the wider ones (29) two; channel_sums runs in the stem cell
EXPECTED = {"nbt1d_fused": 6, "nbt1d_pair": 58, "channel_sums": 1,
            "stem_fuse_pool": 1, "se_fuse_mixed": 4, "learned_upsample": 5}
# the flagship's stride-1 NBt1D blocks by channel count: in each encoder
# stage (stage i at 64·2^(i-1) channels) and in the decoder
ENCODER_BLOCKS = ((64, 3), (128, 3), (256, 5), (512, 2))
DECODER_BLOCKS = ((512, 3), (256, 3), (128, 3))
SOURCES = {
    "nbt1d_fused": ("nbt1d_block.cu", "dynmm_tpu/kernels/nbt1d.py:154"),
    "nbt1d_pair": ("nbt1d.cu", "dynmm_tpu/kernels/nbt1d.py:246"),
    "channel_sums": ("se.cu", "dynmm_tpu/kernels/stem_fuse.py:85"),
    "stem_fuse_pool": ("stem_fuse.cu", "dynmm_tpu/kernels/stem_fuse.py:198"),
    "learned_upsample": ("upsample.cu", "dynmm_tpu/kernels/upsample.py:130"),
    "se_fuse_mixed": ("se.cu", "dynmm_tpu/kernels/se.py:66"),
}


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Case(NamedTuple):
    """One kernel at one shape of the main path: ``calls`` per forward at
    ``batch``; ``peak`` is the FLOP/s its bound counts operations at;
    ``alt`` another way to compute the same output, timed beside it;
    ``repeat``: check that REPEATS calls give bit-identical outputs."""
    name: str
    label: str
    calls: int
    kern: Callable
    plain: Callable
    lib: Callable | None
    n_bytes: float
    n_flops: float
    alt: Callable | None = None
    batch: int = BATCH
    peak: float = PEAK_FP32_FLOPS
    repeat: bool = False


class Inputs:
    """Seeded inputs on the card."""

    def __init__(self, seed: int):
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(self, *shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=self.g, device="cuda") * scale + shift

    def rand(self, *shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=self.g,
                                           device="cuda")


def upsample_library_weight(taps: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 + zero-padded depthwise 3×3 as one depthwise transposed
    conv (stride 2, padding 1): the 3×3 taps phase-merged into a 4×4 kernel
    (the JAX package's ``_UPSAMPLE_PHASE_MERGE``), flipped."""
    a = torch.tensor([[1.0, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]],
                     device=taps.device)
    kt = torch.einsum("us,stc,vt->cuv", a, taps, a)  # (C, 4, 4)
    return kt.flip(1, 2).unsqueeze(1).contiguous()


def kernel_cases(inp: Inputs) -> list[Case]:
    """Every shape of the main path."""
    from dynmm_tpu_torch.kernels import nbt1d, se, stem_fuse, upsample

    b = BATCH
    cases = []
    # K1: 13 stride-1 blocks per encoder, 9 in the decoder: one launch each
    # up to NBT1D_FUSED_MAX_C channels, two pairs each above
    per_level = {c: 2 * n for c, n in ENCODER_BLOCKS}
    for c, n in DECODER_BLOCKS:
        per_level[c] += n
    for c, h, w in ((64, 120, 160), (128, 60, 80), (256, 30, 40),
                    (512, 15, 20)):
        blocks = per_level[c]
        std = math.sqrt(2.0 / (3 * c))
        params = []
        for _ in range(2):
            params += [inp.randn(3, c, c, scale=std), inp.randn(c, scale=0.05),
                       inp.randn(3, c, c, scale=std), inp.randn(c, scale=0.05),
                       inp.rand(c, lo=0.5, hi=1.0), inp.randn(c, scale=0.1)]
        fused = c <= nbt1d.NBT1D_FUSED_MAX_C
        x, idn = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
        for bb in (b, 1):
            xb, idb = x[:bb].contiguous(), idn[:bb].contiguous()
            vol = bb * h * w * c * 4
            for form, extra in (("pair1", {}), ("pair2", {"identity": idb})):
                args = (xb, *params[:6])
                n_bytes = (vol * (3 if extra else 2) + 2 * 3 * c * c * 4
                           + 4 * c * 4)
                cases.append(Case(
                    "nbt1d_pair", f"{form} {bb}x{h}x{w}x{c}",
                    0 if fused else blocks,
                    lambda a=args, e=extra: nbt1d.nbt1d_pair(*a, **e),
                    lambda a=args, e=extra: nbt1d.nbt1d_pair_plain(*a, **e),
                    None, n_bytes, 12.0 * c * c * bb * h * w, batch=bb,
                    peak=PEAK_TF32X3_FLOPS))
            # the one-launch block at every level, served or not
            args = (xb, *params)
            cases.append(Case(
                "nbt1d_fused", f"{bb}x{h}x{w}x{c}", blocks if fused else 0,
                lambda a=args: nbt1d.nbt1d_fused(*a),
                lambda a=args: nbt1d.nbt1d_fused_plain(*a),
                None, 2 * bb * h * w * c * 4 + 4 * 3 * c * c * 4 + 8 * c * 4,
                24.0 * c * c * bb * h * w,
                lambda a=args: nbt1d.nbt1d_pair(
                    nbt1d.nbt1d_pair(*a[:7]), *a[7:], identity=a[0]),
                batch=bb, peak=PEAK_TF32X3_FLOPS))
    # channel sums: the stem cell
    c, h, w = 64, 240, 320
    r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
    n = b * h * w * c
    cases.append(Case("channel_sums", f"{b}x{h}x{w}x{c}", 1,
                  lambda r=r, d=d: se.channel_sums(r, d),
                  lambda r=r, d=d: se.channel_sums_plain(r, d),
                  lambda r=r, d=d: (torch.sum(r, dim=(1, 2)),
                                    torch.sum(d, dim=(1, 2))),
                  2 * n * 4 + 2 * b * c * 4, 2.0 * n, None))
    # K2: stem scale-add + dual max-pool
    r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
    s_r, s_d = inp.rand(b, c), inp.rand(b, c)
    n = b * h * w * c
    args = (r, d, s_r, s_d)
    cases.append(Case("stem_fuse_pool", f"{b}x{h}x{w}x{c}", 1,
                  lambda a=args: stem_fuse.stem_fuse_pool(*a),
                  lambda a=args: stem_fuse.stem_fuse_pool_plain(*a),
                  None, (2 * n + 2 * n // 4) * 4, 3.0 * n + 18.0 * n / 4, None))
    # K3: three decoder-module upsamples and the two logits upsamples
    for c, h, w in ((512, 15, 20), (256, 30, 40), (128, 60, 80),
                    (40, 120, 160), (40, 240, 320)):
        x = inp.randn(b, h, w, c)
        taps, bias = inp.randn(3, 3, c, scale=0.3), inp.randn(c, scale=0.1)
        wt = upsample_library_weight(taps)
        for bb in (b, 1):
            xb = x[:bb].contiguous()
            n = bb * h * w * c
            cases.append(Case(
                "learned_upsample", f"{bb}x{h}x{w}x{c}", 1,
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample(x, k, bb),
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample_plain(
                    x, k, bb),
                lambda x=xb, wt=wt, bb=bias, c=c: (
                    torch.nn.functional.conv_transpose2d(
                        x.permute(0, 3, 1, 2), wt, bb, stride=2, padding=1,
                        groups=c).permute(0, 2, 3, 1)),
                (n + 4 * n) * 4 + 10 * c * 4, 8.0 * 4 * n, None, batch=bb,
                repeat=True))
    # K4: the four gate-mixed SE fusion cells (squeeze + mix)
    for c, h, w in ((64, 120, 160), (128, 60, 80), (256, 30, 40),
                    (512, 15, 20)):
        r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
        cr = c // 16
        wts = []
        for _ in range(2):
            wts += [inp.randn(c, cr, scale=1 / math.sqrt(c)),
                    inp.randn(cr, scale=0.1),
                    inp.randn(cr, c, scale=1 / math.sqrt(cr)),
                    inp.randn(c, scale=0.1)]
        w_rgb = inp.rand(b)
        for bb in (b, 1):
            rb, db, wb = r[:bb].contiguous(), d[:bb].contiguous(), w_rgb[:bb]
            n = bb * h * w * c
            cases.append(Case(
                "se_fuse_mixed", f"{bb}x{h}x{w}x{c}", 1,
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed(r, d, wr, *ws),
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed_plain(
                    r, d, wr, *ws),
                None, 3 * n * 4, 5.0 * n, None, batch=bb, repeat=True))
    return cases


def second_opinion(case: Case, outs_k: tuple, outs_p: tuple) -> None:
    """After a kernel/plain mismatch, and before the check fails: the kernel
    and the plain version once more on the same inputs, the plain version
    with and without cuDNN, each held against the first outputs, so that the
    failure says which side changed its answer."""
    def as_tuple(o):
        return o if isinstance(o, tuple) else (o,)

    with torch.inference_mode():
        runs = {"kernel": outs_k, "plain": outs_p,
                "kernel again": as_tuple(case.kern()),
                "plain again": as_tuple(case.plain())}
        with torch.backends.cudnn.flags(enabled=False):
            runs["plain without cuDNN"] = as_tuple(case.plain())
        torch.cuda.synchronize()
    for label, outs in runs.items():
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        print(f"  second opinion, {case.name} {case.label}: {label}: max |out| "
              f"{max(o.abs().max().item() for o in outs):.6g}, finite "
              f"{finite}", file=sys.stderr, flush=True)
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            err = max((x - y).abs().max().item()
                      for x, y in zip(runs[a], runs[b]))
            print(f"  second opinion: max |{a} - {b}| = {err:.6g}",
                  file=sys.stderr, flush=True)


def check_kernels(report: dict) -> list[dict]:
    from dynmm_tpu_torch.utils.device import device_ms

    per_kernel: dict[str, dict] = {}
    # per kernel and batch: ms, bound ms, fp32 CUDA-core bound ms, plain ms
    # a forward
    per_forward: dict[tuple[str, int], list[float]] = {}
    inp = Inputs(seed=0)
    for case in kernel_cases(inp):
        name, label, calls = case.name, case.label, case.calls
        with torch.inference_mode():
            out_k, out_p = case.kern(), case.plain()
            torch.cuda.synchronize()
            outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
            outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
            err = max((a - p).abs().max().item() for a, p in zip(outs_k, outs_p))
            scale = max(p.abs().max().item() for p in outs_p)
            rel = err / scale
            if not all(torch.isfinite(a).all() for a in outs_k):
                raise RuntimeError(f"{name} {label}: non-finite output")
            if rel > KERNEL_TOL:
                second_opinion(case, outs_k, outs_p)
                raise RuntimeError(f"{name} {label}: max abs err {err:.3g} is "
                                   f"{rel:.3g} of max |plain| > {KERNEL_TOL}")
            if case.repeat:
                for _ in range(REPEATS):
                    again = case.kern()
                    again = again if isinstance(again, tuple) else (again,)
                    if not all(torch.equal(a, o) for a, o in zip(again, outs_k)):
                        raise RuntimeError(f"{name} {label}: {REPEATS} calls "
                                           "on the same inputs differ")
            lib_ms = None
            if case.lib is not None:
                out_l = case.lib()
                outs_l = out_l if isinstance(out_l, tuple) else (out_l,)
                lib_err = max((a - p).abs().max().item()
                              for a, p in zip(outs_l, outs_p)) / scale
                if lib_err > KERNEL_TOL:
                    raise RuntimeError(f"{name} {label}: library call differs "
                                       f"({lib_err:.3g})")
                lib_ms = device_ms(case.lib)
            ms, plain_ms = device_ms(case.kern), device_ms(case.plain)
            alt_ms = None if case.alt is None else device_ms(case.alt)
        b_ms, b_by = bound(case.n_bytes, case.n_flops, case.peak)
        fp32_ms, _ = bound(case.n_bytes, case.n_flops)
        tflops = case.n_flops / ms / 1e9
        row = {"kernel": name, "shape": label, "batch": case.batch,
               "calls_per_forward": calls, "max_abs_err": err,
               "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "fp32_bound_ms": fp32_ms, "tflops": tflops,
               "repeats_identical": REPEATS if case.repeat else None}
        if case.alt is not None:
            row["two_pair_ms"] = alt_ms
        report["kernel_cases"].append(row)
        bounds = (f"bound {b_ms:.4f} ms ({b_by})" if case.peak == PEAK_FP32_FLOPS
                  else f"bound 3xTF32 {b_ms:.4f} ms ({b_by}), fp32 "
                       f"{fp32_ms:.4f} ms")
        print(f"  {name:16s} {label:22s} x{calls:<2d} err {err:.3g} "
              f"(rel {rel:.3g})  kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s)  "
              f"plain {plain_ms:.4f} ms  "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              + bounds
              + ("" if case.alt is None else f"  two nbt1d_pair {alt_ms:.4f} ms"),
              flush=True)
        tot = per_forward.setdefault((name, case.batch), [0.0] * 4)
        tot[0] += ms * calls
        tot[1] += b_ms * calls
        tot[2] += fp32_ms * calls
        tot[3] += plain_ms * calls
        agg = per_kernel.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"dynmm_tpu_torch/kernels/csrc/{SOURCES[name][0]}",
            "replaces": SOURCES[name][1], "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": b_by,
            "library_ms": 0.0 if lib_ms is not None else None})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        if case.batch != BATCH:
            continue
        # per-forward totals at B=8: each shape's time times its calls
        agg["ms"] += ms * calls
        agg["plain_ms"] += plain_ms * calls
        agg["bound_ms"] += b_ms * calls
        if lib_ms is not None:
            agg["library_ms"] += lib_ms * calls
    report["per_forward"] = []
    for (name, b), (ms, b_ms, fp32_ms, plain_ms) in per_forward.items():
        report["per_forward"].append({
            "kernel": name, "batch": b, "ms": ms, "bound_ms": b_ms,
            "fp32_bound_ms": fp32_ms, "plain_ms": plain_ms})
        print(f"  {name} per dense B={b} forward: {ms:.4f} ms; bound "
              f"{b_ms:.4f} ms" + (f", on fp32 CUDA cores {fp32_ms:.4f} ms"
                                  if fp32_ms != b_ms else "")
              + f"; plain {plain_ms:.4f} ms", flush=True)
    return list(per_kernel.values())


def check_serve(report: dict):
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, serve

    t0 = time.perf_counter()
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  flagship built in {time.perf_counter() - t0:.2f} s "
          f"({n_params} parameters)", flush=True)
    inp = Inputs(seed=1)
    requests = [(inp.randn(b, HEIGHT, WIDTH, 3), inp.randn(b, HEIGHT, WIDTH, 1))
                for b in (BATCH,) * 3 + (1,) * 3]
    # warm-up of both paths (cuDNN picks its algorithms), not counted
    for i, use_kernels in ((0, True), (3, True), (0, False), (3, False)):
        serve(model, *requests[i], mode="dense", use_kernels=use_kernels)
    torch.cuda.synchronize()

    if path_launches([True] * 4, low_res=False) != EXPECTED:
        raise RuntimeError("EXPECTED disagrees with the block tables and "
                           "NBT1D_FUSED_MAX_C")
    # the main path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for rgb, depth in requests:
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = serve(model, rgb, depth, mode="dense")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
        if delta != EXPECTED:
            raise RuntimeError(f"launches of one forward {delta} != {EXPECTED}")
        served.append((class_map, weight, ms))
        print(f"  request B={rgb.shape[0]}: {ms:.2f} ms, paths "
              f"{weight.argmax(1).tolist()}", flush=True)
    launches = dict(LAUNCHES)
    for name, n in EXPECTED.items():
        if launches.get(name, 0) != n * len(requests):
            raise RuntimeError(f"{name}: {launches.get(name, 0)} launches in "
                               f"the served run, expected {n * len(requests)}")

    # the same requests through the plain versions, same weights
    for (rgb, depth), (class_map, weight, ms) in zip(requests, served):
        with torch.inference_mode():
            logits_k = model(rgb, depth, hard=True, use_kernels=True)
            logits_p, weight_p = model(rgb, depth, hard=True,
                                       return_weight=True, use_kernels=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(model, rgb, depth, mode="dense", use_kernels=False)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        b = rgb.shape[0]
        if logits_k.shape != (b, HEIGHT, WIDTH, CLASSES) or not bool(
                torch.isfinite(logits_k).all()):
            raise RuntimeError("served logits are not finite or mis-shaped")
        if class_map.shape != (b, HEIGHT, WIDTH) or class_map.dtype != torch.int32:
            raise RuntimeError("class map is mis-shaped")
        rel = ((logits_k - logits_p).abs().max()
               / logits_p.abs().max()).item()
        agree = (class_map == first_argmax(logits_p)).float().mean().item()
        same_gate = bool(torch.equal(weight, weight_p))
        row = {"batch": b, "ms": ms, "plain_ms": plain_ms,
               "paths": weight.argmax(1).tolist(), "logits_rel_err": rel,
               "class_map_agreement": agree, "same_gate": same_gate}
        report["serve"].append(row)
        print(f"  B={b}: kernels {ms:.2f} ms vs plain {plain_ms:.2f} ms; "
              f"logits rel err {rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if not same_gate or rel > 1e-3 or agree < 0.999:
            raise RuntimeError("kernel path disagrees with the plain path")
    return model, launches


class PathGate:
    """Gate override of one model (the JAX tests' ``FixedGateNet``): hands
    out the fixed per-sample ``paths`` as one-hot weights, or runs the live
    gate while ``paths`` is None."""

    def __init__(self, model):
        self.live = model.gate_weights
        self.paths = None
        model.gate_weights = self

    def __call__(self, rgb, depth, temp=1.0, hard=False, baseline=False):
        if self.paths is None:
            return self.live(rgb, depth, temp=temp, hard=hard,
                             baseline=baseline)
        idx = torch.tensor(self.paths[:rgb.shape[0]], device=rgb.device)
        return torch.nn.functional.one_hot(idx, 5).to(rgb.dtype)


def path_launches(ran: list[bool], low_res: bool) -> dict:
    """Launches of one flagship forward whose depth stages 1-4 ran as
    ``ran`` says. Always: the rgb encoder's and the decoder's stride-1
    blocks (one ``nbt1d_fused`` each up to ``NBT1D_FUSED_MAX_C`` channels,
    two ``nbt1d_pair`` above), the stem cell (``stem_fuse_pool`` and its
    ``channel_sums``), 5 upsamples (3 at ``low_res``). A depth stage that
    ran adds its blocks and one fusion cell (``se_fuse_mixed``)."""
    from dynmm_tpu_torch.kernels.nbt1d import NBT1D_FUSED_MAX_C

    counts = {"nbt1d_fused": 0, "nbt1d_pair": 0, "channel_sums": 1,
              "stem_fuse_pool": 1, "se_fuse_mixed": 0,
              "learned_upsample": 3 if low_res else 5}

    def blocks(c, n):
        if c <= NBT1D_FUSED_MAX_C:
            counts["nbt1d_fused"] += n
        else:
            counts["nbt1d_pair"] += 2 * n

    for (c, n), r in zip(ENCODER_BLOCKS, ran):
        blocks(c, n * (1 + int(r)))
        counts["se_fuse_mixed"] += int(r)
    for c, n in DECODER_BLOCKS:
        blocks(c, n)
    return {k: v for k, v in counts.items() if v}


def stages_run(mode: str, paths: list[int], kw: dict) -> list[bool]:
    """Which depth stages a routed forward runs: stages 1..K (K the largest
    path, or ``force_path``) for batchmax and switch; for compact, the
    stages whose ladder rung for the n_i participants is above 0."""
    if mode != "compact":
        k = kw.get("force_path", max(paths))
        return [k >= i for i in range(1, 5)]
    from dynmm_tpu_torch.models.skip_gate import _stage_ladders

    ladders = _stage_ladders(kw.get("caps"), len(paths),
                             kw.get("strict_caps", False))
    ran = []
    for i, ladder in enumerate(ladders, start=1):
        n = sum(p >= i for p in paths)
        ran.append(next((c for c in ladder if n <= c), ladder[-1]) > 0)
    return ran


def check_routed(model, report: dict) -> dict:
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import capacity_schedule, serve

    gate = PathGate(model)
    inp = Inputs(seed=2)
    big = (inp.randn(BATCH, HEIGHT, WIDTH, 3), inp.randn(BATCH, HEIGHT, WIDTH, 1))
    one = (big[0][:1].contiguous(), big[1][:1].contiguous())
    mixed = [0, 4, 2, 1, 3, 0, 1, 2]
    gate.paths = mixed
    per_stage = capacity_schedule(model, [big], BATCH)
    strict = capacity_schedule(model, [big], BATCH, capacity_factor=1.25)
    print(f"  capacity_schedule over paths {mixed}: per-stage {per_stage}, "
          f"strict x1.25 {strict}", flush=True)
    # (label, mode, paths (None: the live gate), images, serve kwargs)
    requests = [
        ("batchmax", "batchmax", mixed, big, {}),
        ("batchmax K=2", "batchmax", [2, 0, 1, 2, 0, 0, 1, 2], big, {}),
        ("compact", "compact", mixed, big, {}),
        ("compact per-stage", "compact", mixed, big, {"caps": per_stage}),
        ("compact strict", "compact", mixed, big,
         {"caps": strict, "strict_caps": True}),
        ("compact cheap", "compact", [0, 1, 0, 1, 0, 0, 1, 0], big, {}),
        *((f"switch k={k}", "switch", [k], one, {"force_path": k})
          for k in range(5)),
        ("switch live gate", "switch", None, one, {}),
        ("compact low_res", "compact", mixed, big, {"low_res": True}),
    ]

    def run(req, mode=None, use_kernels=True):
        label, m, paths, images, kw = req
        gate.paths = paths
        if mode == "dense":
            kw = {"low_res": kw.get("low_res", False)}
        return serve(model, *images, mode=mode or m, use_kernels=use_kernels,
                     **kw)

    # warm-up (cuDNN picks algorithms per batch size and capacity), not counted
    for req in requests:
        run(req)
        run(req, "dense")
    torch.cuda.synchronize()

    # the routed path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for req in requests:
        label, mode, paths, images, kw = req
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = run(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
        delta = {k: v for k, v in delta.items() if v}
        chosen = weight.argmax(1).tolist()
        ran = stages_run(mode, chosen if paths is None else paths, kw)
        expected = path_launches(ran, kw.get("low_res", False))
        if delta != expected:
            raise RuntimeError(f"{label}: launches {delta} != {expected} "
                               f"(depth stages run {ran})")
        served.append((class_map, weight, ms, ran))
    launches = dict(LAUNCHES)

    # each request against the dense forward on the same paths
    methods = {"batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    for req, (class_map, weight, ms, ran) in zip(requests, served):
        label, mode, paths, (rgb, depth), kw = req
        low_res = kw.get("low_res", False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_map, dense_w = run(req, "dense")
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            logits = getattr(model, methods[mode])(
                rgb, depth, **kw)
            logits_d = model(rgb, depth, hard=True, low_res=low_res)
        rel = ((logits - logits_d).abs().max() / logits_d.abs().max()).item()
        agree = (class_map == dense_map).float().mean().item()
        agree_logits = (first_argmax(logits_d) == first_argmax(logits)
                        ).float().mean().item()
        same_gate = bool(torch.equal(weight, dense_w))
        finite = bool(torch.isfinite(logits).all())
        b = rgb.shape[0]
        shape_ok = (class_map.shape == (b, HEIGHT, WIDTH) and logits.shape
                    == (b, HEIGHT // (4 if low_res else 1),
                        WIDTH // (4 if low_res else 1), CLASSES))
        row = {"request": label, "mode": mode, "batch": b,
               "paths": weight.argmax(1).tolist(), "depth_stages_run": ran,
               "serve_kwargs": dict(kw), "ms": ms,
               "dense_ms": dense_ms, "logits_rel_err": rel,
               "class_map_agreement": agree, "same_gate": same_gate,
               "launches": path_launches(ran, low_res)}
        report["routed"].append(row)
        print(f"  {label:18s} B={b} paths {row['paths']} stages run "
              f"{[int(r) for r in ran]}: {ms:.2f} ms vs dense {dense_ms:.2f} "
              f"ms; logits rel err {rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if (not same_gate or not finite or not shape_ok or rel > 1e-3
                or agree < 0.999 or agree_logits < 0.999):
            raise RuntimeError(f"{label}: routed serving disagrees with the "
                               "dense forward")
    return launches


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def check_recipe_gate(report: dict) -> dict:
    import importlib.util

    from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.utils.weights import load_recipe_gate

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("msgpack", "flax")}
    print(f"  importable on this machine: msgpack {found['msgpack']}, flax "
          f"{found['flax']} (the asset is read with the port's own reader)",
          flush=True)
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    ratios, provenance = load_recipe_gate(model)
    if ratios is None:
        raise RuntimeError("bench_assets/gate_recipe.msgpack is missing")
    rgb, depth = (torch.from_numpy(a).cuda()
                  for a in make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(BATCH)]
    requests = [("dense", "dense", (rgb, depth)),
                ("batchmax", "batchmax", (rgb, depth)),
                ("compact", "compact", (rgb, depth)),
                *((f"switch #{i}", "switch", one)
                  for i, one in enumerate(singles))]
    for _, mode, images in requests:  # warm-up, not counted
        serve(model, *images, mode=mode)
        serve(model, *images, mode="dense")
    torch.cuda.synchronize()

    reset_launches()
    served = []
    for label, mode, images in requests:
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = serve(model, *images, mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v - before.get(k, 0)}
        paths = weight.argmax(1).tolist()
        expected = path_launches(
            [True] * 4 if mode == "dense" else stages_run(mode, paths, {}),
            False)
        if delta != expected:
            raise RuntimeError(f"recipe {label}: launches {delta} != {expected}")
        served.append((class_map, weight, ms))
    launches = dict(LAUNCHES)

    methods = {"dense": "forward", "batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    rows = []
    for (label, mode, (r, d)), (class_map, weight, ms) in zip(requests, served):
        with torch.inference_mode():
            kw = {"hard": True} if mode == "dense" else {}
            logits = getattr(model, methods[mode])(r, d, **kw)
            logits_d, weight_d = model(r, d, hard=True, return_weight=True)
            logits_p, weight_p = model(r, d, hard=True, return_weight=True,
                                       use_kernels=False)
        routed_err = (logits - logits_d).abs().max().item()
        routed_rel = _rel(logits, logits_d)
        plain_rel = _rel(logits_d, logits_p)
        agree = (class_map == first_argmax(logits_p)).float().mean().item()
        same_gate = (torch.equal(weight, weight_d)
                     and torch.equal(weight_d, weight_p))
        row = {"request": label, "mode": mode, "batch": r.shape[0],
               "paths": weight.argmax(1).tolist(), "ms": ms,
               "routed_vs_dense_max_abs_err": routed_err,
               "kernels_vs_plain_rel_err": plain_rel,
               "class_map_agreement": agree, "same_gate": same_gate}
        rows.append(row)
        print(f"  {label:11s} B={r.shape[0]} paths {row['paths']}: {ms:.2f} ms;"
              f" routed vs dense max abs err {routed_err:.3g}; kernels vs "
              f"plain rel err {plain_rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if (routed_rel > 1e-3 or not same_gate or plain_rel > 1e-3
                or agree < 0.999 or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"recipe {label}: disagreement")
    paths = served[0][1].argmax(1)
    mix = torch.nn.functional.one_hot(paths, 5).double().mean(0).tolist()
    print(f"  path mix of the batch {mix} (paths {paths.tolist()}); the "
          f"asset's branch ratios {ratios.tolist()}", flush=True)
    report["recipe_gate"] = {"asset_branch_ratios": ratios.tolist(),
                             "provenance": provenance, "path_mix": mix,
                             "importable": found, "requests": rows}
    return launches


def check_train(report: dict) -> dict:
    import shutil
    import statistics

    from dynmm_tpu_torch.cli.seg_build import compute_class_weights
    from dynmm_tpu_torch.core.schedules import ExpDecayTemp
    from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset
    from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.models.esanet import ESANetConfig
    from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
    from dynmm_tpu_torch.nn.layers import pack_weights
    from dynmm_tpu_torch.serve import build_flagship
    from dynmm_tpu_torch.train.seg import (DOWN_RATES, SegTrainConfig,
                                           SegTrainer)
    from dynmm_tpu_torch.utils.checkpoint import load_ckpt
    from dynmm_tpu_torch.utils.weights import load_checkpoint_into

    epochs, steps = 2, 2
    train_ds = SyntheticSegDataset(n=steps * BATCH, height=HEIGHT, width=WIDTH,
                                   split="train", mixed_modality_frac=0.5)
    test_ds = SyntheticSegDataset(n=BATCH, height=HEIGHT, width=WIDTH,
                                  split="test", mixed_modality_frac=0.5)
    pre = lambda phase: SegPreprocessor(train_ds.depth_mean, train_ds.depth_std,
                                        HEIGHT, WIDTH, phase=phase)
    train_loader = SegLoader(train_ds, pre("train"), batch_size=BATCH,
                             shuffle=True, drop_last=True)
    valid_loader = SegLoader(test_ds, pre("test"), batch_size=BATCH)
    class_weights = compute_class_weights(train_ds, CLASSES,
                                          "median_frequency")
    # the recipe's stage B (bench_assets/gate_recipe_logs/stage_b_argsv.txt),
    # its first epochs: epoch_hard 60 keeps the gate soft
    cfg = SegTrainConfig(epochs=epochs, lr=0.01, optimizer="SGD",
                         loss_ratio=1e-4, temp=1.0, end_temp=0.001,
                         epoch_hard=60, eval_every=1, batch_size=BATCH)
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=3)
    trainer = SegTrainer(model, cfg, class_weights)
    state = trainer.init_state()

    steps_run, forwards = [], []
    train_step, model_forward = trainer.train_step, model.forward

    def timed_step(*args, **kw):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps_run.append({"ms": ms, "loss": float(out[0]),
                          "launches": sum(LAUNCHES.values())
                          - sum(before.values())})
        return out

    def counted_forward(*args, **kw):
        before = dict(LAUNCHES)
        out = model_forward(*args, **kw)
        if not model.training:
            forwards.append({k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                             if v - before.get(k, 0)})
        return out

    trainer.train_step = timed_step
    model.forward = counted_forward
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    # the train path's run: counts at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    _, best_miou, _ = trainer.fit(state, train_loader, valid_loader,
                                  str(ckpt_dir),
                                  log_fn=lambda m: print(f"  {m}", flush=True))
    fit_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step, model.forward = train_step, model_forward

    if len(steps_run) != epochs * steps:
        raise RuntimeError(f"{len(steps_run)} train steps, expected "
                           f"{epochs * steps}")
    if not all(math.isfinite(st["loss"]) for st in steps_run):
        raise RuntimeError(f"non-finite train loss: {steps_run}")
    if any(st["launches"] for st in steps_run):
        raise RuntimeError(f"a port kernel launched during a train step: "
                           f"{steps_run}")
    if len(forwards) != epochs or any(f != EXPECTED for f in forwards):
        raise RuntimeError(f"validation forwards launched {forwards}, expected "
                           f"{epochs} x {EXPECTED}")
    step_ms = statistics.median(st["ms"] for st in steps_run[1:])
    print(f"  {len(steps_run)} train steps of B={BATCH}: "
          f"{[round(st['ms'], 2) for st in steps_run]} ms (median after the "
          f"first {step_ms:.2f} ms), losses "
          f"{[round(st['loss'], 4) for st in steps_run]}; fit {fit_s:.2f} s; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; best mIoU {best_miou:.4f}; "
          f"no kernel launch in a train step, {EXPECTED} in each of "
          f"{len(forwards)} validation forwards", flush=True)

    # the trained weights: kernel eval path against the plain one
    batch = next(iter(valid_loader))
    rgb = torch.from_numpy(batch["image"]).cuda()
    depth = torch.from_numpy(batch["depth"]).cuda()
    model.eval()
    pack_weights(model)
    with torch.inference_mode():
        logits_k, w_k = model(rgb, depth, hard=True, return_weight=True)
        logits_p, w_p = model(rgb, depth, hard=True, return_weight=True,
                              use_kernels=False)
    plain_rel = _rel(logits_k, logits_p)
    same_gate = bool(torch.equal(w_k, w_p))
    print(f"  trained weights, kernels vs plain: logits rel err "
          f"{plain_rel:.3g}, gate choices identical: {same_gate} (paths "
          f"{w_k.argmax(1).tolist()})", flush=True)
    if plain_rel > 1e-3 or not same_gate:
        raise RuntimeError("trained weights: kernel path disagrees with plain")

    # the rolling checkpoint into a fresh model
    latest = str(ckpt_dir / "ckpt_latest.msgpack")
    fresh = SkipGateESANet(ESANetConfig(height=HEIGHT, width=WIDTH,
                                        num_classes=CLASSES)).cuda()
    fresh = fresh.to(memory_format=torch.channels_last).eval()
    load_checkpoint_into(fresh, latest)
    with torch.inference_mode():
        logits_f = fresh(rgb, depth, hard=True)
    ckpt_err = (logits_f - logits_k).abs().max().item()
    print(f"  checkpoint loaded into a fresh model: eval logits max abs err "
          f"{ckpt_err:.3g}", flush=True)
    if ckpt_err != 0:
        raise RuntimeError("checkpoint reload changes the eval logits")
    del fresh

    # one step resumed from the rolling checkpoint against one more step of
    # the trained state, on the same batch
    tb = next(iter(train_loader))
    args = (torch.from_numpy(tb["image"]).cuda(),
            torch.from_numpy(tb["depth"]).cuda(),
            [torch.from_numpy(tb["label"]).cuda()]
            + [torch.from_numpy(tb["label_down"][r]).cuda() for r in DOWN_RATES],
            ExpDecayTemp(cfg.temp, cfg.end_temp, cfg.epoch_hard)(epochs),
            False, False)
    trainer.train_step(state, *args, torch.Generator())
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del state, trainer, model
    model2 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=4)
    trainer2 = SegTrainer(model2, cfg, class_weights)
    state2, epoch, _, _ = load_ckpt(latest, trainer2.init_state())
    trainer2.train_step(state2, *args, torch.Generator())
    resume_rel = max(
        ((v - after[k]).abs().max() / after[k].abs().max().clamp_min(1e-30)
         ).item() for k, v in model2.state_dict().items())
    print(f"  one step resumed from the epoch-{epoch} checkpoint vs one more "
          f"step of the trained state: max rel err over every parameter and "
          f"BN statistic {resume_rel:.3g}", flush=True)
    if resume_rel > 1e-5:
        raise RuntimeError("resumed training diverges from the trained state")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    report["train"] = {"steps": steps_run, "step_ms_median": step_ms,
                       "peak_memory_bytes": peak, "fit_s": fit_s,
                       "best_miou": best_miou,
                       "validation_launches": forwards,
                       "trained_kernels_vs_plain_rel_err": plain_rel,
                       "checkpoint_reload_max_abs_err": ckpt_err,
                       "resume_max_rel_err": resume_rel}
    return launches


MODALITY_TOL = 1e-5  # routed vs dense requests, max abs err / max |dense|
CPU_TOL = 1e-4  # the card's dense forward vs the CPU's, same weights
MODALITY_REPS = 5  # timed repeats of each request, after one warm-up
IMDB_B, MOSEI_B, MOSEI_T = 4096, 1024, 50  # the JAX bench's serving batches


def _timed(fn, reps: int = MODALITY_REPS):
    """(median ms, every ms, last output, device) of ``fn`` on the host
    clock ending in ``torch.cuda.synchronize()``, after one warm-up call;
    ``device``: the device time of one more call and its busy share of that
    call's window, from a ``torch.profiler`` trace."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynmm_tpu_torch.profile_serve import _busy_us

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    device = {"device_ms": sum(b - a for a, b in spans) / 1e3,
              "busy_share": _busy_us(spans) / wall_us, "kernels": len(spans)}
    return statistics.median(times), times, out, device


def _forced_gate(fc: torch.nn.Linear, branch: int) -> dict:
    """Zero the gate's last layer and bias it to ``branch``; returns the
    saved weights for ``fc.load_state_dict``."""
    saved = {k: v.clone() for k, v in fc.state_dict().items()}
    with torch.no_grad():
        fc.weight.zero_()
        fc.bias.fill_(0.0)
        fc.bias[branch] = 20.0
    return saved


def serve_router(name: str, model, args: tuple, gate_fc) -> dict:
    """Phase 7's requests on one router (see the module docstring)."""
    import copy

    bsz = args[0][0].shape[0]
    rows = []

    def check(label, timed, out, ref, same_gate, extra=None):
        ms, times, _, device = timed
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ok = (rel <= MODALITY_TOL and same_gate
              and bool(torch.isfinite(out).all()))
        rows.append({"request": label, "ms": ms, "ms_all": times, **device,
                     "max_abs_err": err, "rel_err": rel,
                     "same_gate": same_gate, **(extra or {})})
        print(f"  {name} {label:22s} {ms:9.3f} ms (median of "
              f"{len(times)}; device {device['device_ms']:.3f} ms in "
              f"{device['kernels']} kernels, busy "
              f"{device['busy_share'] * 100:.1f} %); vs dense rel err "
              f"{rel:.3g}, gate identical: {same_gate}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: disagrees with dense eval")

    with torch.inference_mode():
        d1 = model(*args, infer_mode=1)[0]
        d2 = model(*args, infer_mode=2)[0]
        hard_out, _, w_hard = model(*args, hard=True)
        k_gate = w_hard.argmax(1)
        for label, kw in (("dense soft", {"hard": False}),
                          ("dense hard", {"hard": True}),
                          ("infer_mode=2", {"infer_mode": 2})):
            timed = _timed(lambda kw=kw: model(*args, **kw))
            out = timed[2][0]
            ref = {"dense soft": out, "dense hard": hard_out,
                   "infer_mode=2": d2}[label]
            check(label, timed, out, ref, True)
        for frac in (0.0, 0.25, 0.5):
            fk = (torch.arange(bsz, device="cuda")
                  < int(round(frac * bsz))).int()
            timed = _timed(
                lambda fk=fk: model.forward_routed_compact(*args, force_k=fk))
            out, w = timed[2]
            ref = torch.where(fk[:, None] == 1, d2, d1)
            check(f"compact {int(frac * 100)} % expensive", timed, out, ref,
                  torch.equal(w, w_hard), {"expensive_rows": int(fk.sum())})
        timed = _timed(lambda: model.forward_routed_compact(*args))
        out, w = timed[2]
        check("compact live gate", timed, out, hard_out,
              torch.equal(w, w_hard), {"expensive_rows": int(k_gate.sum())})
        one = tuple([x[:1] for x in a] for a in args)
        for branch in (0, 1):
            saved = _forced_gate(gate_fc, branch)
            try:
                timed = _timed(lambda: model.forward_switch(*one))
                ref, _, w_d = model(*one, hard=True)
            finally:
                gate_fc.load_state_dict(saved)
            out, w = timed[2]
            check(f"switch B=1 branch {branch + 1}", timed, out, ref,
                  torch.equal(w, w_d) and int(w.argmax()) == branch)

        # the card's dense forward against the CPU's on the same weights
        n = bsz if name == "imdb" else 128
        cpu = copy.deepcopy(model).cpu()
        sub = tuple([x[:n].cpu() for x in a] for a in args)
        cpu_err = {}
        for label, kw in (("soft", {"hard": False}), ("branch 1",
                          {"infer_mode": 1}), ("branch 2", {"infer_mode": 2})):
            want = cpu(*sub, **kw)[0]
            got = model(*args, **kw)[0][:n].cpu()
            cpu_err[label] = ((got - want).abs().max()
                              / want.abs().max()).item()
        _, _, w_cpu = cpu(*sub, hard=True)
        gate_agree = (w_cpu.argmax(1) == k_gate[:n].cpu()).float().mean().item()
    print(f"  {name} card vs CPU on {n} rows: rel err {cpu_err}; hard gate "
          f"choices agree on {gate_agree * 100:.3f} %; the live gate sends "
          f"{int(k_gate.sum())} of {bsz} rows to the expensive branch",
          flush=True)
    if max(cpu_err.values()) > CPU_TOL:
        raise RuntimeError(f"{name}: the card's forward differs from the CPU's")
    return {"batch": bsz, "requests": rows, "cpu_rows": n,
            "card_vs_cpu_rel_err": cpu_err, "card_vs_cpu_gate_agreement":
            gate_agree, "live_gate_expensive_rows": int(k_gate.sum())}


def train_cli(name: str, cli, argv: list, router: str, ckpt: str,
              test_batch) -> dict:
    """One CLI's ``main(argv)`` in a temporary working directory, with its
    train steps timed (see the module docstring)."""
    import contextlib
    import io
    import os
    import statistics
    import tempfile

    import numpy as np

    from dynmm_tpu_torch.models.modality import build_router
    from dynmm_tpu_torch.train.supervised import SupervisedTrainer
    from dynmm_tpu_torch.utils.checkpoint import load_checkpoint
    from dynmm_tpu_torch.utils.weights import (flax_variables,
                                               load_checkpoint_into)

    steps, trainers = [], []
    step = SupervisedTrainer.train_step

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, state, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(out[0])})
        if not trainers:
            trainers.append(self)
        return out

    log = io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        SupervisedTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                cli.main(argv)
            run_s = time.perf_counter() - t0
        finally:
            SupervisedTrainer.train_step = step
            os.chdir(cwd)
        payload = load_checkpoint(os.path.join(tmp, "log", ckpt))
        fresh = build_router(router, seed=5, device="cuda")
        load_checkpoint_into(fresh, os.path.join(tmp, "log", ckpt))
    out_lines = log.getvalue().splitlines()
    for line in out_lines:
        print(f"    | {line[:200]}", flush=True)
    result = [ln for ln in out_lines if "Total Flops" in ln]
    if len(result) != 1:
        raise RuntimeError(f"{name}: no result line")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), np.asarray(v)

    start = build_router(router, seed=0, device="cpu")  # the CLI's start
    before = dict(leaves(flax_variables(start)["params"]))
    after = dict(leaves(payload["state"]["params"]))
    gate = [p for p in before if p[0] == "gate"]
    frozen_same = all(np.array_equal(after[p], v) for p, v in before.items()
                      if p[0] != "gate")
    gate_moved = bool(gate) and not any(np.array_equal(after[p], before[p])
                                        for p in gate)
    stat_leaves = [v for _, v in leaves(payload["state"].get(
        "model_state", {}).get("batch_stats", {}))]
    stats_finite = all(np.isfinite(v).all() for v in stat_leaves)

    model = trainers[0].model.eval()
    with torch.inference_mode():
        got = fresh(*test_batch, hard=True)
        want = model(*test_batch, hard=True)
    reload_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    losses = [st["loss"] for st in steps]
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    print(f"  {name}: {len(steps)} train steps, {step_ms:.3f} ms a step "
          f"(median after the first; all {[round(st['ms'], 3) for st in steps]}"
          f"), losses {[round(x, 4) for x in losses]}; run {run_s:.2f} s; "
          f"frozen parameters bit-identical: {frozen_same}; all {len(gate)} "
          f"gate leaves moved: {gate_moved}; {len(stat_leaves)} BN statistics "
          f"finite: {stats_finite}; checkpoint in a fresh router vs the CLI's "
          f"model, hard eval max abs err {reload_err:.3g}", flush=True)
    if not (all(math.isfinite(x) for x in losses) and frozen_same
            and gate_moved and stats_finite and reload_err == 0):
        raise RuntimeError(f"{name}: CLI training check failed")
    return {"argv": argv, "steps": steps, "step_ms_median": step_ms,
            "run_s": run_s, "result_line": result[0],
            "frozen_params_identical": frozen_same, "gate_moved": gate_moved,
            "bn_statistics": len(stat_leaves),
            "checkpoint_reload_max_abs_err": reload_err}


def check_modality(report: dict) -> None:
    from dynmm_tpu_torch.cli import affect_dyn, imdb_dyn
    from dynmm_tpu_torch.data.affect import synthetic_mosei_loaders
    from dynmm_tpu_torch.data.imdb import synthetic_imdb_loaders
    from dynmm_tpu_torch.kernels import LAUNCHES
    from dynmm_tpu_torch.models.modality import build_router

    before = dict(LAUNCHES)
    inp = Inputs(seed=7)
    imdb = build_router("imdb", seed=1)
    mosei = build_router("mosei", seed=2)
    lengths = torch.full((MOSEI_B,), MOSEI_T, dtype=torch.long, device="cuda")
    section = {
        "imdb": serve_router(
            "imdb", imdb, ([inp.randn(IMDB_B, 300), inp.randn(IMDB_B, 4096)],),
            imdb.gate.fc2),
        "mosei": serve_router(
            "mosei", mosei,
            ([inp.randn(MOSEI_B, MOSEI_T, d) for d in (35, 74, 300)],
             [lengths] * 3), mosei.gate.fc)}
    del imdb, mosei

    common = ["--synthetic", "--freeze", "--no-pretrain", "--n-epochs", "3",
              "--device", "cuda"]
    test = next(iter(synthetic_imdb_loaders(batch_size=128)[2]))
    imdb_batch = ([torch.from_numpy(x).cuda() for x in test.inputs],)
    section["imdb_train"] = train_cli(
        "imdb_dyn", imdb_dyn, common + ["--reg", "0.1"], "imdb",
        "imdb/DynMMNet_freezeTrue_reg_0.1.msgpack", imdb_batch)
    test = next(iter(synthetic_mosei_loaders(batch_size=32)[2]))
    mosei_batch = ([torch.from_numpy(x).cuda() for x in test.inputs],
                   [torch.from_numpy(x).long().cuda() for x in test.lengths])
    section["mosei_train"] = train_cli(
        "affect_dyn", affect_dyn, common + ["--reg", "0.01"], "mosei",
        "mosei/dyn_enc_transformer_reg_0.01freezeTrue.msgpack", mosei_batch)
    if dict(LAUNCHES) != before:
        raise RuntimeError(f"a port kernel launched in phase 7: {before} -> "
                           f"{dict(LAUNCHES)}")
    print("  no kernel launch counter moved in this phase", flush=True)
    report["modality"] = section


CLI_SAMPLES = 16  # the prepared test split of phase 8: two batches of 8
CLI_SWITCH_NUM = 4  # samples predict serves at B=1 in the switch modes
# launches of one gate_only call (the stems and the gate): the stem cell
GATE_ONLY_LAUNCHES = {"channel_sums": 1, "stem_fuse_pool": 1}


def _add(total: dict, more: dict, times: int = 1) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v * times
    return total


def _write_layout(root: Path) -> float:
    """The prepared NYUv2 layout of phase 8 (``data/png.py``): test/rgb,
    test/depth (uint16 mm), test/labels_40 and the split lists (the train
    list names the same ids; eval never reads the train files)."""
    import numpy as np

    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset

    ds = SyntheticSegDataset(n=CLI_SAMPLES, height=HEIGHT, width=WIDTH,
                             split="test", mixed_modality_frac=0.5)
    for kind in ("rgb", "depth", "labels_40"):
        (root / "test" / kind).mkdir(parents=True)
    t0 = time.perf_counter()
    ids = []
    for i in range(CLI_SAMPLES):
        s, name = ds[i], f"{i:05d}"
        ids.append(name)
        png.write(str(root / "test" / "rgb" / f"{name}.png"), s["image"])
        png.write(str(root / "test" / "depth" / f"{name}.png"),
                  np.round(s["depth"]).astype(np.uint16))
        png.write(str(root / "test" / "labels_40" / f"{name}.png"), s["label"])
    for split in ("train", "test"):
        (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
    return time.perf_counter() - t0


def _host_share(root: Path, model, report: dict) -> None:
    """One batch's host work, each part apart: PNG decode (rgb, depth,
    label), preprocessing (resize, normalise, label maps), stacking, stem
    packing; beside the dense B=8 forward on the card."""
    import statistics

    import numpy as np

    from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor,
                                                        pack_stem_batch)
    from dynmm_tpu_torch.serve import serve

    ds = NYUv2Dataset(str(root), "test")
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                          phase="test")
    rng = np.random.default_rng(0)
    parts = {"png_decode": [], "preprocess": [], "stack": [], "pack": [],
             "forward": []}
    for _ in range(3):
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(BATCH)]
        t1 = time.perf_counter()
        samples = [pre(s, rng) for s in samples]
        t2 = time.perf_counter()
        batch = SegLoader._stack(samples)
        t3 = time.perf_counter()
        pack_stem_batch(batch)
        t4 = time.perf_counter()
        rgb = torch.from_numpy(batch["image"]).cuda()
        depth = torch.from_numpy(batch["depth"]).cuda()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        serve(model, rgb, depth, mode="dense")
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4),
                                     (t5, t6))):
            parts[k].append((b - a) * 1e3)
    ms = {k: statistics.median(v) for k, v in parts.items()}
    loader_ms = ms["png_decode"] + ms["preprocess"] + ms["stack"]
    keeps_up = loader_ms + ms["pack"] <= ms["forward"]
    print("  host work of one B=8 batch (median of 3): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; the loader thread's {loader_ms + ms['pack']:.2f} ms (packed) "
          f"{'keeps' if keeps_up else 'does not keep'} up with the "
          f"{ms['forward']:.2f} ms forward", flush=True)
    report["host_ms_per_batch"] = ms
    report["host_keeps_up"] = keeps_up


def check_clis(report: dict) -> dict:
    """Phase 8: ``cli.eval`` and ``cli.predict`` on a prepared layout."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset, class_colors
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor,
                                                        pack_stem_batch)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.models.skip_gate import capacity_ladders
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    root = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    section: dict = {"eval": [], "predict": []}
    validate = SegTrainer.validate
    try:
        write_s = _write_layout(root)
        model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
        load_recipe_gate(model)
        v = flax_from_state_dict(model.state_dict())
        ckpt = str(root / "flagship.msgpack")
        save_checkpoint(ckpt, {"params": v["params"],
                               "model_state": {"batch_stats":
                                               v["batch_stats"]}}, epoch=0)
        pth = str(root / "flagship.pth")
        torch.save({k: t.cpu() for k, t in model.state_dict().items()}, pth)
        print(f"  wrote {CLI_SAMPLES} samples at {HEIGHT}x{WIDTH} in "
              f"{write_s:.2f} s, the flagship (recipe gate merged) as "
              ".msgpack and .pth", flush=True)

        # the test batches as the CLIs' loaders give them, raw and packed,
        # and each sample's path (the launches each run must give)
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        batches = []
        for b in SegLoader(ds, pre, batch_size=BATCH, prefetch=0):
            p = pack_stem_batch(b)
            batches.append({k: torch.from_numpy(x).cuda() for k, x in (
                ("rgb", b["image"]), ("depth", b["depth"]),
                ("prgb", p["image"]), ("pdepth", p["depth"]))})
        with torch.inference_mode():
            paths = [model.gate_only(b["rgb"], b["depth"]).argmax(1).tolist()
                     for b in batches]
            ppaths = [model.gate_only(b["prgb"], b["pdepth"]).argmax(1)
                      .tolist() for b in batches]
        flat = sum(paths, [])
        mix = np.bincount(flat, minlength=5) / len(flat)
        print(f"  paths of the {len(flat)} samples {flat}, mix "
              f"{mix.tolist()}; packed inputs take the same paths: "
              f"{ppaths == paths}", flush=True)
        if ppaths != paths:
            raise RuntimeError(f"packed-stem gate choices {ppaths} != {paths}")
        ratios = mix.astype(np.float32)  # GateStats over the calib batches
        _host_share(root, model, section)

        # kernels against the plain versions on one batch, raw and packed;
        # the packed stem's logits against the raw stem's
        b0 = batches[0]
        with torch.inference_mode():
            agree = {}
            for kind, (r, d) in (("raw", (b0["rgb"], b0["depth"])),
                                 ("packed", (b0["prgb"], b0["pdepth"]))):
                cm_k, _ = serve(model, r, d, mode="dense")
                cm_p, _ = serve(model, r, d, mode="dense", use_kernels=False)
                agree[kind] = (cm_k == cm_p).float().mean().item()
            packed_rel = _rel(model(b0["prgb"], b0["pdepth"], hard=True),
                              model(b0["rgb"], b0["depth"], hard=True))
        print(f"  kernels vs plain class maps agree on {agree['raw'] * 100:.4f}"
              f" % (raw), {agree['packed'] * 100:.4f} % (packed); packed vs "
              f"raw stem logits rel err {packed_rel:.3g}", flush=True)
        section.update(kernels_vs_plain_agreement=agree,
                       packed_vs_raw_logits_rel_err=packed_rel,
                       paths=flat, path_mix=mix.tolist())
        if min(agree.values()) < 0.999 or packed_rel > 1e-4:
            raise RuntimeError("phase 8: kernel/plain or packed/raw mismatch")

        dense = path_launches([True] * 4, False)
        # the capacity runs' calibration: gate_only on every batch
        # (--calib_batches 8 ≥ 2)
        calib = _add({}, GATE_ONLY_LAUNCHES, len(batches))

        def strict(factor, p):
            return {"caps": capacity_ladders(ratios, len(p),
                                             capacity_factor=factor),
                    "strict_caps": True}

        def routed(mode, low_res=False, kw=lambda p: {}, pp=paths):
            out = {}
            for p in pp:
                _add(out, path_launches(stages_run(mode, p, kw(p)), low_res))
            return out

        timings = []

        def timed_validate(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(self, *a, **k)
            torch.cuda.synchronize()
            timings.append((time.perf_counter() - t0,
                            out[1]["time_forward"]))
            return out

        SegTrainer.validate = timed_validate
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root),
                "--height", str(HEIGHT), "--width", str(WIDTH),
                "--batch_size", str(BATCH)]
        hard = [*base, "--dynamic", "--global-gate", "--hard"]
        n_b = len(batches)
        evals = [
            ("msgpack", [*hard, "--ckpt_path", ckpt], _add({}, dense, n_b)),
            (".pth", [*hard, "--ckpt_path", pth], _add({}, dense, n_b)),
            ("noise x2", [*hard, "--ckpt_path", ckpt, "--num_runs", "2",
                          "--mode", "2", "--noise", "0.5"],
             _add({}, dense, 2 * n_b)),
            ("quarter", [*hard, "--ckpt_path", ckpt, "--output_res",
                         "quarter"],
             _add({}, path_launches([True] * 4, True), n_b)),
            ("capacity 8.0", [*hard, "--ckpt_path", ckpt,
                              "--capacity_factor", "8.0"],
             _add(routed("compact", kw=lambda p: strict(8.0, p)), calib)),
            ("packed", [*hard, "--ckpt_path", ckpt, "--packed_stem"],
             _add({}, dense, n_b)),
        ]
        # warm-up (cuDNN picks its algorithms), not counted
        with contextlib.redirect_stdout(io.StringIO()):
            eval_cli.main(evals[0][1])
        timings.clear()
        launches: dict = {}
        mious = {}
        for label, argv, expected in evals:
            out = io.StringIO()
            # each run: counts at 0 just before, read just after
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = eval_cli.main(argv)
            wall = time.perf_counter() - t0
            got = dict(LAUNCHES)
            _add(launches, got)
            if {k: v for k, v in got.items() if v} != expected:
                raise RuntimeError(f"eval {label}: launches {got} != "
                                   f"{expected}")
            runs = [timings.pop(0) for _ in range(len(result))]
            s_batch = sum(t for t, _ in runs) / (len(runs) * n_b)
            fwd_batch = sum(f for _, f in runs) / (len(runs) * n_b)
            mious[label] = result.tolist()
            lines = [ln for ln in out.getvalue().splitlines()
                     if ln.startswith(("Run", "  branch", "capacity"))]
            row = {"run": label, "miou": result.tolist(), "wall_s": wall,
                   "s_per_batch": s_batch, "forward_s_per_batch": fwd_batch,
                   "launches": got, "lines": lines}
            section["eval"].append(row)
            print(f"  eval {label:12s}: mIoU "
                  f"{[round(float(m), 4) for m in result]}, "
                  f"{s_batch:.4f} s a batch of {BATCH} ({fwd_batch:.4f} s "
                  f"forward to class map), {wall:.2f} s in all [{card}]",
                  flush=True)
            for ln in lines:
                print(f"    {ln.strip()}", flush=True)
        SegTrainer.validate = validate
        if mious[".pth"] != mious["msgpack"]:
            raise RuntimeError(f"eval: .pth mIoU {mious['.pth']} != msgpack "
                               f"{mious['msgpack']}")
        if mious["capacity 8.0"] != mious["msgpack"]:
            raise RuntimeError("eval: capacity factor 8.0 differs from the "
                               "exact chain")

        colors = class_colors(CLASSES + 1)
        pbase = [*base, "--ckpt_path", ckpt]
        sw = ["--batch_size", "1", "--num", str(CLI_SWITCH_NUM)]
        singles = [[p] for p in flat[:CLI_SWITCH_NUM]]
        predicts = [
            ("batchmax", [], "batchmax", False, False, {},
             routed("batchmax")),
            ("dense", ["--serve_mode", "dense"], "dense", False, False, {},
             _add({}, dense, n_b)),
            ("compact", ["--serve_mode", "compact"], "compact", False, False,
             {}, routed("compact")),
            ("compact x1.25", ["--serve_mode", "compact", "--capacity_factor",
                               "1.25"], "compact", False, False, "cf",
             _add(routed("compact", kw=lambda p: strict(1.25, p)), calib)),
            ("switch", ["--serve_mode", "switch", *sw], "switch", False,
             False, {}, routed("switch", pp=singles)),
            ("switch_host", ["--serve_mode", "switch_host", *sw],
             "switch_host", False, False, {}, routed("switch", pp=singles)),
            ("quarter", ["--output_res", "quarter"], "batchmax", True, False,
             {}, routed("batchmax", low_res=True)),
            ("packed", ["--packed_stem"], "batchmax", False, True, {},
             routed("batchmax")),
        ]
        for label, extra, mode, low_res, packed, kw, expected in predicts:
            out_dir = root / f"pred_{label.replace(' ', '_')}"
            out = io.StringIO()
            reset_launches()
            with contextlib.redirect_stdout(out):
                res = predict_cli.main([*pbase, *extra, "--out_dir",
                                        str(out_dir)])
            got = dict(LAUNCHES)
            _add(launches, got)
            if {k: v for k, v in got.items() if v} != expected:
                raise RuntimeError(f"predict {label}: launches {got} != "
                                   f"{expected}")
            # the written maps against serve()'s on the same batches
            single = mode in ("switch", "switch_host")
            keys = ("prgb", "pdepth") if packed else ("rgb", "depth")
            reqs = ([tuple(b[k][i:i + 1] for k in keys)
                     for b in batches for i in range(BATCH)] if single else
                    [tuple(b[k] for k in keys) for b in batches])
            maps = []
            for r, d in reqs:
                r, d = r.contiguous(), d.contiguous()
                skw = strict(1.25, [0] * r.shape[0]) if kw == "cf" else {}
                cm, _ = serve(model, r, d, mode=mode, low_res=low_res, **skw)
                maps.extend(cm.cpu().numpy())
                if len(maps) >= res["n"]:
                    break
            diff = [np.abs(png.read(str(out_dir / f"pred_{i:05d}.png"))
                           .astype(np.int32) - colors[maps[i] + 1])
                    for i in range(res["n"])]
            err = max(int(d.max()) for d in diff)
            same = float(np.mean([(d == 0).all(axis=-1).mean() for d in diff]))
            row = {"run": label, "n": res["n"], "fps": res["fps"],
                   "path_distribution": np.asarray(res["ratios"]).tolist(),
                   "png_max_abs_err": err, "png_pixels_equal": same,
                   "launches": got}
            section["predict"].append(row)
            print(f"  predict {label:13s}: {res['n']} maps, "
                  f"{res['fps']:.2f} frames/s, path distribution "
                  f"{np.round(np.float64(res['ratios']), 3).tolist()}, PNGs "
                  f"vs serve() max abs err {err} ({same * 100:.4f} % of "
                  f"pixels equal) [{card}]", flush=True)
            if err != 0:
                raise RuntimeError(f"predict {label}: written maps differ "
                                   "from serve()'s")
    finally:
        SegTrainer.validate = validate
        shutil.rmtree(root, ignore_errors=True)
    report["clis"] = section
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "dynmm_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no dynmm_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dynmm_tpu_torch.kernels import build_all
    from dynmm_tpu_torch.utils.device import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("TF32 off for cuDNN convolutions and matmuls: kernels and plain "
          "versions compare in fp32", flush=True)
    report = {"card": card, "torch": torch.__version__, "kernel_cases": [],
              "serve": [], "routed": []}

    print("[1] build", flush=True)
    report["build_s"] = build_all(verbose=True)
    print(f"  built the kernels in {report['build_s']:.2f} s", flush=True)

    print(f"[2] kernels vs plain versions at the flagship's shapes, B={BATCH}",
          flush=True)
    kernels = check_kernels(report)

    print(f"[3] serve the {HEIGHT}x{WIDTH} flagship, dense", flush=True)
    model, launches = check_serve(report)
    print(f"[4] serve the {HEIGHT}x{WIDTH} flagship through the routed "
          "strategies", flush=True)
    routed = check_routed(model, report)
    del model
    print(f"[5] recipe gate: the {HEIGHT}x{WIDTH} flagship with "
          "bench_assets/gate_recipe.msgpack", flush=True)
    recipe = check_recipe_gate(report)
    print(f"[6] train the {HEIGHT}x{WIDTH} flagship: SegTrainer.fit, 2 epochs "
          f"of 2 steps of B={BATCH}", flush=True)
    trained = check_train(report)
    print(f"[7] modality-level DynMM: MM-IMDB at B={IMDB_B}, CMU-MOSEI at "
          f"B={MOSEI_B} T={MOSEI_T}; the imdb_dyn and affect_dyn CLIs",
          flush=True)
    check_modality(report)
    print(f"[8] the eval and predict CLIs on a prepared NYUv2 layout of "
          f"{CLI_SAMPLES} samples at {HEIGHT}x{WIDTH}, B={BATCH}", flush=True)
    clis = check_clis(report)
    print("[9] kernels", flush=True)
    for k in kernels:
        k["launches"] = sum(run.get(k["name"], 0) for run in
                            (launches, routed, recipe, trained, clis))
        if k["launches"] == 0:
            raise RuntimeError(f"{k['name']} never launched on the main path")
    report["kernels"] = kernels

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
