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
5. Prints the kernels' JSON line (launches summed over phases 3 and 4), the
   card line, and last ``{"ok": true, "device": {...}}``.

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
                  None, 2 * n * 4 + 2 * b * c * 4, 2.0 * n, None))
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
                lib_err = (case.lib() - outs_p[0]).abs().max().item() / scale
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
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0) + routed.get(k["name"], 0)
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
