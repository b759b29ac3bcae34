"""Serve the flagship: the port's counterpart of ``__graft_entry__._flagship``
/ ``entry`` and of predict.py's serving step (``--serve_mode``,
``--output_res quarter``, ``--capacity_factor``).

The flagship is SkipGateESANet with ResNet34-NonBottleneck1D encoders for
RGB (3-ch) and depth (1-ch), SE-add fusion, PPM context, decoder channels
(512, 256, 128) with 3 NonBottleneck1D blocks each, learned-3x3-zeropad
upsampling and 40 classes at 480×640, in fp32 eval with the hard global
gate.

    model = build_flagship()                                # on the card
    class_map, weight = serve(model, rgb, depth)            # batchmax
    class_map, weight = serve(model, rgb, depth, mode="compact",
                              caps=capacity_schedule(model, calib, 8))
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet, capacity_ladders
from dynmm_tpu_torch.nn.layers import (BatchNorm2d, Upsample,
                                       _bilinear_3x3_kernel, first_argmax,
                                       pack_weights)
from dynmm_tpu_torch.utils.device import resolve_device

SERVE_MODES = ("dense", "batchmax", "compact", "switch", "switch_host")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: He (fan-out) normal convs with small biases, BN
    affine and running statistics drawn away from identity so the folded-BN
    paths carry real values, learned upsamples near the bilinear kernel."""
    def randn(shape, std=1.0):
        return torch.randn(shape, generator=generator) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(randn(m.weight.shape, math.sqrt(2.0 / fan_out)))
            if m.bias is not None:
                m.bias.copy_(randn(m.bias.shape, 0.05))
        elif isinstance(m, BatchNorm2d):
            c = m.weight.shape
            m.weight.copy_(uniform(c, 0.5, 1.0))
            m.bias.copy_(randn(c, 0.1))
            m.running_mean.copy_(randn(c, 0.1))
            m.running_var.copy_(uniform(c, 0.5, 1.5))
    for m in model.modules():
        if isinstance(m, Upsample) and hasattr(m, "conv"):
            w = m.conv.weight
            w.copy_(_bilinear_3x3_kernel(w.shape[0]) + randn(w.shape, 0.02))
    pack_weights(model)


def build_flagship(height: int = 480, width: int = 640, num_classes: int = 40,
                   device=None, seed: int = 0) -> SkipGateESANet:
    """The flagship with seeded random weights, in eval, on ``device``
    (``None`` = the card; raises without one unless ``device="cpu"``)."""
    dev = resolve_device(device)
    model = SkipGateESANet(ESANetConfig(height=height, width=width,
                                        num_classes=num_classes))
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev, memory_format=torch.channels_last).eval()


def serve(model: SkipGateESANet, rgb: torch.Tensor, depth: torch.Tensor,
          mode: str = "batchmax", caps=None, strict_caps: bool = False,
          force_path: int | None = None, low_res: bool = False,
          use_kernels: bool = True):
    """Hard-gate inference on NHWC images: rgb (B,H,W,3), depth (B,H,W,1),
    fp32 on the model's device, or both 2×2 space-to-depth packed
    ((B,H/2,W/2,12) and (B,H/2,W/2,4), ``data/seg_preprocessing.py::
    pack_stem_batch``) for the packed stem. Returns the class map (B,H,W)
    int32 (first index on ties) and the gate weights (B,5).

    ``mode`` (predict.py's ``--serve_mode``): ``dense`` (every branch,
    ``forward``), ``batchmax`` (``forward_switch_batched``, the default),
    ``compact`` (``forward_routed_compact`` with ``caps``/``strict_caps``),
    ``switch`` (``forward_switch``, batch 1). ``switch_host`` is the JAX
    package's two-phase dispatch (a gate program, then one of five static
    path programs); eager PyTorch already resolves the path on the host
    after the gate, so it is ``switch`` here and gives the same result.
    ``force_path`` applies to ``batchmax`` and the switch modes.
    ``low_res``: the class map is taken from the H/4 logits and repeated
    ×4 on both axes (predict.py's ``--output_res quarter``)."""
    if mode not in SERVE_MODES:
        raise ValueError(f"mode must be one of {SERVE_MODES}, got {mode!r}")
    if force_path is not None and mode in ("dense", "compact"):
        raise ValueError(f"force_path does not apply to mode {mode!r}")
    if (caps is not None or strict_caps) and mode != "compact":
        raise ValueError("caps and strict_caps apply to mode 'compact'")
    dev = next(model.parameters()).device
    pack = 2 if rgb.dim() == 4 and rgb.shape[-1] == 12 else 1
    for name, x, c in (("rgb", rgb, 3), ("depth", depth, 1)):
        c *= pack * pack
        if x.dim() != 4 or x.shape[-1] != c or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 (B,H,W,{c}), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the model on {dev}")
    kw = dict(return_weight=True, low_res=low_res, use_kernels=use_kernels)
    if mode == "dense":
        fwd = model.forward
        kw["hard"] = True
    elif mode == "batchmax":
        fwd = model.forward_switch_batched
        kw["force_path"] = force_path
    elif mode == "compact":
        fwd = model.forward_routed_compact
        kw.update(caps=caps, strict_caps=strict_caps)
    else:
        fwd = model.forward_switch
        kw["force_path"] = force_path
    with torch.inference_mode():
        logits, weight = fwd(rgb.contiguous(), depth.contiguous(), **kw)
        class_map = first_argmax(logits, dim=-1)
        if low_res:
            scale = rgb.shape[1] * pack // class_map.shape[1]
            class_map = class_map.repeat_interleave(scale, dim=1
                                                    ).repeat_interleave(scale, dim=2)
        return class_map, weight


def capacity_schedule(model: SkipGateESANet, calib_batches, batch_size: int,
                      capacity_factor: float | None = None,
                      use_kernels: bool = True) -> tuple:
    """Per-stage capacity ladders for ``serve(mode="compact")``: the branch
    ratios of the hard gate (``gate_only``: stems and gate) over
    ``calib_batches``, an iterable of (rgb, depth) NHWC pairs, through
    ``capacity_ladders``. With ``capacity_factor`` the schedule is strict
    (serve it with ``strict_caps=True``), as predict.py's
    ``--capacity_factor``."""
    with torch.inference_mode():
        weights = [model.gate_only(rgb.contiguous(), depth.contiguous(),
                                   use_kernels=use_kernels)
                   for rgb, depth in calib_batches]
    ratios = torch.cat(weights).double().mean(dim=0).cpu().numpy()
    return capacity_ladders(ratios, batch_size, capacity_factor)
