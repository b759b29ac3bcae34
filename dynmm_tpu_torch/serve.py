"""Serve the flagship: the port's counterpart of ``__graft_entry__._flagship``
/ ``entry`` and of predict.py's serving step (``--serve_mode``,
``--output_res quarter``, ``--capacity_factor``).

The flagship is SkipGateESANet with ResNet34-NonBottleneck1D encoders for
RGB (3-ch) and depth (1-ch), SE-add fusion, PPM context, decoder channels
(512, 256, 128) with 3 NonBottleneck1D blocks each, learned-3x3-zeropad
upsampling and 40 classes at 480×640, in fp32 eval with the hard global
gate; ``build_flagship(encoder="resnet50")`` builds the same net on
Bottleneck ResNet50 encoders, ``build_flagship(dtype=torch.bfloat16)`` the
bf16 net (fp32 parameters, bf16 maps, the gate in fp32; the JAX bench's
serving dtype), ``build_flagship(quant="int8")`` the int8 net, calibrated
and packed by ``utils/quantize.py::quantize_int8``. ``serve`` serves any
SkipGateESANet.

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
                   device=None, seed: int = 0, encoder: str = "resnet34",
                   dtype: torch.dtype | None = None,
                   quant: str | None = None,
                   activation: str = "relu") -> SkipGateESANet:
    """The flagship with seeded random weights, in eval, on ``device``
    (``None`` = the card; raises without one unless ``device="cpu"``).
    ``encoder="resnet50"``: the same net on Bottleneck ResNet50 encoders
    (the JAX bench's second model; SE cells up to C = 2048). ``dtype``:
    the compute dtype (None: fp32); the seeded weights do not depend on
    it. ``quant="int8"``: the net with quantized convs (``nn/quant.py``),
    which ``utils/quantize.py::quantize_int8`` calibrates and packs before
    it serves. ``activation``: relu, swish or hswish (the swish and hswish
    nets run their SE cells and NBt1D blocks in PyTorch ops)."""
    dev = resolve_device(device)
    model = SkipGateESANet(ESANetConfig(
        height=height, width=width, num_classes=num_classes,
        encoder_rgb=encoder, encoder_depth=encoder, dtype=dtype,
        quant=quant, activation=activation))
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
    fwd, kw = _strategy(model, mode, caps, strict_caps, force_path, low_res,
                        use_kernels)
    dev = next(model.parameters()).device
    pack = 2 if rgb.dim() == 4 and rgb.shape[-1] == 12 else 1
    for name, x, c in (("rgb", rgb, 3), ("depth", depth, 1)):
        c *= pack * pack
        if x.dim() != 4 or x.shape[-1] != c or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 (B,H,W,{c}), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the model on {dev}")
    with torch.inference_mode():
        logits, weight = fwd(rgb.contiguous(), depth.contiguous(), **kw)
        class_map = first_argmax(logits, dim=-1)
        if low_res:
            scale = rgb.shape[1] * pack // class_map.shape[1]
            class_map = class_map.repeat_interleave(scale, dim=1
                                                    ).repeat_interleave(scale, dim=2)
        return class_map, weight


def _strategy(model: SkipGateESANet, mode: str, caps=None,
              strict_caps: bool = False, force_path: int | None = None,
              low_res: bool = False, use_kernels: bool = True):
    """(the model's forward of ``mode``, its keyword arguments): returns
    ``(logits, weight)`` when called on (rgb, depth)."""
    if mode not in SERVE_MODES:
        raise ValueError(f"mode must be one of {SERVE_MODES}, got {mode!r}")
    if force_path is not None and mode in ("dense", "compact"):
        raise ValueError(f"force_path does not apply to mode {mode!r}")
    if (caps is not None or strict_caps) and mode != "compact":
        raise ValueError("caps and strict_caps apply to mode 'compact'")
    kw = dict(return_weight=True, low_res=low_res, use_kernels=use_kernels)
    if mode == "dense":
        return model.forward, dict(kw, hard=True)
    if mode == "batchmax":
        return model.forward_switch_batched, dict(kw, force_path=force_path)
    if mode == "compact":
        return model.forward_routed_compact, dict(kw, caps=caps,
                                                  strict_caps=strict_caps)
    return model.forward_switch, dict(kw, force_path=force_path)


class ServingForward(nn.Module):
    """``serve``'s hard-gate forward as a module: ``forward(rgb, depth)`` →
    ``(logits, weight)``, NHWC logits (H/4 with ``low_res``) before the
    class map; the arguments are ``serve``'s. This is what
    ``utils/serve_export.py`` traces: the routed modes' host reads become
    ``torch.cond``s there (``models/skip_gate.py``). ``switch_host``, a
    host-side dispatch, has no single-program form and raises."""

    def __init__(self, model: SkipGateESANet, mode: str = "batchmax",
                 caps=None, strict_caps: bool = False,
                 force_path: int | None = None, low_res: bool = False):
        super().__init__()
        if mode == "switch_host":
            raise ValueError("switch_host dispatches on the host between a "
                             "gate program and five path programs; export "
                             "mode 'switch' instead")
        _strategy(model, mode, caps, strict_caps, force_path)  # the checks
        self.model = model
        self.options = (mode, caps, strict_caps, force_path, low_res)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        fwd, kw = _strategy(self.model, *self.options)
        return fwd(rgb, depth, **kw)


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
