"""Serve the flagship: the port's counterpart of ``__graft_entry__._flagship``
/ ``entry`` and of predict.py's dense hard-gate step.

The flagship is SkipGateESANet with ResNet34-NonBottleneck1D encoders for
RGB (3-ch) and depth (1-ch), SE-add fusion, PPM context, decoder channels
(512, 256, 128) with 3 NonBottleneck1D blocks each, learned-3x3-zeropad
upsampling and 40 classes at 480×640, in fp32 eval with the hard global
gate.

    model = build_flagship()                    # on the card
    class_map, weight = serve(model, rgb, depth)  # (B,H,W) int32, (B,5)
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.nn.layers import (BatchNorm2d, Upsample,
                                       _bilinear_3x3_kernel, first_argmax,
                                       pack_weights)
from dynmm_tpu_torch.utils.device import resolve_device


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
          use_kernels: bool = True):
    """Dense hard-gate inference on NHWC images: rgb (B,H,W,3), depth
    (B,H,W,1), fp32 on the model's device. Returns the class map
    (B,H,W) int32 (first index on ties) and the gate weights (B,5)."""
    dev = next(model.parameters()).device
    for name, x, c in (("rgb", rgb, 3), ("depth", depth, 1)):
        if x.dim() != 4 or x.shape[-1] != c or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 (B,H,W,{c}), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the model on {dev}")
    with torch.inference_mode():
        logits, weight = model(rgb.contiguous(), depth.contiguous(),
                               hard=True, return_weight=True,
                               use_kernels=use_kernels)
        return first_argmax(logits, dim=-1), weight
