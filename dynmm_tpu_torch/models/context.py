"""Pyramid Pooling context module (port of ``dynmm_tpu/models/context.py``).

The default ESANet context is ``ppm`` with bins (1, 5) on the 1/32 map
(15×20 at 480×640). The adaptive variant (APPM) and running without a
context module are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynmm_tpu_torch.nn.layers import (ConvBNAct, nchw, nhwc, resize_bilinear,
                                       resize_nearest)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: tuple[int, int]
                        ) -> torch.Tensor:
    """Adaptive average pooling of NHWC with torch's bins
    (start ⌊i·H/oh⌋, end ⌈(i+1)·H/oh⌉)."""
    return F.adaptive_avg_pool2d(nchw(x), output_size).permute(0, 2, 3, 1)


def _upsample_to(y: torch.Tensor, hw: tuple[int, int], mode: str):
    if mode == "nearest":
        return resize_nearest(y, hw)
    if mode == "bilinear":
        return resize_bilinear(y, hw)
    raise NotImplementedError(
        "For the PyramidPoolingModule only nearest and bilinear interpolation "
        f"are supported. Got: {mode}")


class PyramidPoolingModule(nn.Module):
    """Per-bin adaptive pool → 1×1 ConvBNAct (in → in/len(bins)) → upsample
    back → concat with the input → 1×1 ConvBNAct. NCHW in and out."""

    def __init__(self, in_dim: int, out_dim: int, bins=(1, 5),
                 activation: str = "relu", upsampling_mode: str = "nearest"):
        super().__init__()
        red = in_dim // len(bins)
        self.upsampling_mode = upsampling_mode
        self.features = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b),
                          ConvBNAct(in_dim, red, 1, activation=activation))
            for b in bins)
        self.final_conv = ConvBNAct(in_dim + red * len(bins), out_dim, 1,
                                    activation=activation)

    def forward(self, x):
        hw = (x.shape[2], x.shape[3])
        out = [x]
        for f in self.features:
            y = nhwc(f(x))
            out.append(nchw(_upsample_to(y, hw, self.upsampling_mode)))
        return self.final_conv(torch.cat(out, dim=1))


def get_context_module(name: str, channels_in: int, channels_out: int,
                       activation: str = "relu",
                       upsampling_mode: str = "bilinear"):
    """The PPM context module for ``ppm`` (bins 1, 5) or ``ppm-1-2-4-8``."""
    if "ppm" not in name or "appm" in name:
        raise NotImplementedError(
            f"context module {name!r} is not ported yet (ppm is)")
    bins = (1, 2, 4, 8) if name.endswith("1-2-4-8") else (1, 5)
    return PyramidPoolingModule(channels_in, channels_out, bins=bins,
                                activation=activation,
                                upsampling_mode=upsampling_mode)
