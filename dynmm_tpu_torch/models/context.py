"""Pyramid Pooling context modules (port of ``dynmm_tpu/models/context.py``).

The default ESANet context is ``ppm`` with bins (1, 5) on the 1/32 map
(15×20 at 480×640). ``appm`` scales its bins by the ratio of the map to the
nominal 1/32 size; any other name runs without a context module.
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


class AdaptivePyramidPoolingModule(nn.Module):
    """PPM whose bin sizes scale with the map: bin b pools to
    (b·⌊h/h_inp + 0.5⌋, b·⌊w/w_inp + 0.5⌋), (h_inp, w_inp) the nominal
    ``input_size``. Same parameters and names as the PPM (``features.i.1``
    holds each bin's ConvBNAct; ``features.i.0`` pools nothing and carries
    no weights)."""

    def __init__(self, in_dim: int, out_dim: int, input_size, bins=(1, 5),
                 activation: str = "relu", upsampling_mode: str = "nearest"):
        super().__init__()
        red = in_dim // len(bins)
        self.input_size = tuple(input_size)
        self.bins = tuple(bins)
        self.upsampling_mode = upsampling_mode
        self.features = nn.ModuleList(
            nn.Sequential(nn.Identity(),
                          ConvBNAct(in_dim, red, 1, activation=activation))
            for _ in bins)
        self.final_conv = ConvBNAct(in_dim + red * len(bins), out_dim, 1,
                                    activation=activation)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        mult_h = int(h / self.input_size[0] + 0.5)
        mult_w = int(w / self.input_size[1] + 0.5)
        out = [x]
        for b, f in zip(self.bins, self.features):
            y = f[1](F.adaptive_avg_pool2d(x, (b * mult_h, b * mult_w)))
            out.append(nchw(_upsample_to(nhwc(y), (h, w),
                                         self.upsampling_mode)))
        return self.final_conv(torch.cat(out, dim=1))


def get_context_module(name: str, channels_in: int, channels_out: int,
                       input_size, activation: str = "relu",
                       upsampling_mode: str = "bilinear"):
    """The JAX selector: ``appm`` (APPM), ``ppm``; bins (1, 2, 4, 8) for a
    name ending in ``1-2-4-8``, else (1, 5). Returns ``(module,
    channels_after)``: ``(None, channels_in)`` for any other name."""
    bins = (1, 2, 4, 8) if name.endswith("1-2-4-8") else (1, 5)
    if "appm" in name:
        return AdaptivePyramidPoolingModule(
            channels_in, channels_out, input_size, bins=bins,
            activation=activation,
            upsampling_mode=upsampling_mode), channels_out
    if "ppm" in name:
        return PyramidPoolingModule(
            channels_in, channels_out, bins=bins, activation=activation,
            upsampling_mode=upsampling_mode), channels_out
    return None, channels_in
