"""Conv / norm / squeeze-excite / upsample building blocks (port of
``dynmm_tpu/nn/layers.py``).

Modules take NCHW tensors held in ``torch.channels_last`` memory; public
functions (``resize_nearest``, ``resize_bilinear``, ``first_argmax``) keep
the JAX package's NHWC layout. Parameter names follow the reference's torch
modules, so state_dicts converted from flax load with ``strict=True``.

Modules whose weights a kernel takes in another layout (SE MLPs, learned
upsample taps, NonBottleneck1D taps and folded BN) derive those copies once,
in ``repack``, which runs after construction and after every
``load_state_dict`` (``Packed``); an eval forward never repacks. In training
(``module.training``) they read their parameters themselves, so gradients
reach them; after optimizer steps, ``pack_weights`` rebuilds the copies
before the next eval forward.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynmm_tpu_torch.kernels.se import se_fuse_mixed, se_fuse_mixed_plain
from dynmm_tpu_torch.kernels.stem_fuse import stem_se_fusion_pool
from dynmm_tpu_torch.kernels.upsample import learned_upsample, learned_upsample_plain

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: the new-statistic fraction


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → contiguous NHWC; free for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def swish(x):
    return x * torch.sigmoid(x)


def hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


_ACTIVATIONS: dict[str, tuple[Callable, type[nn.Module]]] = {
    "relu": (torch.relu, nn.ReLU),
    "swish": (swish, nn.SiLU),
    "silu": (swish, nn.SiLU),
    "hswish": (hswish, nn.Hardswish),
}


def get_activation(name: str) -> Callable:
    """Activation function by the reference's names."""
    try:
        return _ACTIVATIONS[name.lower()][0]
    except KeyError:
        raise NotImplementedError(
            f"Only relu, swish and hswish are supported. Got {name}")


def activation_module(name: str) -> nn.Module:
    get_activation(name)
    return _ACTIVATIONS[name.lower()][1]()


class Packed(nn.Module):
    """A module that keeps kernel-layout copies of its weights as
    non-persistent buffers, rebuilt by ``repack`` after every
    ``load_state_dict`` (and by ``pack_weights`` after an in-place init)."""

    def __init__(self):
        super().__init__()
        self.register_load_state_dict_post_hook(Packed._after_load)

    @staticmethod
    def _after_load(module: "Packed", _keys) -> None:
        # a named function, not a lambda: whole modules stay picklable
        module.repack()

    def repack(self) -> None:
        raise NotImplementedError

    def _set(self, name: str, value: torch.Tensor) -> None:
        self.register_buffer(name, value.detach().contiguous(),
                             persistent=False)


@torch.no_grad()
def pack_weights(model: nn.Module) -> None:
    """Rebuild every kernel-layout weight copy in ``model``."""
    for m in model.modules():
        if isinstance(m, Packed):
            m.repack()


class BatchNorm2d(nn.Module):
    """BatchNorm with torch semantics (unbiased running variance) and the
    reference's names, without ``num_batches_tracked`` (the flax trees
    carry none, so converted state_dicts load strictly)."""

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)


class ConvBNAct(nn.Module):
    """conv (no bias, padding ``k//2 + dilation − 1``) → BN → activation."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 activation: str = "relu", dilation: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride=stride,
                              padding=kernel_size // 2 + dilation - 1,
                              dilation=dilation, bias=False)
        self.bn = BatchNorm2d(c_out)
        self.act = get_activation(activation)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBN(nn.Module):
    """conv → BN without activation."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size,
                              padding=kernel_size // 2, bias=False)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x):
        return self.bn(self.conv(x))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max pool with padding 1 on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


class SqueezeAndExcitation(Packed):
    """global pool → 1×1 reduce → act → 1×1 expand → sigmoid → scale.
    ``weights()`` are the MLP in the JAX layout, w1 (C, C/r), w2 (C/r, C)."""

    def __init__(self, channels: int, reduction: int = 16,
                 activation: str = "relu"):
        super().__init__()
        cr = channels // reduction
        self.fc = nn.Sequential(
            nn.Conv2d(channels, cr, 1), activation_module(activation),
            nn.Conv2d(cr, channels, 1), nn.Sigmoid())
        self.act = get_activation(activation)
        self.repack()

    def _mlp(self):
        return (self.fc[0].weight[:, :, 0, 0].t(),
                self.fc[2].weight[:, :, 0, 0].t())

    def repack(self):
        w1, w2 = self._mlp()
        self._set("w1", w1)
        self._set("w2", w2)

    def weights(self):
        """(w1, b1, w2, b2): the packed copies in eval, the parameters
        themselves in training."""
        w1, w2 = self._mlp() if self.training else (self.w1, self.w2)
        return w1, self.fc[0].bias, w2, self.fc[2].bias

    def scale(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The (B, C) sigmoid recalibration vector of an NHWC map."""
        w1, b1, w2, b2 = self.weights()
        return torch.sigmoid(
            self.act(x_nhwc.mean(dim=(1, 2)) @ w1 + b1) @ w2 + b2)

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3), keepdim=True))


class SqueezeAndExciteFusionAdd(nn.Module):
    """ESANet fusion cell: per-modality SE recalibration, then add."""

    def __init__(self, channels: int, activation: str = "relu"):
        super().__init__()
        self.se_rgb = SqueezeAndExcitation(channels, activation=activation)
        self.se_depth = SqueezeAndExcitation(channels, activation=activation)
        self.relu = activation.lower() == "relu"

    def forward(self, rgb, depth, use_kernels: bool = True):
        """``se(rgb) + se(depth)`` (NCHW), the unmixed fusion of
        ``forward_switch``. With ``use_kernels`` it is the ``se_fuse_mixed``
        cell at w = 0, which is exactly that sum."""
        if not use_kernels:
            return self.se_rgb(rgb) + self.se_depth(depth)
        return self.fuse_mixed(rgb, depth, rgb.new_zeros(rgb.shape[0]))

    def _require_relu(self):
        if not self.relu:
            raise NotImplementedError(
                "the fused SE cells take relu SE MLPs; swish/hswish wait")

    def fuse_mixed(self, rgb, depth, w_rgb, use_kernels: bool = True):
        """``w·rgb + (1−w)·(se(rgb) + se(depth))`` with the per-sample mix
        folded into the SE scale vectors (NCHW in and out; ``w_rgb`` (B,)),
        as the ``se_fuse_mixed`` kernel cell."""
        self._require_relu()
        args = (*self.se_rgb.weights(), *self.se_depth.weights())
        fuse = se_fuse_mixed if use_kernels else se_fuse_mixed_plain
        return nchw(fuse(nhwc(rgb), nhwc(depth), w_rgb.contiguous(), *args))

    def fuse_and_pool(self, rgb, depth, use_kernels: bool = True):
        """Stem tail: (pool(se_fusion_add(rgb, depth)), pool(depth)), NCHW,
        as the ``channel_sums`` + ``stem_fuse_pool`` kernel cell."""
        self._require_relu()
        fused, dpool = stem_se_fusion_pool(
            nhwc(rgb), nhwc(depth), *self.se_rgb.weights(),
            *self.se_depth.weights(), use_kernels=use_kernels)
        return nchw(fused), nchw(dpool)


def _bilinear_3x3_kernel(channels: int) -> torch.Tensor:
    """Depthwise (C, 1, 3, 3) kernel that mimics ×2 bilinear upsampling
    after a nearest upscale (the reference's learned-upsample init)."""
    k = torch.tensor([[0.0625, 0.1250, 0.0625],
                      [0.1250, 0.2500, 0.1250],
                      [0.0625, 0.1250, 0.0625]])
    return k.expand(channels, 1, 3, 3).clone()


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NHWC with the exact integer source index
    ``(i·in)//out`` (torch 'nearest'; ``F.interpolate`` computes a float
    scale and can pick other cells at non-integer ratios such as PPM's
    5×5 → 15×20)."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    idx_h = (torch.arange(oh, device=x.device) * h) // oh
    idx_w = (torch.arange(ow, device=x.device) * w) // ow
    return x[:, idx_h][:, :, idx_w]


def resize_nearest_centers(x: torch.Tensor, out_hw: tuple[int, int]
                           ) -> torch.Tensor:
    """Nearest resize of (B, H, W, ...) sampled at pixel centres, as
    ``jax.image.resize(..., "nearest")``: source index ⌊(i + 0.5)·in/out⌋,
    computed in float32 in the same order (torch's 'nearest-exact', not the
    floor indexing of ``resize_nearest``; the two agree only at integer
    ratios: 5 → 7 gives [0 1 1 2 3 3 4] here, [0 0 1 2 2 3 4] there)."""
    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5
        return (pos * n_in / n_out).floor().long()

    (h, w), (oh, ow) = x.shape[1:3], out_hw
    if oh != h:
        x = x[:, index(h, oh)]
    if ow != w:
        x = x[:, :, index(w, ow)]
    return x


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC, torch ``align_corners=False``."""
    y = F.interpolate(nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (int32), ties to the first
    index as ``torch.argmax`` and the reference's post-processing."""
    c = x.shape[dim]
    m = x.amax(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = c
    iota = torch.arange(c, device=x.device, dtype=torch.int32).reshape(shape)
    sentinel = torch.full((), c, device=x.device, dtype=torch.int32)
    return torch.where(x >= m, iota, sentinel).amin(dim=dim)


class Upsample(Packed):
    """×2 upsampling: 'nearest' | 'bilinear' | 'learned-3x3' |
    'learned-3x3-zeropad'. The learned modes are nearest ×2 then a depthwise
    3×3 conv ('learned-3x3' replication-pads, '-zeropad' zero-pads); the
    zeropad mode is the ``learned_upsample`` kernel."""

    def __init__(self, mode: str, channels: int | None = None):
        super().__init__()
        self.mode = mode
        if mode not in ("nearest", "bilinear", "learned-3x3",
                        "learned-3x3-zeropad"):
            raise NotImplementedError(f"Unknown upsampling mode {mode}")
        if "learned-3x3" in mode:
            self.conv = nn.Conv2d(channels, channels, 3, groups=channels)
            with torch.no_grad():
                self.conv.weight.copy_(_bilinear_3x3_kernel(channels))
                self.conv.bias.zero_()
            self.repack()

    def _taps(self):
        return self.conv.weight[:, 0].permute(1, 2, 0)

    def repack(self):
        if "learned-3x3" in self.mode:
            self._set("taps", self._taps())

    def forward(self, x, use_kernels: bool = True):
        h, w = x.shape[2] * 2, x.shape[3] * 2
        if self.mode == "learned-3x3-zeropad":
            up = learned_upsample if use_kernels else learned_upsample_plain
            taps = self._taps() if self.training else self.taps
            return nchw(up(nhwc(x), taps, self.conv.bias))
        if self.mode == "learned-3x3":
            x = nchw(resize_nearest(nhwc(x), (h, w)))
            return self.conv(F.pad(x, (1, 1, 1, 1), mode="replicate"))
        if self.mode == "nearest":
            return nchw(resize_nearest(nhwc(x), (h, w)))
        return nchw(resize_bilinear(nhwc(x), (h, w)))
