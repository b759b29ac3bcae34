"""Staged ResNet encoders with NonBottleneck1D blocks (port of
``dynmm_tpu/models/resnet.py``).

``ResNet.stem`` is the raw 7×7/2 conv + BN + act (the caller max-pools);
``layer1..layer4`` run the four stages. Every stride-1 NonBottleneck1D block
without a downsample runs on packed weights through ``nbt1d_block``: one
``nbt1d_fused`` launch up to ``NBT1D_FUSED_MAX_C`` (64) channels, two
``nbt1d_pair`` launches above; the stride-2 block0s stay plain torch convs.
Modules take NCHW
(channels_last) tensors.

``BasicBlock``, ``Bottleneck`` (resnet50) and the space-to-depth packed stem
are not ported yet.
"""

from __future__ import annotations

import torch.nn as nn

from dynmm_tpu_torch.kernels.nbt1d import fold_bn, nbt1d_block
from dynmm_tpu_torch.nn.layers import (BatchNorm2d, Packed, get_activation,
                                       max_pool_3x3_s2, nchw, nhwc)

RESNET_LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}

NBT1D_BN_EPS = 1e-3


class NonBottleneck1D(Packed):
    """ERFNet factorized residual block: 3×1 → act → 1×3 → BN → act →
    3×1 → act → 1×3 → BN → +identity → act, BN eps 1e-3, convs with bias."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, dilation: int = 1,
                 activation: str = "relu"):
        super().__init__()
        d = dilation
        self.conv3x1_1 = nn.Conv2d(in_planes, planes, (3, 1),
                                   stride=(stride, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(planes, planes, (1, 3),
                                   stride=(1, stride), padding=(0, 1))
        self.bn1 = BatchNorm2d(planes, eps=NBT1D_BN_EPS)
        self.conv3x1_2 = nn.Conv2d(planes, planes, (3, 1), padding=(d, 0),
                                   dilation=(d, 1))
        self.conv1x3_2 = nn.Conv2d(planes, planes, (1, 3), padding=(0, d),
                                   dilation=(1, d))
        self.bn2 = BatchNorm2d(planes, eps=NBT1D_BN_EPS)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride,
                                    bias=False), BatchNorm2d(planes))
            if has_downsample else None)
        self.act = get_activation(activation)
        # the kernel's block: stride 1, identity skip, no dilation, relu
        self.fused = (stride == 1 and not has_downsample and d == 1
                      and in_planes == planes and activation == "relu")
        self.repack()

    def repack(self):
        if not self.fused:
            return
        row = lambda conv: conv.weight[:, :, :, 0].permute(2, 1, 0)
        col = lambda conv: conv.weight[:, :, 0, :].permute(2, 1, 0)
        bn = lambda b: fold_bn(b.weight, b.bias, b.running_mean,
                               b.running_var, NBT1D_BN_EPS)
        s1, t1 = bn(self.bn1)
        s2, t2 = bn(self.bn2)
        for name, value in (("w1", row(self.conv3x1_1)),
                            ("w2", col(self.conv1x3_1)), ("s1", s1),
                            ("t1", t1), ("w3", row(self.conv3x1_2)),
                            ("w4", col(self.conv1x3_2)), ("s2", s2),
                            ("t2", t2)):
            self._set(name, value)

    def packed(self):
        """(w1, b1, w2, b2, s1, t1, w3, b3, w4, b4, s2, t2), the JAX
        ``fused_nbt1d`` parameterization."""
        return (self.w1, self.conv3x1_1.bias, self.w2, self.conv1x3_1.bias,
                self.s1, self.t1, self.w3, self.conv3x1_2.bias, self.w4,
                self.conv1x3_2.bias, self.s2, self.t2)

    def forward(self, x, use_kernels: bool = True):
        if self.fused:
            return nchw(nbt1d_block(nhwc(x), *self.packed(),
                                    use_kernels=use_kernels))
        out = self.act(self.conv3x1_1(x))
        out = self.act(self.bn1(self.conv1x3_1(out)))
        out = self.act(self.conv3x1_2(out))
        out = self.bn2(self.conv1x3_2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


class ResNetStage(nn.ModuleList):
    """One residual stage: ``n_blocks`` blocks, the first with the stride
    and a downsample where the shape changes (torch names ``layerI.J``)."""

    def __init__(self, planes: int, n_blocks: int, stride: int = 1,
                 in_planes: int = 64, activation: str = "relu"):
        needs_ds = stride != 1 or in_planes != planes
        blocks = [NonBottleneck1D(in_planes, planes, stride=stride,
                                  has_downsample=needs_ds,
                                  activation=activation)]
        blocks += [NonBottleneck1D(planes, planes, activation=activation)
                   for _ in range(1, n_blocks)]
        super().__init__(blocks)

    def forward(self, x, use_kernels: bool = True):
        for block in self:
            x = block(x, use_kernels=use_kernels)
        return x


class ResNet(nn.Module):
    """Staged NonBottleneck1D ResNet encoder."""

    def __init__(self, layers, input_channels: int = 3,
                 activation: str = "relu"):
        super().__init__()
        self.conv1 = nn.Conv2d(input_channels, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64)
        self.act = get_activation(activation)
        plan = [(64, 1, 64), (128, 2, 64), (256, 2, 128), (512, 2, 256)]
        for i, ((planes, stride, in_planes), n) in enumerate(zip(plan, layers)):
            setattr(self, f"layer{i + 1}",
                    ResNetStage(planes, n, stride=stride, in_planes=in_planes,
                                activation=activation))

    @property
    def down_channels(self) -> dict[int, int]:
        return {2: 64, 4: 64, 8: 128, 16: 256, 32: 512}

    def stem(self, x):
        """7×7/2 conv (pad 3) + BN + act; the max-pool is the caller's."""
        return self.act(self.bn1(self.conv1(x)))

    def forward(self, x, use_kernels: bool = True):
        x = max_pool_3x3_s2(self.stem(x))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x, use_kernels=use_kernels)
        return x


def make_resnet(name: str, block: str = "NonBottleneck1D",
                input_channels: int = 3, activation: str = "relu") -> ResNet:
    """resnet18 / resnet34 with NonBottleneck1D blocks."""
    if block != "NonBottleneck1D" or name not in RESNET_LAYERS:
        raise NotImplementedError(
            f"{name} with {block} blocks is not ported yet (NonBottleneck1D "
            "resnet18/resnet34 are)")
    return ResNet(RESNET_LAYERS[name], input_channels=input_channels,
                  activation=activation)
