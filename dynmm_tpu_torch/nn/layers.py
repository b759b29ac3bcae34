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

Compute dtype (``set_compute_dtype``): parameters stay fp32, and a model in
bf16 serves bf16 maps, as the JAX modules' ``dtype`` field ("compute
dtype, params stay float32"). Its ``Conv2d``s convolve with bf16 copies of
their weight and bias, its ``Upsample``s take bf16 taps, both made once in
``repack``, never per call; BN takes the bf16 map with the fp32 statistics
and writes bf16, as flax's BN at ``dtype=bf16``. Every module computes in
the dtype of the map it is given: the stems cast the fp32 images to the
model's dtype, and the global gate casts back to fp32.

A bf16 model trains too, rounding where the JAX model at ``dtype=bf16``
rounds (not ``torch.autocast``, which keeps BN and ``log_softmax`` outputs
in fp32): each call casts the fp32 parameters to bf16 (a differentiable
cast, so their gradients are fp32) where the copies serve eval; a conv's
sum is rounded before its bias is added; BN computes its statistics in
fp32 and writes bf16; the SE MLPs run on bf16 weights as the JAX module's
do (in eval the port keeps the Pallas ``fused_se``'s fp32 MLP weights);
bf16 sigmoids round as XLA rounds ``jax.nn.sigmoid``
(``kernels/se.py::sigmoid``). ``pack_weights`` refreshes the eval copies
from the trained parameters.

Activations (``get_activation``): relu, swish (alias silu) and hswish;
a bf16 map takes the JAX package's formulas op by op, so it rounds where
XLA rounds it. The SE kernels compute a relu MLP, as the TPU kernels do:
a swish or hswish SE cell computes its recalibration in PyTorch ops
(``SqueezeAndExcitation.scaled``, ``SqueezeAndExciteFusionAdd.fuse_mixed``),
and its stem cell keeps ``channel_sums`` and ``stem_fuse_pool`` around an
MLP on its activation.

int8 (``Conv2d(quant=...)``, ``nn/quant.py``): a quantized conv quantizes
its input with its calibrated scale and convolves int8 with int8, exact in
int32, then dequantizes in fp32 and casts to the map's dtype; every other
module keeps its float path, so the maps between convs stay fp32 or bf16.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynmm_tpu_torch.core.gates import draw_rows, gumbel_softmax
from dynmm_tpu_torch.kernels.se import (channel_sums, channel_sums_plain,
                                        fused_se, map_scale, se_fuse_mixed,
                                        se_fuse_mixed_plain, se_reference,
                                        sigmoid)
from dynmm_tpu_torch.kernels.stem_fuse import stem_se_fusion_pool
from dynmm_tpu_torch.kernels.upsample import learned_upsample, learned_upsample_plain
from dynmm_tpu_torch.parallel.collectives import (copy_to_group,
                                                  gather_slices,
                                                  sync_batch_norm)
from dynmm_tpu_torch.nn.quant import (CALIB_PERCENTILES, QUANT_MODES,
                                      conv_int8_gemm, gemm_weight, observe,
                                      quantize_symmetric, quantize_weight)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: the new-statistic fraction


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → contiguous NHWC; free for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def swish(x):
    """``x · sigmoid(x)``. A bf16 map takes the JAX formula op by op, each
    step rounded to bf16, as XLA computes it (its bf16 logistic rounds
    ``exp``, the ``1 +`` and the division; ``F.silu`` rounds once and
    lands one bf16 step away on a third of the inputs). Wider maps take
    ``F.silu``: one pass, and only ``x`` kept for the gradient, where the
    formula's two ops keep ``sigmoid(x)`` too; it is the formula within an
    fp32 rounding."""
    if x.dtype == torch.bfloat16:
        return x * (1.0 / (1.0 + torch.exp(-x)))
    return F.silu(x)


def hswish(x):
    """``x · relu6(x + 3) / 6``: op by op for a bf16 map, as XLA computes
    it (``F.hardswish`` rounds once), ``F.hardswish`` otherwise (one pass;
    the formula within an fp32 rounding)."""
    if x.dtype == torch.bfloat16:
        return x * F.relu6(x + 3.0) / 6.0
    return F.hardswish(x)


# the JAX package's table
_ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "swish": swish,
    "silu": swish,
    "hswish": hswish,
}


def activation_name(name: str) -> str:
    """The activation's name as the port keys it: lower case, with
    ``silu`` as ``swish`` (the JAX table's alias); raises on a name the
    JAX package does not know."""
    key = name.lower()
    if key not in _ACTIVATIONS:
        raise NotImplementedError(
            f"Only relu, swish and hswish are supported. Got {name}")
    return "swish" if key == "silu" else key


def get_activation(name: str) -> Callable:
    """Activation function by the reference's names."""
    return _ACTIVATIONS[activation_name(name)]


class Activation(nn.Module):
    """``get_activation(name)`` as a module (the SE MLPs' ``fc[1]``)."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = get_activation(name)

    def forward(self, x):
        return self.fn(x)


def _after_load(module: nn.Module, _keys) -> None:
    # a named function, not a lambda: whole modules stay picklable
    module.repack()


def _set_buffer(module: nn.Module, name: str,
                value: torch.Tensor | None) -> None:
    module.register_buffer(
        name, None if value is None else value.detach().contiguous(),
        persistent=False)


class Packed(nn.Module):
    """A module that keeps kernel-layout copies of its weights as
    non-persistent buffers, rebuilt by ``repack`` after every
    ``load_state_dict`` (and by ``pack_weights`` after an in-place init).
    ``compute_dtype`` (``set_compute_dtype``): the dtype of the maps it
    serves; None is its parameters' dtype."""

    compute_dtype: torch.dtype | None = None

    def __init__(self):
        super().__init__()
        self.register_load_state_dict_post_hook(_after_load)

    def repack(self) -> None:
        raise NotImplementedError

    def _set(self, name: str, value: torch.Tensor | None) -> None:
        _set_buffer(self, name, value)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and names) that computes in its
    input's dtype. In eval, a map of the model's ``compute_dtype`` (bf16)
    convolves with copies of the weight and bias in that dtype, made by
    ``repack`` after construction, every ``load_state_dict`` and
    ``pack_weights``, as flax's ``nn.Conv(dtype=bf16)`` casts its fp32
    parameters. For a map of the parameters' dtype it is ``nn.Conv2d``; in
    training a map of the compute dtype convolves with a per-call cast of
    the parameters, the sum rounded before the bias is added (flax's
    order).

    ``quant`` (``nn/quant.py``; the JAX ``QConv``, ungrouped convs only):
    ``"calib"`` records the input's running abs-max and percentile grid
    over 127 (``in_scale``, ``in_pct``) around the float conv; ``"int8"``
    quantizes the input with ``in_scale``, convolves it with the int8
    weight, exactly in int32, and dequantizes with ``in_scale · w_scale``
    plus the bias, in the map's dtype. The int8 weight is the packed one
    (``pack``, from ``utils/quantize.py::pack_int8``: its GEMM matrix
    ``w_mat`` with ``w_scale``; ``weight_q`` reads it back as OIHW) or,
    unpacked, quantized from the float weight each call. A
    ``load_state_dict`` drops the packed copy of the old weight.

    ``model_shard`` (a ``parallel/mesh.py::Mesh``, set by ``shard_params``
    on a conv whose weight it splits over the mesh's 'model' axis): in
    training the conv computes this rank's slice of the output channels
    from its slice of the weight and gathers the full output over 'model';
    its input's gradient is summed over 'model' and the bias is added
    after the gather, replicated."""

    compute_dtype: torch.dtype | None = None
    model_shard = None

    def __init__(self, *args, quant: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                             f"{quant!r}")
        if quant is not None and self.groups != 1:
            raise ValueError("grouped convs stay float (no quant)")
        self.quant = quant
        if quant is not None:
            _set_buffer(self, "in_scale", torch.zeros(()))
            _set_buffer(self, "in_pct", torch.zeros(len(CALIB_PERCENTILES)))
            self.unpack()
        self.register_load_state_dict_post_hook(_conv_after_load)
        self.repack()

    def pack(self, w_q: torch.Tensor | None,
             w_scale: torch.Tensor | None) -> None:
        """Hold the int8 OIHW weight ``w_q`` as its GEMM matrix (``w_mat``)
        with its per-output-channel scales; None unpacks."""
        _set_buffer(self, "w_mat", None if w_q is None else gemm_weight(w_q))
        _set_buffer(self, "w_scale", w_scale)

    def unpack(self) -> None:
        self.pack(None, None)

    @property
    def weight_q(self) -> torch.Tensor | None:
        """The packed int8 weight as OIHW (a view of ``w_mat``), or None."""
        w = getattr(self, "w_mat", None)
        if w is None:
            return None
        o, c, kh, kw = self.weight.shape
        return w[:o, :kh * kw * c].reshape(o, kh, kw, c).permute(0, 3, 1, 2)

    def repack(self) -> None:
        dt = self.compute_dtype
        cast = (dt is not None and dt != self.weight.dtype
                and self.quant != "int8")
        _set_buffer(self, "weight_c", self.weight.to(dt) if cast else None)
        _set_buffer(self, "bias_c", self.bias.to(dt) if cast
                    and self.bias is not None else None)

    def weights(self, dtype: torch.dtype):
        """(weight, bias) that convolve a map of ``dtype``: the parameters,
        or the model's compute dtype: in eval the copies, in training a cast
        of the parameters per call (differentiable: the gradients reach the
        fp32 parameters in fp32), as flax casts them."""
        if dtype == self.weight.dtype:
            return self.weight, self.bias
        if self.compute_dtype != dtype or (
                not self.training and (self.weight_c is None
                                       or self.weight_c.dtype != dtype)):
            raise TypeError(
                f"a {dtype} map reached a conv of a model in "
                f"{self.compute_dtype or self.weight.dtype}; set the model's "
                "compute dtype (set_compute_dtype)")
        if self.training:
            return self.weight.to(dtype), (None if self.bias is None
                                           else self.bias.to(dtype))
        return self.weight_c, self.bias_c

    def forward(self, x):
        if self.quant == "int8":
            return self.forward_int8(x)
        if self.quant == "calib":
            observe(self.in_scale, self.in_pct, x)
        if self.model_shard is not None and self.training:
            return self.forward_model_shard(x, self.model_shard)
        weight, bias = self.weights(x.dtype)
        if self.training and bias is not None and x.dtype != self.weight.dtype:
            # flax's order at a compute dtype: the sum rounded, then + bias
            return self._conv_forward(x, weight, None) + bias[:, None, None]
        return self._conv_forward(x, weight, bias)

    def forward_model_shard(self, x, mesh):
        """Training under a mesh's 'model' axis: this rank's output channels
        from its weight slice, gathered over 'model'. A grouped conv (the
        depthwise upsample) reads the input channels of its own groups."""
        local = self.parametrizations.weight.original
        group = mesh.model_group
        x = copy_to_group(x, group)
        groups = self.groups // mesh.n_model if self.groups > 1 else 1
        if self.groups > 1:
            c = self.in_channels // self.groups * groups
            x = x.narrow(1, mesh.model_index * c, c)
        w = local if local.dtype == x.dtype else local.to(x.dtype)
        y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation,
                     groups)
        y = gather_slices(y, group, mesh.model_index, dim=1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y

    def forward_int8(self, x):
        """The int8 conv of an NCHW map: NCHW (channels_last) out, in the
        map's dtype."""
        scale = torch.clamp_min(self.in_scale, 1e-12)
        x_q = quantize_symmetric(nhwc(x), scale)
        if self.w_mat is not None:
            w_mat, s_w = self.w_mat, self.w_scale
        else:
            w_q, s_w = quantize_weight(self.weight)
            w_mat = gemm_weight(w_q)
        acc, (b, ho, wo) = conv_int8_gemm(
            x_q, w_mat, self.out_channels, self.kernel_size, self.stride,
            self.padding, self.dilation)
        # the JAX order: acc · (s_in · s_w), then + bias, in fp32
        y = acc.float() * (scale * s_w)
        if self.bias is not None:
            y = y + self.bias
        return nchw(y.to(x.dtype).reshape(b, ho, wo, -1))


def _conv_after_load(module: Conv2d, _keys) -> None:
    if module.quant is not None:
        module.unpack()
    module.repack()


@torch.no_grad()
def pack_weights(model: nn.Module) -> None:
    """Rebuild every kernel-layout and compute-dtype weight copy in
    ``model``."""
    for m in model.modules():
        if isinstance(m, (Packed, Conv2d)):
            m.repack()


@torch.no_grad()
def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None) -> None:
    """Serve maps of ``dtype`` (None: the parameters' own) with every
    ``Conv2d`` and ``Packed`` module of ``model``: sets their
    ``compute_dtype`` and repacks. Parameters keep their dtype."""
    for m in model.modules():
        if isinstance(m, (Packed, Conv2d)):
            m.compute_dtype = dtype
    pack_weights(model)


class _WideBatchNorm(torch.autograd.Function):
    """Train-mode BN of a map below fp32 (bf16) as the JAX BN computes it:
    the map cast to fp32, fp32 statistics (the running buffers updated in
    place), the output rounded once to the map's dtype; the backward in
    fp32 on the cast, the input gradient rounded once. It keeps the map in
    its own dtype for the backward, not its fp32 cast. ``F.batch_norm``
    on a bf16 map computes the same without the casts, bit for bit, on the
    card for a channels-last map (the model's layout); on a contiguous map
    there it rounds the weight and bias gradients otherwise, and on the
    CPU every gradient (``chip_smoke.py`` phase 17,
    ``tests/test_torch_port_bf16_train.py``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        out, mean, invstd = torch.native_batch_norm(
            x.float(), weight, bias, running_mean, running_var, True,
            momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            g.float(), x.float(), weight, None, None, mean, invstd, True,
            ctx.eps, list(ctx.needs_input_grad[:3]))
        return (None if gx is None else gx.to(x.dtype), gw, gb, None, None,
                None, None)


class BatchNorm2d(nn.Module):
    """BatchNorm with torch semantics (unbiased running variance) and the
    reference's names, without ``num_batches_tracked`` (the flax trees
    carry none, so converted state_dicts load strictly). In training a
    map below fp32 (bf16) takes ``_WideBatchNorm``, the JAX BN's order,
    unless it is a channels-last map on the card, where ``F.batch_norm``
    computes the same. ``sync_group`` (set by ``parallel/mesh.py::
    shard_params`` under a mesh whose 'data' axis has several ranks): the
    train-mode statistics are the global batch's, summed over the group
    (``parallel/collectives.py::sync_batch_norm``)."""

    sync_group = None

    def __init__(self, channels: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training and self.sync_group is not None:
            return sync_batch_norm(x, self.weight, self.bias,
                                   self.running_mean, self.running_var,
                                   self.momentum, self.eps, self.sync_group)
        if (self.training and x.dtype != self.weight.dtype
                and x.dtype.itemsize < 4 and not (
                    x.is_cuda and x.is_contiguous(
                        memory_format=torch.channels_last))):
            return _WideBatchNorm.apply(x, self.weight, self.bias,
                                        self.running_mean, self.running_var,
                                        self.momentum, self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)


class ConvBNAct(nn.Module):
    """conv (no bias, padding ``k//2 + dilation − 1``) → BN → activation;
    ``quant``: the conv's quant mode."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 activation: str = "relu", dilation: int = 1, stride: int = 1,
                 quant: str | None = None):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, kernel_size, stride=stride,
                           padding=kernel_size // 2 + dilation - 1,
                           dilation=dilation, bias=False, quant=quant)
        self.bn = BatchNorm2d(c_out)
        self.act = get_activation(activation)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvBN(nn.Module):
    """conv → BN without activation."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 quant: str | None = None):
        super().__init__()
        self.conv = Conv2d(c_in, c_out, kernel_size,
                           padding=kernel_size // 2, bias=False, quant=quant)
        self.bn = BatchNorm2d(c_out)

    def forward(self, x):
        return self.bn(self.conv(x))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 max pool with padding 1 on NCHW."""
    return F.max_pool2d(x, 3, 2, 1)


class SqueezeAndExcitation(Packed):
    """global pool → 1×1 reduce → act → 1×1 expand → sigmoid → scale.
    ``weights()`` are the MLP in the JAX layout, w1 (C, C/r), w2 (C/r, C).

    The single-map SE kernel (``fused_se``) computes a relu MLP, as the
    TPU kernel does; a swish or hswish cell computes ``x · se(x)`` in
    PyTorch ops (``scaled``), decided when the module is built."""

    def __init__(self, channels: int, reduction: int = 16,
                 activation: str = "relu"):
        super().__init__()
        cr = channels // reduction
        self.fc = nn.Sequential(
            nn.Conv2d(channels, cr, 1), Activation(activation),
            nn.Conv2d(cr, channels, 1), nn.Sigmoid())
        self.act = get_activation(activation)
        self.relu = activation_name(activation) == "relu"
        self.repack()

    def _mlp(self):
        return (self.fc[0].weight[:, :, 0, 0].t(),
                self.fc[2].weight[:, :, 0, 0].t())

    def repack(self):
        w1, w2 = self._mlp()
        self._set("w1", w1)
        self._set("w2", w2)

    def weights(self, dtype: torch.dtype):
        """(w1, b1, w2, b2) for a map of ``dtype``: the packed fp32 copies
        in eval, as the Pallas ``fused_se`` takes them whatever the map's
        dtype; the parameters themselves in training, cast to the map's
        dtype (bf16) as the JAX module casts them."""
        if not self.training:
            return self.w1, self.fc[0].bias, self.w2, self.fc[2].bias
        w1, w2 = self._mlp()
        return tuple(t.to(dtype) for t in (w1, self.fc[0].bias, w2,
                                           self.fc[2].bias))

    def map_scale(self, x: torch.Tensor) -> torch.Tensor:
        """The (B, C) scale of an NCHW map in the map's dtype, rounded as
        the fused cells round it (``kernels/se.py::map_scale``), on this
        cell's activation."""
        return map_scale(x, *self.weights(x.dtype), dims=(2, 3),
                         act=self.act)

    def scaled(self, x: torch.Tensor) -> torch.Tensor:
        """``x · se(x)`` (NCHW) in PyTorch ops, rounded as the fused cells
        round it."""
        return x * self.map_scale(x)[:, :, None, None]

    def forward(self, x):
        if x.dtype == self.fc[0].weight.dtype:
            return x * self.fc(x.mean(dim=(2, 3), keepdim=True))
        # a map of the model's compute dtype: the fused cells' rounding
        return self.scaled(x)

    def recalibrate(self, x, use_kernels: bool = True):
        """``x · se(x)`` (NCHW) as the single-map ``fused_se`` cell (its
        plain version ``se_reference`` without ``use_kernels``), fp32 or
        bf16; at bf16 it rounds as ``map_scale`` does. A swish or hswish
        cell takes ``scaled`` either way."""
        if not self.relu:
            return self.scaled(x)
        b, c, h, w = x.shape
        fn = fused_se if use_kernels else se_reference
        y = fn(nhwc(x).reshape(b, h * w, c), *self.weights(x.dtype))
        return nchw(y.reshape(b, h, w, c))


class SqueezeAndExcitationWeight(nn.Module):
    """SE recalibration collapsed to a per-sample scalar:
    ``(x · se(x)).mean over (H, W, C)``, computed from the channel means
    ``m`` as ``mean_c(m · sigmoid(fc(m)))`` (the same value without the
    recalibrated map).

    At a compute dtype below fp32 (bf16) it rounds where the JAX module at
    that ``dtype`` rounds: the means, each 1×1 conv's product and then its
    bias (on the convs' bf16 weight copies), the sigmoid, and the scalar.
    JAX rounds each product ``x·w`` of the map too before its fp32 mean;
    those roundings move the mean by far less than its own bf16 step, and
    here the mean is taken of the fp32 ``m·w``."""

    def __init__(self, channels: int, reduction: int = 16,
                 activation: str = "relu"):
        super().__init__()
        cr = channels // reduction
        self.fc = nn.Sequential(
            Conv2d(channels, cr, 1), Activation(activation),
            Conv2d(cr, channels, 1), nn.Sigmoid())

    def from_means(self, means: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        """The scalar (B,), in ``dtype``, of a map of ``dtype`` whose
        channel means are ``means`` (B, C, at least fp32)."""
        (w1, b1), (w2, b2) = (conv.weights(dtype)
                              for conv in (self.fc[0], self.fc[2]))
        h = self.fc[1](means.to(dtype) @ w1[:, :, 0, 0].t() + b1)
        w = sigmoid(h @ w2[:, :, 0, 0].t() + b2)
        return (means * w.to(means.dtype)).mean(dim=1).to(dtype)


class SqueezeAndExciteReweigh(nn.Module):
    """The local gate of one stage: the SE weight of concat(rgb, depth) →
    sigmoid w → logits [w, 1−w] → Gumbel softmax over ``logits / temp``
    (hard under ``hard`` or ``test``), noise drawn from ``generator``;
    ``random_policy`` draws uniform choices instead. ``prev_weight`` (B,)
    chains the gates: the fuse column becomes ``w_1 · prev_weight``.
    Returns (B, 2) weights ``[rgb only, fuse]`` in the maps' dtype, which
    every step after the channel sums computes in, as the JAX gate does.

    The concatenation is never built: its channel means are those of rgb
    and depth side by side, on the card one ``channel_sums`` launch of both
    maps (C ≤ 1024)."""

    def __init__(self, channels_in: int, activation: str = "relu"):
        super().__init__()
        self.se = SqueezeAndExcitationWeight(2 * channels_in,
                                             activation=activation)

    def forward(self, rgb, depth, generator: torch.Generator,
                temp: float = 1.0, hard: bool = False, prev_weight=None,
                random_policy: bool = False, test: bool = False,
                use_kernels: bool = True):
        bs = rgb.shape[0]
        if random_policy:
            b0 = draw_rows(lambda shape: torch.randint(
                0, 2, shape, generator=generator, device=generator.device),
                (bs,)).to(rgb)
            w_norm = torch.stack([b0, 1.0 - b0], dim=1)
        else:
            sums = channel_sums if use_kernels else channel_sums_plain
            hw = rgb.shape[2] * rgb.shape[3]
            s_r, s_d = sums(nhwc(rgb), nhwc(depth))
            w = sigmoid(self.se.from_means(
                torch.cat([s_r, s_d], 1) / hw, rgb.dtype))
            logits = torch.stack([w, 1.0 - w], dim=1)
            # JAX divides by the temperature rounded to the logits' dtype
            temp = float(torch.tensor(float(temp)).to(logits.dtype))
            w_norm = gumbel_softmax(logits / temp, generator, tau=1.0,
                                    hard=hard or test)
        if prev_weight is not None:
            b1 = w_norm[:, 1] * prev_weight
            w_norm = torch.stack([1.0 - b1, b1], dim=1)
        return w_norm


class SqueezeAndExciteFusionAdd(nn.Module):
    """ESANet fusion cell: per-modality SE recalibration, then add.

    A relu cell runs the ``se_fuse_mixed`` kernel cell (the stem: the
    ``channel_sums`` + ``stem_fuse_pool`` cell). The TPU SE kernel fuses a
    relu MLP, so a swish or hswish cell runs ``fuse_mixed`` in PyTorch ops,
    the JAX module's algebra; its stem keeps both kernels, which have no
    activation, and computes its MLP with the cell's activation."""

    def __init__(self, channels: int, activation: str = "relu"):
        super().__init__()
        self.se_rgb = SqueezeAndExcitation(channels, activation=activation)
        self.se_depth = SqueezeAndExcitation(channels, activation=activation)
        self.relu = self.se_rgb.relu

    def forward(self, rgb, depth, use_kernels: bool = True):
        """``se(rgb) + se(depth)`` (NCHW), the unmixed fusion of
        ``forward_switch``. With ``use_kernels`` it is ``fuse_mixed`` at
        w = 0, which is exactly that sum."""
        if not use_kernels:
            return self.se_rgb(rgb) + self.se_depth(depth)
        return self.fuse_mixed(rgb, depth, rgb.new_zeros(rgb.shape[0]))

    def fuse_mixed(self, rgb, depth, w_rgb, use_kernels: bool = True):
        """``w·rgb + (1−w)·(se(rgb) + se(depth))`` with the per-sample mix
        folded into the SE scale vectors (NCHW in and out; ``w_rgb`` (B,)),
        as the ``se_fuse_mixed`` kernel cell; a swish or hswish cell in
        PyTorch ops, rounding where the kernel cell rounds."""
        if not self.relu:
            s_r = self.se_rgb.map_scale(rgb)
            s_d = self.se_depth.map_scale(depth)
            w = w_rgb[:, None].to(s_r.dtype)
            s_r = w + (1.0 - w) * s_r
            s_d = (1.0 - w) * s_d
            return rgb * s_r[:, :, None, None] + depth * s_d[:, :, None, None]
        args = (*self.se_rgb.weights(rgb.dtype),
                *self.se_depth.weights(rgb.dtype))
        fuse = se_fuse_mixed if use_kernels else se_fuse_mixed_plain
        return nchw(fuse(nhwc(rgb), nhwc(depth), w_rgb.contiguous(), *args))

    def fuse_and_pool(self, rgb, depth, use_kernels: bool = True):
        """Stem tail: (pool(se_fusion_add(rgb, depth)), pool(depth)), NCHW,
        as the ``channel_sums`` + ``stem_fuse_pool`` kernel cell, its SE
        MLP on the cell's activation."""
        fused, dpool = stem_se_fusion_pool(
            nhwc(rgb), nhwc(depth), *self.se_rgb.weights(rgb.dtype),
            *self.se_depth.weights(rgb.dtype), act=self.se_rgb.act,
            use_kernels=use_kernels)
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
            self.conv = Conv2d(channels, channels, 3, groups=channels)
            with torch.no_grad():
                self.conv.weight.copy_(_bilinear_3x3_kernel(channels))
                self.conv.bias.zero_()
            self.repack()

    def _taps(self):
        return self.conv.weight[:, 0].permute(1, 2, 0)

    def repack(self):
        if "learned-3x3" in self.mode:
            self._set("taps", self._taps().to(self.compute_dtype
                                              or self.conv.weight.dtype))

    def forward(self, x, use_kernels: bool = True):
        h, w = x.shape[2] * 2, x.shape[3] * 2
        if self.mode == "learned-3x3-zeropad":
            up = learned_upsample if use_kernels else learned_upsample_plain
            taps = self._taps().to(x.dtype) if self.training else self.taps
            bias = self.conv.weights(x.dtype)[1]
            return nchw(up(nhwc(x), taps, bias))
        if self.mode == "learned-3x3":
            x = nchw(resize_nearest(nhwc(x), (h, w)))
            return self.conv(F.pad(x, (1, 1, 1, 1), mode="replicate"))
        if self.mode == "nearest":
            return nchw(resize_nearest(nhwc(x), (h, w)))
        return nchw(resize_bilinear(nhwc(x), (h, w)))
