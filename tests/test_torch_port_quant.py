"""The port's int8 post-training quantization (``nn/quant.py``,
``utils/quantize.py``, the quantized convs of the segmentation nets)
against the JAX package's (``dynmm_tpu/nn/quant.py``,
``dynmm_tpu/utils/quantize.py``) on the CPU.

* ``weight_scales`` and ``quantize_symmetric``: bit-equal, ties included.
* ``conv_int8`` (int8 im2col times the weight matrix through
  ``int_mm``): equal to a float64 conv of the same int8 operands on
  every conv shape the nets use, with K, N and M padded where the card's
  GEMM needs it, and exact where fp32 is not (sums beyond 2^24).
* One quantized conv against the JAX ``QConv`` on the same input, kernel
  and scale: ``x_q``, ``w_q`` and the int32 sums equal, the output within
  one ulp; in-graph and packed, fp32 and bf16. Its calibration: ``in_scale``
  equal, ``in_pct`` within 1e-6 relative (both compute ``jnp.quantile``'s
  fp32 index arithmetic; the port through ``sort``).
* Small nets (SkipGateESANet on R18-BasicBlock, R34-NonBottleneck1D and
  R50-Bottleneck encoders, the static ESANet; the R34-NonBottleneck1D net
  at bf16 compute too, against the JAX net at bf16), the port's seeded weights
  carried to JAX through the bridge, the JAX calibration loaded into the
  port: every quantized conv given its JAX twin's input in the JAX int8
  forward gives JAX's ``x_q`` and the JAX function's output exactly; the whole
  net has identical gate choices, and logits within 5e-2 relative L2 of
  JAX's (``test_net_int8_matches_jax`` says why not closer: rounding flips
  at quantization boundaries cascade; their count is printed). The port's
  own calibration is within 1e-5
  relative of JAX's (the fp32 forwards round apart by ~1e-6);
  ``select_scales``, ``pack_int8`` and ``quant_sanity`` equal to JAX's
  on the same collection.
* Every serving strategy of the int8 net, fp32 and bf16, equal to the dense
  int8 forward on the same paths (error 0).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynmm_tpu.models.esanet import ESANet as JaxESANet
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.nn import quant as jq
from dynmm_tpu.utils import quantize as jquantize
from dynmm_tpu_torch.models import one_modality, skip_local
from dynmm_tpu_torch.models.esanet import ESANet, ESANetConfig
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.nn import layers, quant
from dynmm_tpu_torch.serve import init_weights, serve
from dynmm_tpu_torch.utils import quantize
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_flax_variables)
from tests._port_variants_setup import fast_jit, one_torch_thread  # noqa: F401
from tests.test_torch_port_routed import MIXED, FixedGate

H = W = 64
B = 2
NET_L2_TOL = 5e-2  # int8 net vs JAX's int8 net, relative L2 of logits
NET_AGREE = 0.95  # and class-map agreement
CALIB_TOL = 1e-5  # the port's own scales vs JAX's, relative
PCT_TOL = 1e-6
BASE = dict(height=H, width=W, num_classes=5, channels_decoder=(32, 32, 16),
            nr_decoder_blocks=(1, 1, 1), fuse_depth_in_rgb_encoder="SE-add",
            context_module="ppm", upsampling="learned-3x3-zeropad")
NETS = {
    "r18-basic": ("gate", dict(encoder_rgb="resnet18",
                               encoder_depth="resnet18",
                               encoder_block="BasicBlock")),
    "r34-nbt1d": ("gate", dict(encoder_rgb="resnet34",
                               encoder_depth="resnet34",
                               encoder_block="NonBottleneck1D")),
    "r50": ("gate", dict(encoder_rgb="resnet50", encoder_depth="resnet50")),
    "static": ("static", dict(encoder_rgb="resnet18",
                              encoder_depth="resnet18",
                              encoder_block="NonBottleneck1D")),
}
# the int8 nets at bf16 compute (the JAX bench's int8 serving dtype):
# calibrated in fp32, as both packages calibrate
BF16_RUNS = {"r34-nbt1d-bf16": "r34-nbt1d", "static-bf16": "static"}


# ------------------------------------------------- scales and quantization
@pytest.mark.parametrize("shape", [(3, 3, 16, 24), (3, 1, 8, 8),
                                   (1, 1, 64, 40)])
def test_weight_scales_and_quantize_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    k = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    k[..., 0] = 0.0  # an all-zero channel: the scale floors at 1e-12
    s_ref = jq.weight_scales(jnp.asarray(k))
    q_ref = jq.quantize_symmetric(jnp.asarray(k), s_ref[None, None, None])
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # OIHW
    w_q, s = quant.quantize_weight(w)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert w_q.dtype == torch.int8
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(q_ref))


def test_quantize_rounds_half_to_even_and_clips_at_127():
    scale = np.float32(0.25)
    x = (np.arange(-300, 301, dtype=np.float32) * 0.5 + 0.25) * scale
    x = np.concatenate([x, np.float32([-1e9, 1e9, 0.0])])
    ref = np.asarray(jq.quantize_symmetric(jnp.asarray(x), scale))
    out = quant.quantize_symmetric(torch.from_numpy(x), torch.tensor(scale))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.min() == -127 and ref.max() == 127


# --------------------------------------------------------------- conv_int8
# (C_in, C_out, kernel, stride, padding, dilation, batch, map): the nets'
# conv shapes (NBt1D 3×1/1×3 and their stride-2 forms, 3×3, 3×3/2, 1×1,
# 1×1/2, conv_out at 37 classes), K not a multiple of 8, dilation, and a
# map of M ≤ 16 rows
CONV_SHAPES = {
    "3x1": (16, 16, (3, 1), 1, (1, 0), 1, 2, (9, 7)),
    "1x3": (16, 16, (1, 3), 1, (0, 1), 1, 2, (9, 7)),
    "3x1/2": (16, 24, (3, 1), (2, 1), (1, 0), 1, 2, (9, 7)),
    "1x3/2": (24, 24, (1, 3), (1, 2), (0, 1), 1, 2, (5, 7)),
    "3x3": (32, 16, 3, 1, 1, 1, 2, (6, 5)),
    "3x3/2": (16, 32, 3, 2, 1, 1, 2, (7, 6)),
    "1x1": (64, 32, 1, 1, 0, 1, 2, (4, 5)),
    "1x1/2": (32, 64, 1, 2, 0, 1, 2, (7, 5)),
    "conv_out-37": (32, 37, 3, 1, 1, 1, 2, (6, 6)),
    "odd-k": (5, 19, 3, 1, 1, 1, 1, (5, 6)),
    "dilated": (8, 8, (3, 1), 1, (2, 0), (2, 1), 2, (8, 4)),
    "m<=16": (16, 8, 3, 1, 1, 1, 1, (2, 2)),
}


@pytest.mark.parametrize("name", list(CONV_SHAPES))
def test_conv_int8_equals_float64_conv(name):
    c_in, c_out, k, stride, pad, dil, b, (h, w) = CONV_SHAPES[name]
    g = torch.Generator().manual_seed(len(name))
    kh, kw = (k, k) if isinstance(k, int) else k
    x_q = torch.randint(-127, 128, (b, c_in, h, w), generator=g,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (c_out, c_in, kh, kw), generator=g,
                        dtype=torch.int8)
    out = quant.conv_int8(x_q, w_q, stride, pad, dil)
    ref = F.conv2d(x_q.double(), w_q.double(), stride=stride, padding=pad,
                   dilation=dil)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref.numpy().astype(np.int64))


def test_conv_int8_exact_beyond_fp32():
    """The decoder's 3×3 over 512 channels: 4608 products of 127² sum to
    74322432 > 2^24, exact in int32, not in a float conv."""
    x_q = torch.full((1, 512, 5, 5), 127, dtype=torch.int8)
    w_q = torch.full((8, 512, 3, 3), 127, dtype=torch.int8)
    w_q[1] = -127
    x_q[0, 0, 2, 2] = 126  # one unit below: a sum fp32 cannot hold
    out = quant.conv_int8(x_q, w_q, 1, 1)
    assert out[0, 0, 2, 2].item() == 4608 * 127 * 127 - 127
    assert out[0, 1, 2, 2].item() == -(4608 * 127 * 127 - 127)
    f32 = F.conv2d(x_q.float(), w_q.float(), padding=1)[0, 0, 2, 2]
    assert int(f32.item()) != 4608 * 127 * 127 - 127


# ------------------------------------------------- one conv against QConv
def _conv_pair(rng, c_in=24, c_out=16, k=(3, 3), stride=(2, 2), pad=1,
               bias=True):
    kernel = (rng.standard_normal((*k, c_in, c_out)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    jconv = jq.QConv(features=c_out, kernel_size=k, strides=stride,
                     padding=((pad, pad), (pad, pad)), use_bias=bias,
                     quant="int8")
    conv = layers.Conv2d(c_in, c_out, k, stride=stride, padding=pad,
                         bias=bias, quant="int8").eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(b)
    return jconv, conv, params


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["in-graph", "packed"])
def test_qconv_int8_matches_jax(dtype, packed):
    rng = np.random.default_rng(5)
    jdt, tdt = ((None, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jconv, conv, params = _conv_pair(rng)
    jconv = jconv.clone(dtype=jdt)
    x = torch.from_numpy(rng.standard_normal((2, 11, 10, 24)).astype(
        np.float32)).to(tdt)
    s_in = np.float32(np.abs(x.float().numpy()).max() / 127.0 * 0.9)
    variables = {"params": params, "quant": {"in_scale": jnp.float32(s_in)}}
    if packed:
        variables = jquantize.pack_weights(variables)
    x_j = jnp.asarray(x.float().numpy()).astype(jdt or jnp.float32)
    ref = jconv.apply(variables, x_j)
    # the JAX operands and int32 sums, by its own functions
    xq_ref = jq.quantize_symmetric(x_j, jnp.maximum(s_in, 1e-12))
    s_w = jq.weight_scales(params["kernel"])
    wq_ref = jq.quantize_symmetric(params["kernel"], s_w[None, None, None])
    acc_ref = jax.lax.conv_general_dilated(
        xq_ref, wq_ref, (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)

    conv.in_scale.fill_(float(s_in))
    if dtype == "bf16":
        layers.set_compute_dtype(conv, torch.bfloat16)
    if packed:
        quantize.pack_int8(conv)
        np.testing.assert_array_equal(
            conv.weight_q.numpy().transpose(2, 3, 1, 0),
            np.asarray(variables["params"]["kernel"]))
        np.testing.assert_array_equal(
            conv.w_scale.numpy(), np.asarray(variables["quant"]["w_scale"]))
    x_nchw = x.permute(0, 3, 1, 2)
    x_q = quant.quantize_symmetric(x_nchw, conv.in_scale)
    w_q, _ = quant.quantize_weight(conv.weight)
    np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(xq_ref))
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(wq_ref))
    acc = quant.conv_int8(x_q, w_q, 2, 1)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc_ref))
    with torch.no_grad():
        out = conv(x_nchw).permute(0, 2, 3, 1)
    assert out.dtype == tdt and ref.dtype == (jdt or jnp.float32)
    if dtype == "fp32":
        np.testing.assert_array_max_ulp(out.numpy(), np.asarray(ref), 1)
    else:  # one bf16 step: adjacent bit patterns
        a = out.contiguous().view(torch.int16).numpy().astype(np.int32)
        r = np.asarray(ref).view(np.int16).astype(np.int32)
        assert np.abs(a - r).max() <= 1


@pytest.mark.parametrize("n", [(2, 16, 16, 8), (4, 64, 64, 67)],
                         ids=["small", "large"])
def test_calibration_matches_jax(n):
    """Two batches (running maxima); ``large`` has 1.1e6 elements, where
    the fp32 quantile index ``q·(n − 1)`` rounds."""
    rng = np.random.default_rng(7)
    c = n[-1]
    jconv = jq.QConv(features=8, kernel_size=(1, 1), padding=((0, 0), (0, 0)),
                     quant="calib")
    kernel = jnp.asarray(rng.standard_normal((1, 1, c, 8)), jnp.float32)
    variables = {"params": {"kernel": kernel, "bias": jnp.zeros(8)},
                 "quant": {"in_scale": jnp.float32(0.0),
                           "in_pct": jnp.zeros(3, jnp.float32)}}
    conv = layers.Conv2d(c, 8, 1, quant="calib")
    for scale in (1.0, 1.7):
        x = (rng.standard_normal(n) * scale).astype(np.float32)
        x[0, 0, 0, 0] = 9.0 * scale  # an outlier above the percentiles
        _, mut = jconv.apply(variables, jnp.asarray(x), mutable=["quant"])
        variables = {**variables, **mut}
        with torch.no_grad():
            conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = variables["quant"]
    assert conv.in_scale.item() == float(ref["in_scale"])
    np.testing.assert_allclose(conv.in_pct.numpy(), np.asarray(ref["in_pct"]),
                               rtol=PCT_TOL, atol=0)
    assert np.all(np.diff(conv.in_pct.numpy()) >= 0)


@pytest.mark.parametrize("estimator, percentile", [
    ("absmax", 99.9), ("percentile", 99.0), ("percentile", 99.9),
    ("percentile", 99.99)])
def test_select_scales_matches_jax(estimator, percentile):
    rng = np.random.default_rng(3)
    conv = layers.Conv2d(4, 4, 3, padding=1, quant="calib")
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    conv.quant = "int8"
    coll = {"c": {"in_scale": jnp.float32(conv.in_scale.item()),
                  "in_pct": jnp.asarray(conv.in_pct.numpy())}}
    ref = jquantize.select_scales(coll, estimator, percentile)
    quantize.select_scales(conv, estimator, percentile)
    assert conv.in_scale.item() == float(ref["c"]["in_scale"])


@pytest.mark.parametrize("estimator, percentile", [
    ("entropy", 99.9), ("percentile", 95.0)], ids=["estimator", "percentile"])
def test_select_scales_errors_as_jax(estimator, percentile):
    conv = layers.Conv2d(4, 4, 1, quant="int8")
    coll = {"c": {"in_scale": jnp.float32(1.0), "in_pct": jnp.ones(3)}}
    with pytest.raises(ValueError) as want:
        jquantize.select_scales(coll, estimator, percentile)
    with pytest.raises(ValueError) as got:
        quantize.select_scales(conv, estimator, percentile)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the nets
def _port_net(name: str, mode="int8", dtype=None, cls=None):
    kind, over = NETS[name]
    cfg = ESANetConfig(**BASE, **over, quant=mode, dtype=dtype)
    cls = cls or (SkipGateESANet if kind == "gate" else ESANet)
    return cls(cfg).eval()


def _jax_net(name: str, mode: str, dtype=None):
    kind, over = NETS[name]
    cls = JaxSkipGate if kind == "gate" else JaxESANet
    return cls(JaxConfig(**BASE, **over, quant=mode, dtype=dtype))


def _net_dtype(run_name: str):
    """(net name, port compute dtype) of a ``nets`` run."""
    if run_name in BF16_RUNS:
        return BF16_RUNS[run_name], torch.bfloat16
    return run_name, None


def _apply_kw(name: str) -> dict:
    return dict(hard=True) if NETS[name][0] == "gate" else {}


def _capture_convs(next_fun, args, kwargs, context):
    """Interceptor: sow each ``QConv``'s input and output into
    ``intermediates``."""
    y = next_fun(*args, **kwargs)
    if isinstance(context.module, jq.QConv) and \
            context.method_name == "__call__":
        context.module.sow("intermediates", "x_in", args[0])
        context.module.sow("intermediates", "y_out", y)
    return y


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _run_net(name: str, fp32_run=None) -> dict:
    """The port net's seeded weights, JAX's calibration of them and JAX's
    int8 logits (with gate weights and each QConv's input). With
    ``fp32_run`` (a bf16 run): its inputs, weights and calibration, and the
    JAX int8 net at bf16 compute."""
    rng = np.random.default_rng(sum(map(ord, name)))
    rgb = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    depth = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    model = _port_net(name)
    init_weights(model, torch.Generator().manual_seed(1))
    variables = flax_variables(model)  # with the zero quant collection
    kw = _apply_kw(name)
    if fp32_run is None:
        jc, jm = _jax_net(name, "calib"), _jax_net(name, "int8")
        calib = fast_jit(lambda v, r, d: jc.apply(
            v, r, d, train=False, mutable=["quant"], **kw)[1]["quant"])
        qcoll = jax.tree_util.tree_map(np.asarray,
                                       calib(variables, rgb, depth))
    else:
        jm = _jax_net(name, "int8", jnp.bfloat16)
        qcoll = fp32_run["quant"]

    def fwd(v, r, d):
        with fnn.intercept_methods(_capture_convs):
            out, st = jm.apply(v, r, d, train=False, mutable=["intermediates"],
                               **(dict(kw, return_weight=True) if kw else {}))
        return out, st["intermediates"]

    out, inter = fast_jit(fwd)({**variables, "quant": qcoll}, rgb, depth)
    logits, weight = out if kw else (out, None)
    return {"model": model, "variables": variables, "quant": qcoll,
            "rgb": rgb, "depth": depth,
            "logits": np.asarray(logits.astype(jnp.float32)),
            "weight": None if weight is None else np.asarray(weight),
            "convs": {p[:-1]: (np.array(_at(inter, p[:-1])["x_in"][0]),
                               np.array(v[0]))
                      for p, v in _paths(inter) if p[-1] == "y_out"}}


@pytest.fixture(scope="module")
def nets():
    cache = {}

    def get(name):
        if name not in cache:
            net, dtype = _net_dtype(name)
            cache[name] = (_run_net(net) if dtype is None
                           else _run_net(net, get(net)))
        return cache[name]

    return get


def _forward(model, run, name):
    rgb, depth = torch.from_numpy(run["rgb"]), torch.from_numpy(run["depth"])
    with torch.no_grad():
        if NETS[name][0] == "gate":
            return model(rgb, depth, hard=True, return_weight=True)
        return model(rgb, depth), None


@pytest.mark.parametrize("name", [*NETS, *BF16_RUNS])
def test_net_convs_exact_on_jax_inputs(nets, name):
    """Every quantized conv of the net, given the input its JAX twin saw in
    the JAX int8 forward: ``x_q`` equal to JAX's ``quantize_symmetric`` of
    it, and the output bit-equal to the JAX order of operations in fp32,
    ``f32(acc) · (in_scale · w_scale) + bias``, on the exact int32 sums
    (from a float64 conv of the int8 operands), cast to the map's dtype
    (bf16 in the bf16 net). The JAX net's own outputs are counted against
    the same function: the compiled JAX net quantizes inside fusions that
    round apart from the op-by-op functions (a jitted ``pack_weights``
    already differs from the eager one in a weight)."""
    run = nets(name)
    net, dtype = _net_dtype(name)
    model = _port_net(net, dtype=dtype)
    load_flax_variables(model, {**run["variables"], "quant": run["quant"]})
    by_path = dict(_port_paths(model))
    assert by_path.keys() == run["convs"].keys()
    jax_off = 0
    for path, (x_j, y_j) in run["convs"].items():
        conv = model.get_submodule(by_path[path])
        s = np.maximum(_at(run["quant"], path)["in_scale"], 1e-12)
        x = _torch(x_j).permute(0, 3, 1, 2)
        assert x.dtype == (dtype or torch.float32)
        x_q = quant.quantize_symmetric(x, conv.in_scale.clamp_min(1e-12))
        np.testing.assert_array_equal(
            x_q.permute(0, 2, 3, 1).numpy(),
            np.asarray(jq.quantize_symmetric(jnp.asarray(x_j), s)))
        w_q, s_w = quant.quantize_weight(conv.weight.detach())
        acc = F.conv2d(x_q.double(), w_q.double(), stride=conv.stride,
                       padding=conv.padding, dilation=conv.dilation)
        ref = acc.permute(0, 2, 3, 1).numpy().astype(np.float32) * (
            np.float32(s) * s_w.numpy())
        if conv.bias is not None:
            ref = ref + conv.bias.detach().numpy()
        ref = torch.from_numpy(ref).to(x.dtype).float().numpy()
        with torch.no_grad():
            y = conv(x).permute(0, 2, 3, 1)
        assert y.dtype == x.dtype
        y = y.float().numpy()
        np.testing.assert_array_equal(y, ref)
        y_j = np.asarray(y_j, np.float32)
        jax_off += int((np.abs(y_j - ref) > 1e-5 * np.abs(ref).max()).any())
    print(f"{name}: {len(by_path)} convs exact; the JAX net's own output is "
          f"more than 1e-5 of its max away from that function of its "
          f"captured input in {jax_off} convs")


@pytest.mark.parametrize("name", [*NETS, *BF16_RUNS])
def test_net_int8_matches_jax(nets, name):
    """The whole int8 net against JAX's on the same weights and scales.
    The float ops between the convs round apart by ~1e-7 relative; an input
    that lands within that of a rounding boundary quantizes one step apart
    (``x_q`` flips, printed), which moves that conv's outputs by one
    quantization step, and the flips cascade through later convs. So the
    logits differ by about the int8 error itself (measured 0.6-1.9 % in
    relative L2): the gates are identical, the relative L2 error below 5e-2,
    the class maps agree on > 95 % of pixels and on every pixel whose JAX
    top-two margin exceeds twice the max logit error. At bf16 compute
    against the JAX net at ``dtype=bfloat16``, on the same fp32 scales."""
    run = nets(name)
    net, dtype = _net_dtype(name)
    model = _port_net(net, dtype=dtype)
    load_flax_variables(model, {**run["variables"], "quant": run["quant"]})
    inputs = {}
    hooks = [conv.register_forward_pre_hook(
        lambda m, args, n=n: inputs.__setitem__(n, args[0]))
        for n, conv in quantize.quant_convs(model)]
    quant.INT8_CONVS.clear()
    logits, weight = _forward(model, run, net)
    for h in hooks:
        h.remove()
    assert logits.dtype == (dtype or torch.float32)
    n_convs = len(quantize.quant_convs(model))
    assert quant.INT8_CONVS["cpu"] == n_convs == len(run["convs"])
    assert quantize.quant_sanity(model) == jquantize.quant_sanity(
        run["quant"]) == n_convs
    flips = total = 0
    by_path = dict(_port_paths(model))
    for path, (x_j, _) in run["convs"].items():
        conv = model.get_submodule(by_path[path])
        s = np.maximum(_at(run["quant"], path)["in_scale"], 1e-12)
        # the port's quantize_symmetric is JAX's, bit for bit (above)
        xq_j = quant.quantize_symmetric(_torch(x_j), torch.tensor(s)).numpy()
        xq_p = quant.quantize_symmetric(inputs[by_path[path]],
                                        conv.in_scale.clamp_min(1e-12))
        flips += int((xq_p.permute(0, 2, 3, 1).numpy() != xq_j).sum())
        total += xq_j.size
    out, ref = logits.float().numpy(), run["logits"]
    err = float(np.abs(out - ref).max())
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    agree = float((out.argmax(-1) == ref.argmax(-1)).mean())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * err
    print(f"{name}: {n_convs} int8 convs; x_q differs from JAX's in {flips} "
          f"of {total} elements; logits max abs err {err:.3g} "
          f"({err / np.abs(ref).max():.3g} of max |JAX int8|), relative L2 "
          f"{rel:.3g}; class maps agree on {agree * 100:.2f} %, "
          f"{sure.mean() * 100:.1f} % of pixels have margin > 2x{err:.3g}")
    assert rel < NET_L2_TOL and agree > NET_AGREE
    np.testing.assert_array_equal(out.argmax(-1)[sure], ref.argmax(-1)[sure])
    if weight is not None:
        np.testing.assert_array_equal(weight.numpy(), run["weight"])


def _torch(x: np.ndarray) -> torch.Tensor:
    """A captured JAX map as a torch tensor of its dtype (bf16 included)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(x)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_paths(model):
    from dynmm_tpu_torch.utils.weights import flax_leaf

    for n, _ in quantize.quant_convs(model):
        yield flax_leaf(f"{n}.weight", 4)[0][:-1], n


def _flat(tree) -> dict:
    return {p: np.asarray(v) for p, v in _paths(tree)}


@pytest.mark.parametrize("name", list(NETS))
def test_net_calibration_matches_jax(nets, name):
    """The port's own calibration (its fp32 forward) against JAX's; then
    ``select_scales`` on JAX's collection equal to JAX's."""
    run = nets(name)
    model = _port_net(name)
    load_flax_variables(model, run["variables"])
    n = quantize.calibrate(model, [(torch.from_numpy(run["rgb"]),
                                    torch.from_numpy(run["depth"]))],
                           **_apply_kw(name))
    assert n == 1 and all(c.quant == "int8"
                          for _, c in quantize.quant_convs(model))
    got, want = _flat(flax_variables(model)["quant"]), _flat(run["quant"])
    assert got.keys() == want.keys()
    worst = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                for k in want)
    print(f"{name}: port calibration vs JAX's, max relative diff {worst:.3g}")
    assert worst <= CALIB_TOL
    load_flax_variables(model, {**run["variables"], "quant": run["quant"]})
    quantize.select_scales(model, "percentile", 99.9)
    ref = jquantize.select_scales(run["quant"], "percentile", 99.9)
    got, want = _flat(flax_variables(model)["quant"]), _flat(ref)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["r34-nbt1d", "static"])
def test_net_pack_weights_matches_jax(nets, name):
    """Packing: the port's packed tree equals JAX's ``pack_weights`` of the
    same collection (int8 kernels, ``w_scale``), the packed forward equals
    the in-graph one (error 0), packing is idempotent, and JAX's packed
    tree loaded through the bridge serves the same logits."""
    run = nets(name)
    v = {**run["variables"], "quant": run["quant"]}
    model = _port_net(name)
    load_flax_variables(model, v)
    ingraph, _ = _forward(model, run, name)
    quantize.pack_int8(model)
    quantize.pack_int8(model)
    packed, _ = _forward(model, run, name)
    torch.testing.assert_close(packed, ingraph, rtol=0, atol=0)
    ref = jquantize.pack_weights(v)  # eager, as eval.py and predict.py
    got = flax_variables(model)
    for coll in ("params", "quant"):
        g, w = _flat(got[coll]), _flat(ref[coll])
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    fresh = _port_net(name)
    load_flax_variables(fresh, jax.tree_util.tree_map(np.asarray, ref))
    assert all(c.weight_q is not None for _, c in quantize.quant_convs(fresh))
    loaded, _ = _forward(fresh, run, name)
    torch.testing.assert_close(loaded, ingraph, rtol=0, atol=0)


# ------------------------------------------- strategies, buffers, raises
ROUTED = {
    "batchmax": ("batchmax", {}),
    "compact": ("compact", {}),
    "compact-per-stage": ("compact", {"caps": ((8,), (4, 8), (2, 8),
                                               (1, 8))}),
    "compact-strict": ("compact", {"caps": ((6,), (4,), (2,), (1,)),
                                   "strict_caps": True}),
    "low-res": ("batchmax", {"low_res": True}),
}


@pytest.fixture(scope="module")
def routed_nets(nets):
    run = nets("r34-nbt1d")
    out = {}
    for dtype in (None, torch.bfloat16):
        model = _port_net("r34-nbt1d", dtype=dtype, cls=FixedGate)
        load_flax_variables(model, {**run["variables"],
                                    "quant": run["quant"]})
        quantize.pack_int8(model)
        out[dtype] = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(11)
    images = (torch.from_numpy(rng.standard_normal((8, H, W, 3)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal(
            (8, H, W, 1)).astype(np.float32)))
    return out, images


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("strategy", [*ROUTED, "switch"])
def test_int8_strategies_equal_dense(routed_nets, strategy, dtype):
    models, (rgb, depth) = routed_nets
    model = models[dtype]
    model.paths = MIXED
    try:
        if strategy == "switch":
            for i, path in enumerate(MIXED):
                model.paths = [path]
                r, d = rgb[i:i + 1], depth[i:i + 1]
                got, _ = serve(model, r, d, mode="switch")
                with torch.no_grad():
                    dense = model(r, d, hard=True)
                want = layers.first_argmax(dense)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
                with torch.no_grad():
                    routed = model.forward_switch(r, d)
                torch.testing.assert_close(routed, dense, rtol=0, atol=0)
            return
        mode, kw = ROUTED[strategy]
        method = {"batchmax": model.forward_switch_batched,
                  "compact": model.forward_routed_compact}[mode]
        with torch.no_grad():
            routed = method(rgb, depth, **kw)
            dense = model(rgb, depth, hard=True,
                          low_res=kw.get("low_res", False))
        assert routed.dtype == (dtype or torch.float32)
        torch.testing.assert_close(routed, dense, rtol=0, atol=0)
    finally:
        model.paths = None


def test_nbt1d_blocks_run_unfused_when_quantized():
    for mode in ("calib", "int8"):
        block = NonBottleneck1D(16, 16, quant=mode).eval()
        assert block.fusable and not block.fused
        assert getattr(block, "w1", None) is None
    assert NonBottleneck1D(16, 16).eval().fused


def test_quant_buffers_stay_out_of_the_state_dict():
    float_net = _port_net("r18-basic", mode=None)
    net = _port_net("r18-basic")
    assert net.state_dict().keys() == float_net.state_dict().keys()
    net.load_state_dict(float_net.state_dict())
    quantize.pack_int8(net)
    conv = net.encoder_rgb.layer1[0].conv1
    assert conv.weight_q is not None and conv.w_mat is not None
    net.load_state_dict(float_net.state_dict())  # drops the packed copy
    assert conv.weight_q is None and conv.w_mat is None


def test_bridge_round_trip_keeps_scales_and_packing(nets):
    run = nets("r18-basic")
    model = _port_net("r18-basic")
    load_flax_variables(model, {**run["variables"], "quant": run["quant"]})
    quantize.pack_int8(model)
    fresh = _port_net("r18-basic")
    load_flax_variables(fresh, flax_variables(model))
    for (_, a), (_, b) in zip(quantize.quant_convs(model),
                              quantize.quant_convs(fresh)):
        for leaf in ("in_scale", "in_pct", "weight_q", "w_scale", "w_mat"):
            torch.testing.assert_close(getattr(b, leaf), getattr(a, leaf),
                                       rtol=0, atol=0)
    a, _ = _forward(model, run, "r18-basic")
    b, _ = _forward(fresh, run, "r18-basic")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("model", ["local-gate", "one-modality"])
def test_unquantizable_nets_raise(model):
    cfg = ESANetConfig(**BASE, **NETS["r18-basic"][1], quant="int8")
    with pytest.raises(NotImplementedError,
                       match="--quant supports global-gate / static models"):
        if model == "local-gate":
            skip_local.SkipESANet(cfg)
        else:
            one_modality.ESANetOneModality(cfg)
    with pytest.raises(ValueError, match="needs a model built with quant"):
        quantize.calibrate(_port_net("r18-basic", mode=None), [])


def test_calibration_restores_compute_dtype_and_mode(nets):
    run = nets("r18-basic")
    model = _port_net("r18-basic", dtype=torch.bfloat16)
    load_flax_variables(model, run["variables"])
    model.train()
    quantize.calibrate(model, [(torch.from_numpy(run["rgb"]),
                                torch.from_numpy(run["depth"]))], hard=True)
    assert model.training
    model.eval()
    assert all(c.quant == "int8" and c.compute_dtype == torch.bfloat16
               for _, c in quantize.quant_convs(model))
    # calibrated in fp32: the fp32 model's scales
    ref = _port_net("r18-basic")
    load_flax_variables(ref, run["variables"])
    quantize.calibrate(ref, [(torch.from_numpy(run["rgb"]),
                              torch.from_numpy(run["depth"]))], hard=True)
    for (_, a), (_, b) in zip(quantize.quant_convs(model),
                              quantize.quant_convs(ref)):
        torch.testing.assert_close(a.in_scale, b.in_scale, rtol=0, atol=0)
    logits, _ = _forward(model, run, "r18-basic")
    assert logits.dtype == torch.bfloat16
