"""Swish and hswish nets of the port in bf16 and int8 against the JAX
package's, on the same weights and seeded numpy inputs, 64×64
(``_port_variants_setup.py``). On the CPU every kernel wrapper takes its
plain version.

* The activations on bf16 maps bit-equal to the JAX formulas as XLA
  computes them: swish's sigmoid op by op (XLA's bf16 logistic rounds
  ``exp``, the ``1 +`` and the division; ``torch.sigmoid`` and
  ``F.silu`` round once and land a bf16 step away on about a third of
  the inputs), hswish op by op (``F.hardswish`` rounds once).
* The SE cells at bf16 (``recalibrate``, ``fuse_mixed``, ``fuse_and_pool``,
  the local gate's SE weight) against the JAX modules at
  ``dtype=bfloat16``: within 2e-2 of max |JAX|
  (``test_torch_port_bf16_variants.py``'s module bound: the JAX SE MLP
  runs on bf16 weights where the port's runs in fp32, as the relu cells'
  kernels do); the local gate's SE scalar within one bf16 step.
* Whole nets at bf16 against JAX's bf16 and fp32 nets: logits within 5e-2
  of max |JAX fp32 logits| (``NET_TOL``), gate choices identical.
* int8: the global-gate and static swish nets (and the gate net at bf16
  compute), the port's seeded weights carried to JAX, JAX's calibration
  loaded into the port, against JAX's int8 net on
  ``test_torch_port_quant.py``'s bounds (gate choices identical, relative
  L2 < 5e-2, class maps agree on > 95 % and on every pixel whose JAX
  top-two margin exceeds twice the max logit error); the quantized convs
  counted by ``quant_sanity`` are the relu net's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_variants_setup import (GumbelFromJax, configs, fast_jit, inputs,
                                  jax_gumbel_draws, load_exported,
                                  random_variables)
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.core.gates import sample_gumbel as jax_sample_gumbel
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models import one_modality as jone
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.nn import layers as jl
from dynmm_tpu.utils import quantize as jquantize
from dynmm_tpu_torch.models import esanet, one_modality, skip_local
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.nn import layers
from dynmm_tpu_torch.serve import init_weights
from dynmm_tpu_torch.utils import quantize
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_flax_variables)
from tests.test_torch_port_layers import _flax, _port
from tests.test_torch_port_quant import BASE, NET_AGREE, NET_L2_TOL

BF = torch.bfloat16
MODULE_TOL = 2e-2
NET_TOL = 5e-2
STEP = 2.0 ** -8  # one bf16 step at the top binade, relative
ACTS = ["swish", "hswish"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(out, ref, scale=None) -> float:
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    return float(np.abs(out - ref).max() / scale)


def _bf16(x: np.ndarray):
    """(JAX bf16 array, the same values as an NCHW torch bf16 map)."""
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, _t(_f32(xj)).to(BF).permute(0, 3, 1, 2)


# ---------------------------------------------------------- activations
@pytest.mark.parametrize("act", ACTS)
def test_activations_bf16_bit_equal_to_jax(act):
    """On a BN-like chain in one jitted function, as in the JAX model; the
    single-rounding forms miss it (the choice this test made)."""
    rng = np.random.default_rng(50)
    x = (rng.standard_normal((64, 300)) * 3).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    b = (rng.standard_normal(300) * 0.3).astype(np.float32)
    jf = jl.get_activation(act)
    ref = jax.jit(lambda x, a, b: jf(x * a + b))(
        *(jnp.asarray(v, jnp.bfloat16) for v in (x, a, b)))
    xt, at, bt = (_t(_f32(jnp.asarray(v, jnp.bfloat16))).to(BF)
                  for v in (x, a, b))
    y = xt * at + bt
    out = layers.get_activation(act)(y)
    assert out.dtype == BF
    np.testing.assert_array_equal(_f32(out), _f32(ref))
    once = torch.nn.functional.silu if act == "swish" else \
        torch.nn.functional.hardswish
    assert (_f32(once(y)) != _f32(ref)).mean() > 0.1


# ------------------------------------------------------ SE cells, bf16
@pytest.mark.parametrize("act", ACTS)
def test_recalibrate_bf16_matches_jax(act):
    rng = np.random.default_rng(51)
    x = np.abs(rng.standard_normal((2, 6, 8, 32))).astype(np.float32)
    jm = jl.SqueezeAndExcitation(32, activation=jl.get_activation(act),
                                 dtype=jnp.bfloat16)
    v = _flax(jm, rng, x)
    tm = _port(layers.SqueezeAndExcitation(32, activation=act), v)
    layers.set_compute_dtype(tm, BF)
    xj, xt = _bf16(x)
    ref = jm.apply(v, xj)
    with torch.no_grad():
        out = tm.recalibrate(xt)
        fwd = tm(xt)
    assert out.dtype == BF
    torch.testing.assert_close(out, fwd, rtol=0, atol=0)
    assert _rel(out.permute(0, 2, 3, 1), ref) <= MODULE_TOL


def _fusion_bf16(act, rng, c):
    rgb, depth = (np.abs(rng.standard_normal((3, 8, 10, c))).astype(
        np.float32) for _ in range(2))
    jf = jl.SqueezeAndExciteFusionAdd(c, activation=jl.get_activation(act),
                                      dtype=jnp.bfloat16)
    v = _flax(jf, rng, rgb, depth)
    tf = _port(layers.SqueezeAndExciteFusionAdd(c, activation=act), v)
    layers.set_compute_dtype(tf, BF)
    return jf, v, tf, _bf16(rgb), _bf16(depth)


@pytest.mark.parametrize("act", ACTS)
def test_fuse_mixed_bf16_matches_jax(act):
    jf, v, tf, (rj, rt), (dj, dt) = _fusion_bf16(
        act, np.random.default_rng(52), 32)
    w = np.array([0.0, 0.4, 1.0], np.float32)
    ref = jf.apply(v, rj, dj, jnp.asarray(w), method="fuse_mixed")
    with torch.no_grad():
        out = tf.fuse_mixed(rt, dt, _t(w))
        unmixed = tf(rt, dt)
    assert out.dtype == unmixed.dtype == BF
    assert _rel(out.permute(0, 2, 3, 1), ref) <= MODULE_TOL
    assert _rel(unmixed.permute(0, 2, 3, 1), jf.apply(v, rj, dj)) \
        <= MODULE_TOL


@pytest.mark.parametrize("act", ACTS)
def test_fuse_and_pool_bf16_matches_jax(act):
    jf, v, tf, (rj, rt), (dj, dt) = _fusion_bf16(
        act, np.random.default_rng(53), 64)
    refs = jf.apply(v, rj, dj, method="fuse_and_pool")
    with torch.no_grad():
        outs = tf.fuse_and_pool(rt, dt)
    for o, r in zip(outs, refs):
        assert o.dtype == BF
        assert _rel(o.permute(0, 2, 3, 1), r) <= MODULE_TOL


@pytest.mark.parametrize("act", ACTS)
def test_local_gate_bf16_matches_jax(act, monkeypatch):
    """The local gate's SE weight scalar (its MLP's activation on bf16
    values) within one bf16 step of JAX's, the hard choices identical."""
    rng = np.random.default_rng(54)
    b, c = 6, 16
    rgb, depth = (np.abs(rng.standard_normal((b, 8, 10, c))).astype(
        np.float32) for _ in range(2))
    key = jax.random.PRNGKey(55)
    jm = jl.SqueezeAndExciteReweigh(c, activation=jl.get_activation(act),
                                    dtype=jnp.bfloat16)
    v = _flax(jm, rng, key, rgb, depth)
    tm = _port(layers.SqueezeAndExciteReweigh(c, activation=act), v)
    layers.set_compute_dtype(tm, BF)
    (rj, rt), (dj, dt) = _bf16(rgb), _bf16(depth)
    scalar_j = jl.SqueezeAndExcitationWeight(
        2 * c, activation=jl.get_activation(act), dtype=jnp.bfloat16).apply(
        {"params": v["params"]["se"]}, jnp.concatenate([rj, dj], -1))
    w_j = jm.apply(v, key, rj, dj, test=True)
    means = torch.cat([rt.float().mean(dim=(2, 3)),
                       dt.float().mean(dim=(2, 3))], 1)
    GumbelFromJax(monkeypatch, [np.asarray(jax_sample_gumbel(
        key, (b, 2), jnp.float32))])
    with torch.no_grad():
        scalar = tm.se.from_means(means, BF)
        w = tm(rt, dt, torch.Generator(), test=True)
    s, s_j = _f32(scalar), _f32(scalar_j)
    assert np.abs(s - s_j).max() <= STEP * np.abs(s_j).max()
    print(f"{act}: SE weight scalars equal to JAX's in {(s == s_j).sum()} "
          f"of {b}")
    np.testing.assert_array_equal(_f32(w), _f32(w_j))


# ------------------------------------------------- whole nets in bf16
NETS = {  # name: (JAX model, port model, config over SMALL, kwargs, call)
    "gate-swish": (JaxSkipGate, SkipGateESANet, {"activation": "swish"}, {},
                   {"hard": True, "return_weight": True}),
    "static-hswish": (jesanet.ESANet, esanet.ESANet,
                      {"activation": "hswish"}, {}, {}),
    "one-modality-swish": (
        jone.ESANetOneModality, one_modality.ESANetOneModality,
        {"activation": "swish", "encoder_block": "BasicBlock"},
        {"input_channels": 3, "weighting_in_encoder": "SE-add"}, {}),
}


@functools.lru_cache(maxsize=None)
def _net(name: str):
    """(JAX fp32 out, JAX bf16 out, the port's bf16 model, inputs)."""
    jcls, tcls, over, kw, call = NETS[name]
    jcfg, cfg = configs(**over)
    rgb, depth = inputs(56)
    args = (rgb, depth) if "input_channels" not in kw else (rgb,)
    jm = jcls(jcfg, **kw)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False), 57)
    outs = []
    for dtype in (None, jnp.bfloat16):
        m = jcls(dataclasses.replace(jcfg, dtype=dtype), **kw)
        outs.append(fast_jit(lambda v, *a, m=m: m.apply(
            v, *a, train=False, **call))(variables, *args))
    tmodel = load_exported(tcls(dataclasses.replace(cfg, dtype=BF), **kw),
                           variables).eval()
    return (*outs, tmodel, tuple(map(_t, args)))


@pytest.mark.parametrize("name", list(NETS))
def test_net_bf16_matches_jax(name):
    ref32, ref16, tmodel, args = _net(name)
    call = NETS[name][4]
    with torch.no_grad():
        out = tmodel(*args, **call)
    if call:  # the global gate: (logits, weight), the gate in fp32
        (out, w), (ref32, w32), (ref16, w16) = out, ref32, ref16
        np.testing.assert_array_equal(w.numpy(), np.asarray(w32))
        np.testing.assert_array_equal(w.numpy(), np.asarray(w16))
    assert out.dtype == BF
    scale = np.abs(_f32(ref32)).max()
    assert scale > 0.1
    err32, err16 = _rel(out, ref32, scale), _rel(out, ref16, scale)
    print(f"{name}: bf16 logits vs JAX fp32 {err32:.3g}, vs JAX bf16 "
          f"{err16:.3g} of max |JAX fp32|; JAX's own bf16 net vs its fp32 "
          f"net {_rel(ref16, ref32, scale):.3g}")
    assert err32 < NET_TOL and err16 < NET_TOL


def test_local_gate_net_bf16_matches_jax(monkeypatch):
    """The swish local-gate net at bf16 on JAX's Gumbel draws, test mode:
    against the JAX bf16 and fp32 nets."""
    jcfg, cfg = configs(activation="swish", fuse_depth_in_rgb_encoder="add")
    rgb, depth = inputs(58, b=4)
    rule = (1, 1, 2, 2)
    jm = jlocal.SkipESANet(jcfg, block_rule=rule)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        jax.random.PRNGKey(1)), 59)
    key = jax.random.PRNGKey(21)
    outs = {}
    for dtype in (None, jnp.bfloat16):
        m = jlocal.SkipESANet(dataclasses.replace(jcfg, dtype=dtype),
                              block_rule=rule)
        outs[dtype] = fast_jit(lambda v, r, d, m=m: m.apply(
            v, r, d, key, train=False, test=True, return_weights=True))(
            variables, rgb, depth)
    tmodel = load_exported(skip_local.SkipESANet(
        dataclasses.replace(cfg, dtype=BF), block_rule=rule), variables)
    GumbelFromJax(monkeypatch, jax_gumbel_draws(key, rgb.shape[0]))
    with torch.no_grad():
        out, ws = tmodel.eval()(_t(rgb), _t(depth), torch.Generator(),
                                test=True, return_weights=True)
    for w, w16 in zip(ws, outs[jnp.bfloat16][1]):
        np.testing.assert_array_equal(_f32(w), _f32(w16))
    scale = np.abs(_f32(outs[None][0])).max()
    assert _rel(out, outs[jnp.bfloat16][0], scale) < NET_TOL
    assert _rel(out, outs[None][0], scale) < NET_TOL


# ---------------------------------------------------------------- int8
INT8 = {  # name: (net kind, compute dtype); the config is BASE's R18 NBt1D
    "gate-swish": ("gate", None),
    "static-swish": ("static", None),
    "gate-swish-bf16": ("gate", BF),
}


def _int8_cfg(over=None):
    return dict(BASE, encoder_rgb="resnet18", encoder_depth="resnet18",
                encoder_block="NonBottleneck1D", **(over or {}))


@functools.lru_cache(maxsize=None)
def _calibrated(kind: str):
    """The swish net's seeded port weights, JAX's calibration of them
    (``calib`` collection, fp32) and the inputs."""
    kw = _int8_cfg({"activation": "swish"})
    rng = np.random.default_rng(60)
    rgb = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    depth = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    cls = SkipGateESANet if kind == "gate" else esanet.ESANet
    model = cls(ESANetConfig(**kw, quant="int8")).eval()
    init_weights(model, torch.Generator().manual_seed(2))
    variables = flax_variables(model)
    jcls = JaxSkipGate if kind == "gate" else jesanet.ESANet
    call = {"hard": True} if kind == "gate" else {}
    jc = jcls(JaxConfig(**kw, quant="calib"))
    qcoll = fast_jit(lambda v, r, d: jc.apply(
        v, r, d, train=False, mutable=["quant"], **call)[1]["quant"])(
        variables, rgb, depth)
    qcoll = jax.tree_util.tree_map(np.asarray, qcoll)
    return cls, jcls, kw, variables, qcoll, (rgb, depth), call


@pytest.mark.parametrize("name", list(INT8))
def test_net_int8_matches_jax(name):
    kind, dtype = INT8[name]
    cls, jcls, kw, variables, qcoll, (rgb, depth), call = _calibrated(kind)
    jm = jcls(JaxConfig(**kw, quant="int8",
                        dtype=None if dtype is None else jnp.bfloat16))

    kw_call = dict(call, return_weight=True) if call else {}
    ref = fast_jit(lambda v, r, d: jm.apply(v, r, d, train=False, **kw_call))(
        {**variables, "quant": qcoll}, rgb, depth)
    ref, ref_w = ref if call else (ref, None)
    model = cls(ESANetConfig(**kw, quant="int8", dtype=dtype)).eval()
    load_flax_variables(model, {**variables, "quant": qcoll})
    relu = cls(ESANetConfig(**_int8_cfg(), quant="int8"))
    n_convs = len(quantize.quant_convs(model))
    assert n_convs == len(quantize.quant_convs(relu))
    assert quantize.quant_sanity(model) == jquantize.quant_sanity(qcoll) \
        == n_convs
    with torch.no_grad():
        out = model(_t(rgb), _t(depth), **kw_call)
    out, w = out if call else (out, None)
    assert out.dtype == (dtype or torch.float32)
    out, ref = out.float().numpy(), _f32(ref)
    err = float(np.abs(out - ref).max())
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    agree = float((out.argmax(-1) == ref.argmax(-1)).mean())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * err
    print(f"{name}: {n_convs} int8 convs; logits relative L2 {rel:.3g}, "
          f"class maps agree on {agree * 100:.2f} %, {sure.mean() * 100:.1f}"
          f" % of pixels have margin > 2x{err:.3g}")
    assert rel < NET_L2_TOL and agree > NET_AGREE
    np.testing.assert_array_equal(out.argmax(-1)[sure], ref.argmax(-1)[sure])
    if call:
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))
