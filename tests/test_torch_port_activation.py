"""Swish and hswish nets (``--activation swish|silu|hswish``) of the port
against the JAX package's, in fp32, on the same weights (the JAX
``export_state_dict`` loaded with ``strict=True``) and seeded numpy inputs,
64×64 (``_port_variants_setup.py``); and the routing rule of their cells.

The TPU kernels of the SE cell and of the NBt1D block fuse relu, so a
swish or hswish net runs those cells in PyTorch ops: the SE MLP with the
net's activation, the NBt1D blocks on their convs. Its stem keeps
``channel_sums`` and ``stem_fuse_pool`` (no activation inside), its decoder
``learned_upsample``. On the CPU every kernel wrapper takes its plain
version, so the routing is held here by recording which wrappers a forward
calls (``calls``).

Tolerances, as for the relu twins: modules within 1e-5
(``test_torch_port_layers.py``), whole nets' logits within 1e-4 of max
|JAX logits| with gate choices identical (``test_torch_port_variants.py``),
an exported swish net's replay equal to its eager forward with error 0
(``test_torch_port_export.py``). bf16 and int8 are in
``test_torch_port_activation_lowp.py``, training in
``test_torch_port_activation_train.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_variants_setup import (B, CLASSES, H, W, GumbelFromJax,
                                  assert_logits_close, configs, fast_jit,
                                  inputs, jax_gumbel_draws, load_exported,
                                  random_variables)
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models import one_modality as jone
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.nn import layers as jl
from dynmm_tpu_torch.kernels import nbt1d, stem_fuse
from dynmm_tpu_torch.models import esanet, one_modality, skip_local
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.nn import layers
from dynmm_tpu_torch.serve import ServingForward, serve
from tests.test_torch_port_layers import _close, _flax, _nchw, _np, _port
from tests.test_torch_port_routed import FixedGate, JaxFixedGate

ACTS = ["swish", "hswish"]
# the kernel wrappers a cell reaches, under the names its module looks up
WRAPPERS = {
    "channel_sums": (stem_fuse, layers), "stem_fuse_pool": (stem_fuse,),
    "se_fuse_mixed": (layers,), "fused_se": (layers,),
    "learned_upsample": (layers,), "nbt1d_fused": (nbt1d,),
    "nbt1d_pair": (nbt1d,)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def calls(monkeypatch):
    """Every call of a kernel wrapper from here on, by name (each still
    runs: on the CPU its plain version)."""
    seen = []
    for name, modules in WRAPPERS.items():
        for module in modules:
            real = getattr(module, name)

            def spy(*args, _real=real, _name=name, **kw):
                seen.append(_name)
                return _real(*args, **kw)

            monkeypatch.setattr(module, name, spy)
    return seen


# ------------------------------------------------------------- names
@pytest.mark.parametrize("name, key", [
    ("relu", "relu"), ("ReLU", "relu"), ("swish", "swish"),
    ("silu", "swish"), ("SiLU", "swish"), ("hswish", "hswish"),
    ("HSwish", "hswish")])
def test_activation_names_normalised_as_jax(name, key):
    """One name a net: the config keeps the normalised name, and the
    function is the JAX table's, within an fp32 rounding (``F.silu`` and
    ``F.hardswish`` in fp32; bit-equal at bf16:
    ``test_torch_port_activation_lowp.py``)."""
    assert ESANetConfig(activation=name).activation == key
    x = np.random.default_rng(0).standard_normal(999).astype(np.float32) * 4
    np.testing.assert_allclose(
        layers.get_activation(name)(_t(x)).numpy(),
        np.asarray(jl.get_activation(name)(jnp.asarray(x))),
        rtol=2 ** -23, atol=2 ** -24)


def test_unknown_activation_raises_as_jax():
    for get in (layers.get_activation, jl.get_activation):
        with pytest.raises(NotImplementedError, match="Only relu, swish"):
            get("gelu")
    with pytest.raises(NotImplementedError, match="Only relu, swish"):
        ESANetConfig(activation="gelu")


# ------------------------------------------------------ SE cells, fp32
def _se_cells(act, rng, c=32):
    """(JAX fusion cell, its variables, the port's cell, rgb, depth)."""
    rgb, depth = _np(rng, 3, 6, 8, c), _np(rng, 3, 6, 8, c)
    jf = jl.SqueezeAndExciteFusionAdd(c, activation=jl.get_activation(act))
    v = _flax(jf, rng, rgb, depth)
    tf = _port(layers.SqueezeAndExciteFusionAdd(c, activation=act), v)
    return jf, v, tf, rgb, depth


@pytest.mark.parametrize("act", ACTS)
def test_recalibrate_matches_jax(act, calls):
    rng = np.random.default_rng(40)
    x = _np(rng, 2, 5, 7, 32)
    jm = jl.SqueezeAndExcitation(32, activation=jl.get_activation(act))
    v = _flax(jm, rng, x)
    tm = _port(layers.SqueezeAndExcitation(32, activation=act), v)
    ref = jm.apply(v, x)
    with torch.no_grad():
        for use_kernels in (True, False):
            _close(tm.recalibrate(_nchw(x), use_kernels), ref)
        _close(tm(_nchw(x)), ref)
    assert calls == []


@pytest.mark.parametrize("act", ACTS)
def test_fuse_mixed_matches_jax(act, calls):
    jf, v, tf, rgb, depth = _se_cells(act, np.random.default_rng(41))
    w = np.array([0.0, 0.4, 1.0], np.float32)
    with torch.no_grad():
        out = tf.fuse_mixed(_nchw(rgb), _nchw(depth), _t(w))
        unmixed = tf(_nchw(rgb), _nchw(depth))
        plain = tf(_nchw(rgb), _nchw(depth), use_kernels=False)
    _close(out, jf.apply(v, rgb, depth, w, method="fuse_mixed"))
    for o in (unmixed, plain):
        _close(o, jf.apply(v, rgb, depth))
    assert calls == []


@pytest.mark.parametrize("act", ACTS)
def test_fuse_and_pool_matches_jax(act, calls):
    jf, v, tf, rgb, depth = _se_cells(act, np.random.default_rng(43), c=64)
    with torch.no_grad():
        out = tf.fuse_and_pool(_nchw(rgb), _nchw(depth))
    for o, r in zip(out, jf.apply(v, rgb, depth, method="fuse_and_pool")):
        _close(o, r)
    # the stem keeps both kernels: neither computes an activation
    assert calls == ["channel_sums", "stem_fuse_pool"]


# ------------------------------------------- the global-gate net, fp32
@functools.lru_cache(maxsize=None)
def _gate_net(act: str):
    """(JAX fixed-gate model, variables, port fixed-gate model, inputs) of
    the small SkipGateESANet on ``act``."""
    jcfg, cfg = configs(activation=act)
    rgb, depth = inputs(31)
    variables = random_variables(lambda: JaxSkipGate(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        train=False), 32)
    tmodel = load_exported(FixedGate(cfg), variables).eval()
    return JaxFixedGate(jcfg), variables, tmodel, inputs(33)


@functools.lru_cache(maxsize=None)
def _jax_forward(act: str, method: str, live: bool, **static):
    jm = _gate_net(act)[0]
    if live:
        jm = JaxSkipGate(jm.cfg)
    if method == "dense":
        return fast_jit(lambda v, r, d: jm.apply(
            v, r, d, train=False, hard=True, return_weight=True, **static))
    return fast_jit(lambda v, r, d: jm.apply(
        v, r, d, return_weight=True, method=getattr(jm, method), **static))


def _both(act, method, paths, **static):
    """(port (logits, weight), JAX (logits, weight)) of ``method``;
    ``paths`` None runs both live gates."""
    _, variables, tmodel, (rgb, depth) = _gate_net(act)
    b = len(paths) if paths else B
    rgb, depth = rgb[:b], depth[:b]
    v = dict(variables)
    if paths is not None:
        v["test_paths"] = {"paths": jnp.asarray(paths, jnp.int32)}
    ref = _jax_forward(act, method, paths is None, **static)(v, rgb, depth)
    tmodel.paths = paths
    with torch.no_grad():
        fwd = tmodel if method == "dense" else getattr(tmodel, method)
        kw = dict(static, hard=True) if method == "dense" else static
        out, w = fwd(_t(rgb), _t(depth), return_weight=True, **kw)
    return (out.numpy(), w.numpy()), tuple(np.asarray(a) for a in ref)


GATE_FORMS = {  # id: (activation, method, paths, static)
    "swish-dense": ("swish", "dense", None, {}),
    "swish-batchmax": ("swish", "forward_switch_batched", [3, 1], {}),
    "swish-compact": ("swish", "forward_routed_compact", [4, 0], {}),
    "swish-switch-b1": ("swish", "forward_switch", [2], {}),
    "hswish-dense": ("hswish", "dense", None, {}),
    "hswish-compact": ("hswish", "forward_routed_compact", [1, 3], {}),
}


@pytest.mark.parametrize("form", list(GATE_FORMS))
def test_gate_net_matches_jax(form):
    act, method, paths, static = GATE_FORMS[form]
    (out, w), (ref, ref_w) = _both(act, method, paths, **static)
    np.testing.assert_array_equal(w, ref_w)
    assert out.shape == (len(paths or [0] * B), H, W, CLASSES)
    assert_logits_close(out, ref)


@pytest.mark.parametrize("act", ACTS)
def test_routed_equals_dense_on_the_same_paths(act):
    """Every serve mode gives the dense forward's class map; batchmax and
    compact its logits (within 1e-5: the CPU's convolutions sum a
    sub-batch in another order)."""
    _, _, tmodel, (rgb, depth) = _gate_net(act)
    tmodel.paths = [3, 0]
    r, d = _t(rgb), _t(depth)
    with torch.no_grad():
        dense = tmodel(r, d, hard=True)
        for method in ("forward_routed_compact", "forward_switch_batched"):
            assert_logits_close(getattr(tmodel, method)(r, d).numpy(),
                                dense.numpy(), rel=1e-5)
    maps = {mode: serve(tmodel, r, d, mode=mode)[0]
            for mode in ("dense", "batchmax", "compact")}
    for mode, m in maps.items():
        torch.testing.assert_close(m, maps["dense"], rtol=0, atol=0)


# ---------------------------------------------- the rest of the family
@functools.lru_cache(maxsize=None)
def _static(act: str):
    jcfg, cfg = configs(activation=act)
    rgb, depth = inputs(34)
    jm = jesanet.ESANet(jcfg)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        train=False), 35)
    ref = fast_jit(lambda v, r, d: jm.apply(v, r, d, train=False))(
        variables, rgb, depth)
    return np.asarray(ref), load_exported(esanet.ESANet(cfg),
                                          variables).eval(), (rgb, depth)


@pytest.mark.parametrize("act", ACTS)
def test_static_esanet_matches_jax(act, calls):
    ref, tmodel, (rgb, depth) = _static(act)
    with torch.no_grad():
        out = tmodel(_t(rgb), _t(depth))
        plain = tmodel(_t(rgb), _t(depth), use_kernels=False)
    assert_logits_close(out.numpy(), ref)
    assert_logits_close(plain.numpy(), ref)
    assert set(calls) == {"channel_sums", "stem_fuse_pool",
                          "learned_upsample"}


@pytest.mark.parametrize("act", ACTS)
def test_one_modality_se_matches_jax(act, calls):
    jcfg, cfg = configs(activation=act)
    image = inputs(36)[0]
    jm = jone.ESANetOneModality(jcfg, input_channels=3,
                                weighting_in_encoder="SE-add")
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(image), train=False), 37)
    ref = fast_jit(lambda v, x: jm.apply(v, x, train=False))(variables, image)
    tmodel = load_exported(one_modality.ESANetOneModality(
        cfg, input_channels=3, weighting_in_encoder="SE-add"),
        variables).eval()
    with torch.no_grad():
        out = tmodel(_t(image))
    assert_logits_close(out.numpy(), np.asarray(ref))
    assert "fused_se" not in calls and "learned_upsample" in calls


@pytest.mark.parametrize("act", ACTS)
def test_local_gate_net_matches_jax(act, monkeypatch):
    """On JAX's Gumbel draws: hard choices identical, logits within 1e-4."""
    jcfg, cfg = configs(activation=act, fuse_depth_in_rgb_encoder="add")
    rgb, depth = inputs(38)
    rule = (1, 1, 2, 2)
    jm = jlocal.SkipESANet(jcfg, block_rule=rule)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        jax.random.PRNGKey(1)), 39)
    key = jax.random.PRNGKey(21)
    out_j, ws_j = fast_jit(lambda v, r, d: jm.apply(
        v, r, d, key, train=False, test=True, return_weights=True))(
        variables, rgb, depth)
    tmodel = load_exported(skip_local.SkipESANet(cfg, block_rule=rule),
                           variables).eval()
    GumbelFromJax(monkeypatch, jax_gumbel_draws(key, B))
    with torch.no_grad():
        out, ws = tmodel(_t(rgb), _t(depth), torch.Generator(), test=True,
                         return_weights=True)
    for w, w_j in zip(ws, ws_j):
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    assert_logits_close(out.numpy(), np.asarray(out_j))


# ------------------------------------------------------------- routing
def _served_calls(act, calls, mode="dense"):
    cfg = dataclasses.replace(configs()[1], activation=act)
    model = FixedGate(cfg).eval()
    model.paths = [4, 2]
    rgb, depth = (_t(a) for a in inputs(40))
    calls.clear()
    serve(model, rgb, depth, mode=mode)
    return sorted(set(calls)), calls.count("se_fuse_mixed")


@pytest.mark.parametrize("act", ["swish", "silu", "hswish"])
@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_swish_net_routes_around_the_relu_kernels(act, mode, calls):
    names, _ = _served_calls(act, calls, mode)
    assert names == ["channel_sums", "learned_upsample", "stem_fuse_pool"]
    assert calls.count("channel_sums") == calls.count("stem_fuse_pool") == 1


@pytest.mark.parametrize("act", ["relu", "ReLU"])
def test_relu_net_calls_every_kernel(act, calls):
    """``ReLU`` is relu: the same wrappers as a relu net, the NBt1D
    kernels and the SE fusion cells included (one a fused stage)."""
    names, se_cells = _served_calls(act, calls)
    assert names == ["channel_sums", "learned_upsample", "nbt1d_fused",
                     "nbt1d_pair", "se_fuse_mixed", "stem_fuse_pool"]
    assert se_cells == 4


@pytest.mark.parametrize("act, fusable", [
    ("relu", True), ("ReLU", True), ("swish", False), ("hswish", False)])
def test_nbt1d_block_fuses_relu_only(act, fusable):
    assert NonBottleneck1D(16, 16, activation=act).fused == fusable


# --------------------------------------------------------------- export
def test_swish_export_replays_eager(tmp_path):
    """A dense swish net exported, saved, loaded and replayed: error 0
    against eager, and its program holds only the kernels a swish net
    runs (no ``dynmm::se_fuse_mixed`` or ``dynmm::nbt1d_*`` node)."""
    from _port_export_setup import check_replay, roundtrip

    _, variables, _, _ = _gate_net("swish")
    model = load_exported(SkipGateESANet(configs(activation="swish")[1]),
                          variables)
    # as served: channels_last weights (the replay's convolutions too)
    module = ServingForward(model.to(memory_format=torch.channels_last
                                     ).eval(), "dense")
    rgb, depth = (_t(a) for a in inputs(42))
    fn = roundtrip(tmp_path, module, rgb, depth)
    check_replay(fn, module, (rgb, depth),
                 {"channel_sums", "stem_fuse_pool", "learned_upsample"})
