"""The rest of the segmentation family in bf16 (the static ESANet, the
local-gate SkipESANet and ESANetOneModality) against the JAX package's
models at ``dtype=bfloat16``, on the same weights (the JAX
``export_state_dict`` loaded strictly) and seeded inputs, 64×64
(``_port_variants_setup.py``). Parameters stay fp32 in both packages; maps
are bf16; on the CPU every kernel wrapper takes its bf16 plain version.
Tolerances are fractions of max |reference|; one bf16 step at the top
binade is 2^-8 of it (3.9e-3):

* the single-map SE cell's plain version ``se_reference`` against the
  Pallas ``fused_se`` in interpret mode, at every width the one-modality
  net gives it (64-512): 8e-3 (the fp32 mean's summation order moves a
  rounding to bf16 by one step);
* modules against the JAX modules at bf16: 2e-2. The JAX SE MLP runs on
  bf16 weights where the port's runs in fp32 (the Pallas ``fused_se``'s
  choice). The local gate's SE weight rounds where JAX's rounds (means,
  each 1×1 conv's product and bias, sigmoid, scalar): the scalar is JAX's
  to one bf16 step, and equal to it wherever no fp32 sum lies that close
  to a rounding boundary;
  One gate's weights on JAX's Gumbel draws: hard ones identical, soft
  ones within one bf16 step of 1 (2^-8; the Gumbel softmax rounds in
  ``jax.nn.softmax``'s order, ``core/gates.py::softmax``);
* the whole nets: logits within 5e-2 of max |JAX fp32 logits|, the JAX
  package's own bf16 bound, against JAX's fp32 and bf16 nets; the local
  gates' hard choices identical to JAX's bf16 gates' on JAX's Gumbel draws
  (a sample whose perturbed logits lie within one bf16 step of a tie may
  go either way: it is named, and none did on these inputs), their soft
  weights within 2e-2, the modules' bound, since the maps the gates see
  already differ by that much.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_variants_setup import (R50, GumbelFromJax, configs, fast_jit,
                                  inputs, jax_gumbel_draws, load_exported,
                                  random_variables)
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.core.gates import sample_gumbel as jax_sample_gumbel
from dynmm_tpu.kernels import se as jse
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models import one_modality as jone
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.nn import layers as jl
from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches, se
from dynmm_tpu_torch.models import esanet, one_modality, skip_local
from dynmm_tpu_torch.nn import layers
from tests.test_torch_port_layers import _flax, _port

BF = torch.bfloat16
MODULE_TOL = 2e-2
NET_TOL = 5e-2
SE_TOL = 8e-3
STEP = 2.0 ** -8  # one bf16 step at the top binade, relative


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _f32(x) -> np.ndarray:
    """A JAX array or torch tensor of any float dtype → numpy fp32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(out, ref, scale=None) -> float:
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    return float(np.abs(out - ref).max() / scale)


# ------------------------------------- single-map SE: plain vs Pallas
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_se_reference_bf16_matches_pallas(c):
    rng = np.random.default_rng(c)
    cr = c // 16
    x = jnp.asarray(np.abs(rng.standard_normal((2, 48, c))), jnp.bfloat16)
    w = [(rng.standard_normal((c, cr)) / np.sqrt(c)).astype(np.float32),
         (rng.standard_normal(cr) * 0.1).astype(np.float32),
         (rng.standard_normal((cr, c)) / np.sqrt(cr)).astype(np.float32),
         (rng.standard_normal(c) * 0.1).astype(np.float32)]
    ref = jse.fused_se(x, *w, interpret=True)
    out = se.se_reference(_t(_f32(x)).to(BF), *map(_t, w))
    assert out.dtype == BF and ref.dtype == jnp.bfloat16
    assert _rel(out, ref) <= SE_TOL


# --------------------------------------------------- modules vs JAX bf16
def test_se_recalibration_bf16_matches_jax():
    """The one-modality net's SE cell: ``recalibrate`` (``fused_se``'s
    plain version on the CPU) against the JAX module at bf16."""
    rng = np.random.default_rng(31)
    x = np.abs(rng.standard_normal((2, 6, 8, 32))).astype(np.float32)
    jm = jl.SqueezeAndExcitation(32, dtype=jnp.bfloat16)
    v = _flax(jm, rng, x)
    tm = _port(layers.SqueezeAndExcitation(32), v)
    layers.set_compute_dtype(tm, BF)
    ref = jm.apply(v, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = tm.recalibrate(_t(x).to(BF).permute(0, 3, 1, 2))
    assert out.dtype == BF
    assert _rel(out.permute(0, 2, 3, 1), ref) <= MODULE_TOL


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "soft"])
def test_local_gate_bf16_matches_jax(monkeypatch, test_mode):
    """One local gate at bf16: the SE weight scalar (JAX's
    ``SqueezeAndExcitationWeight`` on the concatenation) and the gate's
    weights on JAX's Gumbel draws."""
    rng = np.random.default_rng(32)
    b, c = 6, 16
    rgb, depth = (np.abs(rng.standard_normal((b, 8, 10, c))).astype(
        np.float32) for _ in range(2))
    key = jax.random.PRNGKey(33)
    jm = jl.SqueezeAndExciteReweigh(c, dtype=jnp.bfloat16)
    v = _flax(jm, rng, key, rgb, depth)
    tm = _port(layers.SqueezeAndExciteReweigh(c), v)
    layers.set_compute_dtype(tm, BF)
    r16, d16 = (jnp.asarray(a, jnp.bfloat16) for a in (rgb, depth))
    scalar_j = jl.SqueezeAndExcitationWeight(2 * c, dtype=jnp.bfloat16).apply(
        {"params": v["params"]["se"]}, jnp.concatenate([r16, d16], -1))
    w_j = jm.apply(v, key, r16, d16, test=test_mode)
    rt, dt = (_t(_f32(a)).to(BF).permute(0, 3, 1, 2) for a in (r16, d16))
    means = torch.cat([rt.float().mean(dim=(2, 3)),
                       dt.float().mean(dim=(2, 3))], 1)
    GumbelFromJax(monkeypatch, [np.asarray(jax_sample_gumbel(
        key, (b, 2), jnp.float32))])
    with torch.no_grad():
        scalar = tm.se.from_means(means, BF)
        w = tm(rt, dt, torch.Generator(), test=test_mode)
    assert scalar.dtype == w.dtype == BF
    s, s_j = _f32(scalar), _f32(scalar_j)
    assert np.abs(s - s_j).max() <= STEP * np.abs(s_j).max()
    print(f"SE weight scalars equal to JAX's in {(s == s_j).sum()} of {b}")
    if test_mode:
        np.testing.assert_array_equal(_f32(w), _f32(w_j))
    else:
        np.testing.assert_allclose(_f32(w), _f32(w_j), rtol=0, atol=STEP)


# --------------------------------------------------------- the whole nets
NETS = {  # name: (JAX model, port model, config over SMALL, model kwargs)
    "static-se-add": (jesanet.ESANet, esanet.ESANet, {}, {}),
    "static-add-basicblock": (
        jesanet.ESANet, esanet.ESANet,
        {"fuse_depth_in_rgb_encoder": "add", "encoder_block": "BasicBlock"},
        {}),
    "one-modality-rgb-se-basicblock": (
        jone.ESANetOneModality, one_modality.ESANetOneModality,
        {"encoder_block": "BasicBlock"},
        {"input_channels": 3, "weighting_in_encoder": "SE-add"}),
    "one-modality-depth-r50": (
        jone.ESANetOneModality, one_modality.ESANetOneModality,
        {"encoder_rgb": R50["encoder_rgb"],
         "encoder_depth": R50["encoder_depth"]},
        {"input_channels": 1, "weighting_in_encoder": "None"}),
}


@functools.lru_cache(maxsize=None)
def _net(name: str):
    """(JAX fp32 logits, JAX bf16 logits, the port's bf16 model, inputs)."""
    jcls, tcls, over, kw = NETS[name]
    jcfg, cfg = configs(**over)
    rgb, depth = inputs(5)
    args = ((rgb, depth) if "input_channels" not in kw else
            ((rgb,) if kw["input_channels"] == 3 else (depth,)))
    jm = jcls(jcfg, **kw)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False), 6)
    logits = []
    for dtype in (None, jnp.bfloat16):
        m = jcls(dataclasses.replace(jcfg, dtype=dtype), **kw)
        logits.append(_f32(fast_jit(lambda v, *a, m=m: m.apply(
            v, *a, train=False))(variables, *args)))
    tmodel = load_exported(tcls(dataclasses.replace(cfg, dtype=BF), **kw),
                           variables).eval()
    return (*logits, tmodel, tuple(map(_t, args)))


@pytest.mark.parametrize("name", list(NETS))
def test_net_bf16_matches_jax(name):
    ref32, ref16, tmodel, args = _net(name)
    reset_launches()
    with torch.no_grad():
        out = tmodel(*args)
        plain = tmodel(*args, use_kernels=False)
    assert out.dtype == BF and out.shape == ref32.shape
    assert sum(LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    scale = np.abs(ref32).max()
    assert scale > 0.1
    err32, err16 = _rel(out, ref32, scale), _rel(out, ref16, scale)
    print(f"{name}: bf16 logits vs JAX fp32 {err32:.3g}, vs JAX bf16 "
          f"{err16:.3g} of max |JAX fp32|")
    assert err32 < NET_TOL and err16 < NET_TOL


def test_one_modality_se_cells_take_bf16_maps(monkeypatch):
    """Each of the five SE cells gets a bf16 map and its fp32 weights."""
    tmodel, (image,) = _net("one-modality-rgb-se-basicblock")[2:]
    seen = []
    orig = se.se_reference

    def spy(x, *w):
        seen.append((x.dtype, {t.dtype for t in w}))
        return orig(x, *w)

    monkeypatch.setattr(layers, "se_reference", spy)
    with torch.no_grad():
        tmodel(image, use_kernels=False)
    assert seen == [(BF, {torch.float32})] * 5


LOCAL = {  # name: (block rule, config over SMALL)
    "1122": ((1, 1, 2, 2), {}),
    "2222-basicblock": ((2, 2, 2, 2), {"encoder_block": "BasicBlock"}),
}


@functools.lru_cache(maxsize=None)
def _local(name: str):
    rule, over = LOCAL[name]
    jcfg, cfg = configs(fuse_depth_in_rgb_encoder="add", **over)
    rgb, depth = inputs(9, b=4)
    jm = jlocal.SkipESANet(jcfg, block_rule=rule)
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        jax.random.PRNGKey(1)), 10)
    tmodel = load_exported(skip_local.SkipESANet(
        dataclasses.replace(cfg, dtype=BF), block_rule=rule), variables)
    return jcfg, rule, variables, tmodel.eval(), (rgb, depth)


KEY = jax.random.PRNGKey(21)


@functools.lru_cache(maxsize=None)
def _local_jax(name: str, test_mode: bool, bf16: bool):
    """The JAX net's (logits, gate weights) on ``KEY``'s draws."""
    jcfg, rule, variables, _, (rgb, depth) = _local(name)
    m = jlocal.SkipESANet(dataclasses.replace(
        jcfg, dtype=jnp.bfloat16 if bf16 else None), block_rule=rule)
    out, ws = fast_jit(lambda v, r, d: m.apply(
        v, r, d, KEY, train=False, test=test_mode, return_weights=True))(
        variables, rgb, depth)
    return _f32(out), [_f32(w) for w in ws]


@pytest.mark.parametrize("name, test_mode", [
    ("1122", True), ("1122", False), ("2222-basicblock", True)],
    ids=["1122-test", "1122-soft", "2222-basicblock-test"])
def test_local_gate_net_bf16_matches_jax(monkeypatch, name, test_mode):
    """Against the JAX bf16 net in the same mode; in test mode also the
    JAX fp32 net, whose logits give the scale of both."""
    _, _, _, tmodel, (rgb, depth) = _local(name)
    out32, _ = _local_jax(name, True, False)
    out16, ws16 = _local_jax(name, test_mode, True)
    draws = jax_gumbel_draws(KEY, rgb.shape[0])
    GumbelFromJax(monkeypatch, draws)
    perturbed = []  # each gate's logits + noise in bf16, in the order drawn
    gumbel = layers.gumbel_softmax

    def spy(logits, generator, **kw):
        perturbed.append(logits + _t(draws[len(perturbed)]).to(logits.dtype))
        return gumbel(logits, generator, **kw)

    monkeypatch.setattr(layers, "gumbel_softmax", spy)
    with torch.no_grad():
        out, ws = tmodel(_t(rgb), _t(depth), torch.Generator(),
                         test=test_mode, return_weights=True)
    assert out.dtype == BF and len(ws) == len(ws16) == 4
    assert all(w.dtype == BF for w in ws)
    near_ties = []
    for i, (w, w16) in enumerate(zip(ws, ws16)):
        w = _f32(w)
        if not test_mode:  # the gates' maps differ by the modules' error
            np.testing.assert_allclose(w, w16, rtol=0, atol=MODULE_TOL)
            continue
        for s in np.flatnonzero((w != w16).any(1)):
            z = _f32(perturbed[i])[s]
            near_ties.append((i, s))
            assert abs(z[0] - z[1]) <= STEP * np.abs(z).max(), (
                f"gate {i} sample {s}: choice differs from JAX's with a "
                f"margin above one bf16 step ({z})")
    print(f"{name}: samples within one bf16 step of a tie whose choice "
          f"differs from JAX's: {near_ties or 'none'}")
    scale = np.abs(out32).max()
    assert _rel(out, out16, scale) < NET_TOL
    if test_mode:
        assert _rel(out, out32, scale) < NET_TOL
