"""The port's segmentation variants against the JAX package's, on the same
weights (the JAX ``export_state_dict`` loaded with ``strict=True``) and the
same seeded inputs, 64×64, B=2 (``_port_variants_setup.py``): the
BasicBlock R18 and Bottleneck R50 encoders stage by stage, the R50
SkipGateESANet in every forward (gate overrides hand both packages the same
paths for the routed ones), SkipGateESANet with plain add fusion, the
static ESANet (SE-add and add, APPM and no context module, no
encoder-decoder fusion), ESANetOneModality (rgb and depth, with and
without SE) and the local-gate SkipESANet (its Gumbel draws replaced by the
JAX draws for the same key). On the CPU every kernel wrapper takes its
plain version. Logits within 1e-4 of the JAX logits' largest magnitude
(fp32 convolutions sum in other orders), gate choices identical."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_variants_setup import (B, CLASSES, H, R50, SMALL, W, GumbelFromJax,
                                  assert_logits_close, configs, fast_jit,
                                  inputs, jax_gumbel_draws, load_exported,
                                  random_variables)
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models import one_modality as jone
from dynmm_tpu.models import resnet as jresnet
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.nn.layers import max_pool_3x3_s2 as jax_pool
from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
from dynmm_tpu_torch.models import esanet, one_modality, resnet, skip_local
from dynmm_tpu_torch.models.context import get_context_module
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.nn.layers import max_pool_3x3_s2
from tests.test_torch_port_routed import FixedGate, JaxFixedGate


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- encoders
@functools.lru_cache(maxsize=None)
def _encoder(name: str, block: str):
    """(JAX stage outputs, port stage outputs) of one encoder: stem, then
    layer1..4 after the max-pool, on the same weights and image."""
    jmodel = jresnet.make_resnet(name, block=block, input_channels=3)
    x = inputs(1)[0]
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def stages(m, x):
        outs = [m.stem(x)]
        y = jax_pool(outs[0])
        for i in range(1, 5):
            y = getattr(m, f"layer{i}")(y)
            outs.append(y)
        return outs

    ref = fast_jit(lambda v, x: jmodel.apply(v, x, method=stages))(
        variables, x)
    tmodel = load_exported(resnet.make_resnet(name, block=block), variables)
    tmodel = tmodel.eval().to(memory_format=torch.channels_last)
    with torch.no_grad():
        y = tmodel.stem(_t(x).permute(0, 3, 1, 2))
        outs = [y]
        y = max_pool_3x3_s2(y)
        for i in range(1, 5):
            y = getattr(tmodel, f"layer{i}")(y)
            outs.append(y)
    return ([np.asarray(r) for r in ref],
            [o.permute(0, 2, 3, 1).numpy() for o in outs], tmodel)


@pytest.mark.parametrize("stage", range(5))
@pytest.mark.parametrize("name,block", [("resnet18", "BasicBlock"),
                                        ("resnet50", "Bottleneck")])
def test_encoder_stages_match_jax(name, block, stage):
    ref, out, tmodel = _encoder(name, block)
    widths = (64,) + tuple(tmodel.down_channels[s] for s in (4, 8, 16, 32))
    assert out[stage].shape[-1] == widths[stage]
    assert_logits_close(out[stage], ref[stage])


def test_make_resnet_block_choice():
    assert resnet.make_resnet("resnet50", block="BasicBlock").block == \
        "Bottleneck"
    r18 = resnet.make_resnet("resnet18", block="BasicBlock")
    assert isinstance(r18.layer2[0], resnet.BasicBlock)
    assert r18.down_channels == {2: 64, 4: 64, 8: 128, 16: 256, 32: 512}
    r50 = resnet.make_resnet("resnet50")
    assert r50.down_channels == {2: 64, 4: 256, 8: 512, 16: 1024, 32: 2048}
    assert [len(getattr(r50, f"layer{i}")) for i in range(1, 5)] == \
        [3, 4, 6, 3]
    with pytest.raises(NotImplementedError, match="Block Bottleneck"):
        resnet.make_resnet("resnet34", block="Bottleneck")


# ------------------------------------------------------ R50 SkipGateESANet
def _gate_net_variables(jcfg, seed: int):
    """Variables of the JAX SkipGateESANet of ``jcfg`` (the live gate's
    too; the fixed-gate subclass builds no gate)."""
    from dynmm_tpu.models.skip_gate import SkipGateESANet

    rgb, depth = inputs(seed)
    return random_variables(lambda: SkipGateESANet(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        train=False), seed)


@functools.lru_cache(maxsize=None)
def _gate_net(kind: str):
    """(JAX fixed-gate model, variables, port fixed-gate model, inputs) of
    the R50 SkipGateESANet (``r50``) or the small R18 one with plain add
    fusion (``add``)."""
    kw = R50 if kind == "r50" else dict(SMALL, fuse_depth_in_rgb_encoder="add")
    jcfg = JaxConfig(**kw)
    variables = _gate_net_variables(jcfg, 3)
    tmodel = load_exported(FixedGate(ESANetConfig(**kw)), variables).eval()
    return JaxFixedGate(jcfg), variables, tmodel, inputs(4)


@functools.lru_cache(maxsize=None)
def _jitted(kind: str, method: str, **static):
    model = _gate_net(kind)[0]
    if method == "dense":
        return fast_jit(lambda v, r, d: model.apply(
            v, r, d, train=False, return_weight=True, **static))
    return fast_jit(lambda v, r, d: model.apply(
        v, r, d, return_weight=True, method=getattr(model, method), **static))


def _both(kind, method, paths, **static):
    """(port (logits, weight), JAX (logits, weight)); ``paths`` None runs
    both live gates, a list hands both the same one-hot paths."""
    _, variables, tmodel, (rgb, depth) = _gate_net(kind)
    b = len(paths) if paths else B
    rgb, depth = rgb[:b], depth[:b]
    v = dict(variables)
    if paths is not None:
        v["test_paths"] = {"paths": jnp.asarray(paths, jnp.int32)}
        jmodel = _jitted(kind, method, **static)
    else:
        from dynmm_tpu.models.skip_gate import SkipGateESANet

        live = SkipGateESANet(_gate_net(kind)[0].cfg)
        fn = live.__call__ if method == "dense" else getattr(live, method)
        kw = dict(static, train=False) if method == "dense" else static
        jmodel = fast_jit(lambda v, r, d: live.apply(
            v, r, d, return_weight=True, method=fn, **kw))
    ref = tuple(np.asarray(a) for a in jmodel(v, rgb, depth))
    tmodel.paths = paths
    with torch.no_grad():
        fwd = tmodel if method == "dense" else getattr(tmodel, method)
        out, w = fwd(_t(rgb), _t(depth), return_weight=True, **static)
    return (out.numpy(), w.numpy()), ref


def _match(port, ref, exact_weights=True):
    (out, w), (ref_out, ref_w) = port, ref
    if exact_weights:
        np.testing.assert_array_equal(w, ref_w)
    else:
        np.testing.assert_allclose(w, ref_w, rtol=0, atol=1e-5)
    assert_logits_close(out, ref_out)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_r50_dense_matches_jax(hard):
    port, ref = _both("r50", "dense", None, hard=hard)
    _match(port, ref, exact_weights=hard)
    assert port[0].shape == (B, H, W, CLASSES)


def test_r50_baseline_matches_jax():
    _match(*_both("r50", "dense", None, hard=True, baseline=True))


@pytest.mark.parametrize("k", [0, 2, 4])
def test_r50_switch_batched_forced_path_matches_jax(k):
    _match(*_both("r50", "forward_switch_batched", None, force_path=k))


@pytest.mark.parametrize("paths", [[2, 0], [4, 1]], ids=["2-0", "4-1"])
def test_r50_compact_matches_jax(paths):
    _match(*_both("r50", "forward_routed_compact", paths))


def test_r50_compact_per_stage_ladders_match_jax():
    caps = ((1, 2), (1, 2), (0, 2), (0, 2))
    _match(*_both("r50", "forward_routed_compact", [3, 0], caps=caps))


def test_r50_switch_batch1_matches_jax():
    _match(*_both("r50", "forward_switch", [3]))


def test_r50_dense_equals_routed_on_the_same_paths():
    """Routed forwards run the dense forward's cells on the same paths: the
    R50 net's compact and batchmax logits agree with dense's (within 1e-5:
    the CPU's convolutions sum a sub-batch in another order)."""
    _, _, tmodel, (rgb, depth) = _gate_net("r50")
    tmodel.paths = [3, 1]
    r, d = _t(rgb), _t(depth)
    with torch.no_grad():
        dense = tmodel(r, d, hard=True)
        for method in ("forward_routed_compact", "forward_switch_batched"):
            assert_logits_close(getattr(tmodel, method)(r, d).numpy(),
                                dense.numpy(), rel=1e-5)


@pytest.mark.parametrize("method,paths,static", [
    ("dense", None, {"hard": True}),
    ("dense", None, {"hard": False}),
    ("forward_switch_batched", None, {"force_path": 2}),
    ("forward_routed_compact", [3, 0], {}),
    ("forward_switch", [2], {}),
], ids=["dense-hard", "dense-soft", "batchmax-2", "compact", "switch"])
def test_add_fusion_gate_net_matches_jax(method, paths, static):
    """SkipGateESANet with plain add fusion: ``rgb + (1−w)·depth`` in every
    forward, the stem through ``stem_fuse_pool`` with unit scales."""
    port, ref = _both("add", method, paths, **static)
    _match(port, ref, exact_weights=static.get("hard", True))
    assert not any(n.startswith("se_layer")
                   for n, _ in _gate_net("add")[2].named_parameters())


# ------------------------------------------------------------ static ESANet
STATIC = {
    "se-add": {},
    "add-basicblock": {"fuse_depth_in_rgb_encoder": "add",
                       "encoder_block": "BasicBlock",
                       "context_module": "appm-1-2-4-8"},
    "appm": {"context_module": "appm"},
    "no-skips": {"context_module": "None", "encoder_decoder_fusion": "None"},
}


@functools.lru_cache(maxsize=None)
def _static(name: str, low_res: bool = False):
    """(port logits, JAX logits, port model, variables) of the static
    ESANet of ``STATIC[name]``."""
    jcfg, cfg = configs(**STATIC[name])
    rgb, depth = inputs(5)
    jmodel = jesanet.ESANet(jcfg)
    variables = random_variables(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        train=False), 6)
    ref = np.asarray(fast_jit(lambda v, r, d: jmodel.apply(
        v, r, d, train=False, low_res=low_res))(variables, rgb, depth))
    tmodel = load_exported(esanet.ESANet(cfg), variables).eval()
    with torch.no_grad():
        out = tmodel(_t(rgb), _t(depth), low_res=low_res).numpy()
    return out, ref, tmodel, variables


@pytest.mark.parametrize("name", list(STATIC))
def test_static_esanet_matches_jax(name):
    out, ref, tmodel, _ = _static(name)
    assert out.shape == (B, H, W, CLASSES)
    assert_logits_close(out, ref)
    se = any(n.startswith("se_layer") for n, _ in tmodel.named_parameters())
    assert se == (STATIC[name].get("fuse_depth_in_rgb_encoder",
                                   "SE-add") == "SE-add")


def test_static_esanet_low_res_matches_jax():
    out, ref, _, _ = _static("se-add", low_res=True)
    assert out.shape == (B, H // 4, W // 4, CLASSES)
    assert_logits_close(out, ref)


def test_static_esanet_kernel_and_plain_paths_agree_on_cpu():
    tmodel = _static("add-basicblock")[2]
    rgb, depth = (_t(a) for a in inputs(5))
    reset_launches()
    with torch.no_grad():
        a = tmodel(rgb, depth)
        b = tmodel(rgb, depth, use_kernels=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors: plain versions


@pytest.mark.parametrize("name", ["None", "ppm", "ppm-1-2-4-8", "appm",
                                  "appm-1-2-4-8"])
def test_context_module_selector(name):
    """The port's selector picks the JAX selector's module, bins and output
    width for every name."""
    from dynmm_tpu.models.context import get_context_module as jax_get

    ref, c_ref = jax_get(name, 512, 128, (2, 2))
    mod, c = get_context_module(name, 512, 128, (2, 2))
    assert c == c_ref == (512 if ref is None else 128)
    if ref is None:
        assert mod is None
        return
    assert type(mod).__name__ == type(ref).__name__
    assert len(mod.features) == len(ref.bins)
    if "appm" in name:
        assert tuple(mod.bins) == tuple(ref.bins)
        assert mod.input_size == tuple(ref.input_size) == (2, 2)


def test_no_context_decoder_takes_encoder_width():
    tmodel = _static("no-skips")[2]
    assert tmodel.context_module is None
    assert tmodel.decoder.decoder_module_1.conv3x3.conv.in_channels == 512
    assert all(getattr(tmodel, f"skip_layer{i}") is None for i in (1, 2, 3))


# ------------------------------------------------------ ESANetOneModality
@functools.lru_cache(maxsize=None)
def _one_modality(modality: str, weighting: str):
    """(JAX model, variables, port model, image) of ESANetOneModality."""
    jcfg, cfg = configs(encoder_block="BasicBlock")
    c_in = 3 if modality == "rgb" else 1
    image = inputs(7)[0 if modality == "rgb" else 1]
    jmodel = jone.ESANetOneModality(jcfg, input_channels=c_in,
                                    weighting_in_encoder=weighting)
    variables = random_variables(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(image), train=False), 8)
    tmodel = load_exported(one_modality.ESANetOneModality(
        cfg, input_channels=c_in, weighting_in_encoder=weighting),
        variables).eval()
    return jmodel, variables, tmodel, image


@pytest.mark.parametrize("weighting", ["SE-add", "None"])
@pytest.mark.parametrize("modality", ["rgb", "depth"])
def test_one_modality_matches_jax(modality, weighting):
    jmodel, variables, tmodel, image = _one_modality(modality, weighting)
    ref = np.asarray(fast_jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, image))
    with torch.no_grad():
        out = tmodel(_t(image)).numpy()
        plain = tmodel(_t(image), use_kernels=False).numpy()
    assert out.shape == (B, H, W, CLASSES)
    assert_logits_close(out, ref)
    np.testing.assert_array_equal(out, plain)


# --------------------------------------------------------------- SkipESANet
@functools.lru_cache(maxsize=None)
def _local(block_rule):
    jcfg, cfg = configs(fuse_depth_in_rgb_encoder="add")
    rgb, depth = inputs(9)
    jmodel = jlocal.SkipESANet(jcfg, block_rule=block_rule)
    variables = random_variables(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(rgb), jnp.asarray(depth),
        jax.random.PRNGKey(1)), 10)
    tmodel = load_exported(skip_local.SkipESANet(cfg, block_rule=block_rule),
                           variables).eval()
    return jmodel, variables, tmodel, (rgb, depth)


@pytest.mark.parametrize("test_mode", [True, False], ids=["test", "soft"])
@pytest.mark.parametrize("block_rule", [(1, 1, 2, 2), (0, 1, 2, 2)],
                         ids=["1122", "0122"])
def test_local_gate_net_matches_jax(monkeypatch, block_rule, test_mode):
    """Both packages draw the same Gumbel noise (the JAX draws of the key,
    handed to the port's ``sample_gumbel``): logits within 1e-4, the hard
    gates' choices identical and the soft ones within 1e-5."""
    jmodel, variables, tmodel, (rgb, depth) = _local(block_rule)
    key = jax.random.PRNGKey(21)
    out_j, ws_j = fast_jit(lambda v, r, d: jmodel.apply(
        v, r, d, key, train=False, test=test_mode, return_weights=True))(
        variables, rgb, depth)
    GumbelFromJax(monkeypatch, jax_gumbel_draws(key, B))
    with torch.no_grad():
        out, ws = tmodel(_t(rgb), _t(depth), torch.Generator(),
                         test=test_mode, return_weights=True)
    assert len(ws) == len(ws_j) == 4
    for w, w_j in zip(ws, ws_j):
        if test_mode:  # hard samples: one-hot, chained by 0/1 weights
            np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(w.numpy().argmax(1),
                                      np.asarray(w_j).argmax(1))
    assert_logits_close(out.numpy(), out_j)


def test_local_gate_net_has_no_se_fusion_cells():
    _, _, tmodel, _ = _local((1, 1, 2, 2))
    names = [n for n, _ in tmodel.named_parameters()]
    assert not any(n.startswith("se_layer") for n in names)
    assert "gate_layer3.se.fc.2.weight" in names


def test_local_gate_random_policy_draws_from_the_generator():
    _, _, tmodel, (rgb, depth) = _local((1, 1, 2, 2))

    def run(seed):
        with torch.no_grad():
            return tmodel(_t(rgb), _t(depth),
                          torch.Generator().manual_seed(seed),
                          random_policy=True, return_weights=True)

    (a, wa), (b, wb) = run(3), run(3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for w in wa:
        assert set(w.flatten().tolist()) <= {0.0, 1.0}


# ------------------------------------------------------------- weight bridge
def _variables_of(name):
    """(JAX variables, the port model loaded from them), as the tests above
    built them."""
    if name == "r50-skipgate":
        return _gate_net("r50")[1], _gate_net("r50")[2]
    if name == "local":
        _, variables, tmodel, _ = _local((1, 1, 2, 2))
        return variables, tmodel
    if name == "one-modality-se":
        _, variables, tmodel, _ = _one_modality("rgb", "SE-add")
        return variables, tmodel
    _, _, tmodel, variables = _static(name)
    return variables, tmodel


@pytest.mark.parametrize("name", ["r50-skipgate", "local", "one-modality-se",
                                  "appm", "add-basicblock", "no-skips"])
def test_flax_from_state_dict_inverts_the_export(name):
    """The port's state_dict of each new model maps back to the JAX
    variable tree it was loaded from, leaf for leaf (checkpoints the port
    writes load into the JAX package)."""
    from dynmm_tpu_torch.utils.weights import flax_from_state_dict

    variables, tmodel = _variables_of(name)
    back = flax_from_state_dict(tmodel.state_dict())
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[coll])
        got = dict(jax.tree_util.tree_leaves_with_path(back[coll]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], np.asarray(leaf))
