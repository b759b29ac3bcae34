"""The port's routed serving strategies against the JAX model.

The small NonBottleneck1D config of ``test_torch_port_model.py`` is
initialised in JAX with randomised biases and BN statistics and carried
across with ``load_flax_variables``. Both sides get the same per-sample
paths through a gate override (the JAX package's own ``FixedGateNet``
pattern, ``tests/test_routed_compact.py``), so every path mix, capacity
ladder and overflow case is reached on purpose. JAX runs each strategy
jit-compiled once per static configuration; the paths are data.

Tolerance for logits: the one ``test_torch_port_model.py`` uses (1e-4 of
max |JAX logits|, fp32 convs summed in other orders). Gate weights and the
class maps of the serve modes must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.core import routing as jrouting
from dynmm_tpu.models import skip_gate as jskip
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu_torch.core import routing
from dynmm_tpu_torch.models import skip_gate
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.serve import SERVE_MODES, capacity_schedule, serve
from dynmm_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_port_model import SMALL, _randomise

MIXED = [0, 4, 2, 1, 3, 0, 1, 2]  # n_1..4 = 6, 4, 2, 1


class JaxFixedGate(jskip.SkipGateESANet):
    """Per-sample paths supplied in the ``test_paths`` collection."""

    def gate_weights(self, rgb, depth, **kw):
        paths = self.variables["test_paths"]["paths"]
        return jax.nn.one_hot(paths[: rgb.shape[0]], 5, dtype=rgb.dtype)


class FixedGate(skip_gate.SkipGateESANet):
    """The port's twin: ``paths`` set → one-hot gate; ``None`` → live gate."""

    paths = None

    def gate_weights(self, rgb, depth, temp=1.0, hard=False, baseline=False):
        if self.paths is None:
            return super().gate_weights(rgb, depth, temp=temp, hard=hard,
                                        baseline=baseline)
        idx = torch.tensor(self.paths[: rgb.shape[0]], device=rgb.device)
        return torch.nn.functional.one_hot(idx, 5).to(rgb.dtype)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    inputs = {b: (rng.standard_normal((b, 64, 64, 3)).astype(np.float32),
                  rng.standard_normal((b, 64, 64, 1)).astype(np.float32))
              for b in (8, 5, 1)}
    init_model = jskip.SkipGateESANet(JaxConfig(**SMALL))
    variables = jax.jit(lambda r, d: init_model.init(
        jax.random.PRNGKey(0), r, d, train=False))(*inputs[8])
    variables = _randomise(variables, rng)
    tmodel = FixedGate(ESANetConfig(**SMALL)).eval()
    load_flax_variables(tmodel, variables)
    return JaxFixedGate(JaxConfig(**SMALL)), variables, tmodel, inputs


@functools.lru_cache(maxsize=None)
def _jitted(method: str, **static):
    model = JaxFixedGate(JaxConfig(**SMALL))
    if method == "dense":
        return jax.jit(lambda v, r, d: model.apply(
            v, r, d, train=False, hard=True, return_weight=True, **static))
    return jax.jit(lambda v, r, d: model.apply(
        v, r, d, return_weight=True, method=getattr(model, method), **static))


def _jax(setup, method, paths, batch=8, **static):
    """(logits, weight) of the JAX model, paths through the gate override."""
    _, variables, _, inputs = setup
    v = {**variables, "test_paths": {"paths": jnp.asarray(paths, jnp.int32)}}
    out, w = _jitted(method, **static)(v, *inputs[batch])
    return np.asarray(out), np.asarray(w)


def _port(setup, method, paths, batch=8, **kw):
    _, _, tmodel, inputs = setup
    tmodel.paths = paths
    rgb, depth = (torch.from_numpy(a) for a in inputs[batch])
    with torch.no_grad():
        fwd = tmodel if method == "dense" else getattr(tmodel, method)
        kw = {"hard": True, **kw} if method == "dense" else kw
        out, w = fwd(rgb, depth, return_weight=True, **kw)
    return out.numpy(), w.numpy()


def _match(port, ref):
    (out, w), (ref_out, ref_w) = port, ref
    np.testing.assert_array_equal(w, ref_w)
    assert out.shape == ref_out.shape
    scale = np.abs(ref_out).max()
    assert scale > 0.1
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-4 * scale)


# ------------------------------------------------------------- compact
@pytest.mark.parametrize("paths", [
    [0, 0, 0, 0, 0, 0, 0, 0],
    [4, 4, 4, 4, 4, 4, 4, 4],
    [0, 4, 2, 1, 3, 0, 0, 2],
    [4, 0, 0, 0, 0, 0, 0, 0],
    [1, 1, 2, 2, 3, 3, 3, 1],
], ids=["all-cheap", "all-fuse", "mixed", "one-expensive", "no-zeros"])
def test_compact_matches_jax(setup, paths):
    method = "forward_routed_compact"
    _match(_port(setup, method, paths), _jax(setup, method, paths))
    # and, like the JAX model's, equals the dense hard forward
    _match(_port(setup, method, paths), _jax(setup, "dense", paths))


@pytest.mark.parametrize("caps", [(0, 2, 8), (0, 1, 2, 4, 8), (0, 4, 8)])
def test_compact_fine_ladders_match_jax(setup, caps):
    paths = [0, 4, 2, 1, 3, 0, 0, 2]
    method = "forward_routed_compact"
    _match(_port(setup, method, paths, caps=caps),
           _jax(setup, method, paths, caps=caps))


@pytest.mark.parametrize("ladders", [
    ((6, 8), (4, 8), (2, 8), (1, 8)),
    ((0, 8), (8,), (0, 8), (0, 8)),
    ((8,), (0, 4, 8), (2, 8), (0, 8)),
], ids=["matched", "mispredicted", "mixed-depth"])
def test_compact_per_stage_ladders_match_jax(setup, ladders):
    method = "forward_routed_compact"
    _match(_port(setup, method, MIXED, caps=ladders),
           _jax(setup, method, MIXED, caps=ladders))


@pytest.mark.parametrize("caps,overflows", [
    (((6,), (4,), (2,), (1,)), False),
    (((6,), (4,), (1,), (0,)), True),
], ids=["cover", "overflow"])
def test_compact_strict_caps_match_jax(setup, caps, overflows):
    method = "forward_routed_compact"
    port = _port(setup, method, MIXED, caps=caps, strict_caps=True)
    _match(port, _jax(setup, method, MIXED, caps=caps, strict_caps=True))
    dense = _jax(setup, "dense", MIXED)[0]
    zero_rows = [i for i, p in enumerate(MIXED) if p == 0]
    np.testing.assert_allclose(port[0][zero_rows], dense[zero_rows], rtol=0,
                               atol=1e-4 * np.abs(dense).max())
    assert np.allclose(port[0], dense, rtol=0, atol=1e-4) != overflows


@pytest.mark.parametrize("caps,match", [
    ((0, 4), "bs fallback rung"),
    (((8,), (8,), (8,)), "4 ladders"),
    ((0, 9), "outside"),
])
def test_compact_rejects_bad_ladders(setup, caps, match):
    """Where the JAX model asserts, the port raises."""
    with pytest.raises(ValueError, match=match):
        _port(setup, "forward_routed_compact", MIXED, caps=caps)


def test_compact_odd_batch_matches_jax(setup):
    paths = [4, 3, 0, 1, 4]
    method = "forward_routed_compact"
    _match(_port(setup, method, paths, batch=5),
           _jax(setup, method, paths, batch=5))


def test_compact_permutes_with_a_stable_sort():
    """Equal paths keep their batch order (``jnp.argsort`` is stable), so
    which participants overflow a strict rung matches the JAX model."""
    k = torch.tensor([2, 0, 2, 1, 2, 0, 1, 2])
    order = torch.argsort(-k, stable=True)
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(k.numpy()))))


# ------------------------------------------------------ batched switch
@pytest.mark.parametrize("force_path", [None, 1, 4])
def test_switch_batched_matches_jax(setup, force_path):
    paths = [2, 0, 1, 2, 0, 0, 1, 2]
    method = "forward_switch_batched"
    _match(_port(setup, method, paths, force_path=force_path),
           _jax(setup, method, paths, force_path=force_path))


def test_switch_batched_baseline_matches_jax(setup):
    method = "forward_switch_batched"
    port = _port(setup, method, None, baseline=True)
    _, variables, _, inputs = setup
    jmodel = jskip.SkipGateESANet(JaxConfig(**SMALL))
    ref = jax.jit(lambda v, r, d: jmodel.apply(
        v, r, d, baseline=True, return_weight=True,
        method=jmodel.forward_switch_batched))(variables, *inputs[8])
    _match(port, tuple(np.asarray(a) for a in ref))
    assert (port[1][:, 4] == 1).all()


# --------------------------------------------------------------- switch
@pytest.mark.parametrize("k", range(5))
def test_switch_matches_jax(setup, k):
    port = _port(setup, "forward_switch", [k], batch=1)
    _match(port, _jax(setup, "forward_switch", [k], batch=1))
    _match(port, _jax(setup, "dense", [k], batch=1))
    # force_path routes by its value and leaves the gate's weights
    forced = _port(setup, "forward_switch", [0], batch=1, force_path=k)
    np.testing.assert_array_equal(forced[1], np.eye(5, dtype=np.float32)[[0]])
    np.testing.assert_array_equal(forced[0], port[0])


def test_switch_rejects_batch_gt1(setup):
    with pytest.raises(ValueError, match="sample 0"):
        _port(setup, "forward_switch", MIXED)
    out, _ = _port(setup, "forward_switch", MIXED, force_path=2)
    assert out.shape == (8, 64, 64, 5)


# -------------------------------------------------------------- low_res
@pytest.mark.parametrize("method", ["dense", "forward_routed_compact"])
def test_low_res_matches_jax(setup, method):
    port = _port(setup, method, MIXED, low_res=True)
    assert port[0].shape == (8, 16, 16, 5)
    _match(port, _jax(setup, method, MIXED, low_res=True))


# ----------------------------------------------------- capacity ladders
@pytest.mark.parametrize("ratios,bs,factor", [
    ([0.0, 0.531, 0.469, 0.0, 0.0], 8, None),
    ([0.531, 0.0, 0.469, 0.0, 0.0], 8, None),
    ([0.0, 0.0, 0.0, 0.5, 0.5], 8, None),
    ([0.25, 0.25, 0.25, 0.125, 0.125], 8, None),
    ([0.0, 0.531, 0.469, 0.0, 0.0], 8, 1.25),
    ([0.9, 0.0, 0.0, 0.0, 0.1], 8, 1.0),
    ([0.25, 0.25, 0.25, 0.125, 0.125], 8, 1.25),
    ([0.1, 0.2, 0.3, 0.2, 0.2], 5, 1.5),
])
def test_capacity_ladders_match_jax(ratios, bs, factor):
    assert (skip_gate.capacity_ladders(ratios, bs, factor)
            == jskip.capacity_ladders(ratios, bs, factor))


def test_flop_tables_match_jax():
    for enc in ("resnet34", "resnet50"):
        np.testing.assert_array_equal(skip_gate.flop_table(enc),
                                      jskip.flop_table(enc))
        for key, table in jskip.FLOP_TABLES[
                "resnet34" if enc == "resnet34" else "resnet50"].items():
            np.testing.assert_array_equal(skip_gate.flop_table(enc, key), table)


def test_capacity_schedule_from_gate_only(setup):
    """Branch ratios of the mixed paths (1/4, 1/4, 1/4, 1/8, 1/8) through
    ``gate_only``, as predict.py's --capacity_factor estimates them."""
    _, _, tmodel, inputs = setup
    tmodel.paths = MIXED
    batches = [tuple(torch.from_numpy(a) for a in inputs[8])] * 2
    ratios = [0.25, 0.25, 0.25, 0.125, 0.125]
    assert capacity_schedule(tmodel, batches, 8) == jskip.capacity_ladders(
        ratios, 8)
    assert capacity_schedule(tmodel, batches, 8, 1.25) == (
        (8,), (5,), (3,), (2,))


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("cap", [0, 2, 5])
def test_scatter_rows_matches_jax(cap):
    rng = np.random.default_rng(cap)
    x = rng.standard_normal((5, 3, 4, 2)).astype(np.float32)
    order = np.array([3, 0, 4, 1, 2])
    port = routing.scatter_rows(torch.from_numpy(x[:cap]),
                                torch.from_numpy(order), 5)
    ref = jrouting.scatter_rows(jnp.asarray(x[:cap]), jnp.asarray(order), 5)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_permute_rows_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 3, 2)).astype(np.float32)
    perm = rng.permutation(6)
    port = routing.permute_rows(torch.from_numpy(x), torch.from_numpy(perm))
    np.testing.assert_array_equal(
        port.numpy(), np.asarray(jrouting.permute_rows(jnp.asarray(x),
                                                       jnp.asarray(perm))))


# ---------------------------------------------------------------- serve
def test_every_serve_mode_gives_the_dense_class_map(setup):
    _, _, tmodel, inputs = setup
    ref_logits, ref_w = _jax(setup, "dense", MIXED)
    for batch in (8, 1):
        paths = MIXED if batch == 8 else [3]
        tmodel.paths = paths
        rgb, depth = (torch.from_numpy(a) for a in inputs[batch])
        dense_map, dense_w = serve(tmodel, rgb, depth, mode="dense")
        if batch == 8:
            np.testing.assert_array_equal(dense_w.numpy(), ref_w)
            assert (dense_map.numpy() == ref_logits.argmax(-1)).mean() >= 0.999
        modes = [m for m in SERVE_MODES if m != "dense"
                 and (batch == 1 or not m.startswith("switch"))]
        for mode in modes:
            class_map, w = serve(tmodel, rgb, depth, mode=mode)
            assert class_map.dtype == torch.int32
            torch.testing.assert_close(w, dense_w, rtol=0, atol=0)
            torch.testing.assert_close(class_map, dense_map, rtol=0, atol=0)


def test_serve_low_res_repeats_the_quarter_map(setup):
    _, _, tmodel, inputs = setup
    tmodel.paths = MIXED
    rgb, depth = (torch.from_numpy(a) for a in inputs[8])
    class_map, _ = serve(tmodel, rgb, depth, mode="compact", low_res=True)
    low, _ = _jax(setup, "forward_routed_compact", MIXED, low_res=True)
    quarter = low.argmax(-1)
    assert class_map.shape == (8, 64, 64)
    np.testing.assert_array_equal(class_map.numpy()[:, ::4, ::4], quarter)
    np.testing.assert_array_equal(
        class_map.numpy(), quarter.repeat(4, axis=1).repeat(4, axis=2))


def test_serve_rejects_options_of_other_modes(setup):
    _, _, tmodel, inputs = setup
    rgb, depth = (torch.from_numpy(a) for a in inputs[1])
    with pytest.raises(ValueError, match="mode must be"):
        serve(tmodel, rgb, depth, mode="routed")
    with pytest.raises(ValueError, match="force_path"):
        serve(tmodel, rgb, depth, mode="compact", force_path=1)
    with pytest.raises(ValueError, match="caps"):
        serve(tmodel, rgb, depth, mode="batchmax", caps=(0, 1))
