"""The port's bf16 serving path against the JAX package at bf16.

Parameters stay fp32 in both packages; maps are bf16. On the CPU every
kernel wrapper of the port takes its bf16 plain version, which rounds where
the CUDA kernel rounds (``tests/test_torch_port_emulated.py`` holds the
kernels against it). The JAX side runs its modules at ``dtype=bfloat16``
and its Pallas functions in interpret mode on bf16 maps. Tolerances are
fractions of max |reference|; one bf16 step at the top binade is 2^-8 of it
(3.9e-3):

* the plain versions against the Pallas functions: the stem bit-identical
  (both round ``rgb·s_r``, ``depth·s_d`` and the sum to bf16 op by op),
  the fp32 sums 1e-5 (summation order), the SE cell 8e-3 (the fp32 mean's
  order moves a rounding), the upsample 1e-2 (the Pallas function adds
  taps and products in bf16, the port in fp32 with one rounding);
* modules against the JAX modules at bf16: 2e-2 (8.7e-3 measured). The
  JAX SE MLP runs on bf16 weights where the port's runs in fp32 (the
  Pallas ``fused_se``'s choice), XLA rounds a conv's sum before its bias,
  and a block chains several roundings;
* the whole net: gate weights identical, and identical to the fp32 net's
  (the gate computes in fp32); logits within 5e-2 of max |JAX fp32
  logits|, the JAX package's own bound for bf16
  (``tests/test_routed_compact.py``); routed requests equal to the dense
  bf16 forward on the same paths within 8e-3 (exact in practice: the same
  ops on the same rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.kernels import se as jse
from dynmm_tpu.kernels import stem_fuse as jsf
from dynmm_tpu.kernels import upsample as jup
from dynmm_tpu.models import context as jctx
from dynmm_tpu.models import skip_gate as jskip
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.resnet import NonBottleneck1D as JaxNBt1D
from dynmm_tpu.models.resnet import space_to_depth_host
from dynmm_tpu.nn import layers as jl
from dynmm_tpu_torch.kernels import (LAUNCHES, nbt1d, reset_launches, se,
                                     stem_fuse, upsample)
from dynmm_tpu_torch.models import context
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.nn import layers
from dynmm_tpu_torch.serve import serve
from dynmm_tpu_torch.utils.weights import load_flax_variables
from tests._port_variants_setup import fast_jit
from tests.test_torch_port_layers import _flax, _port
from tests.test_torch_port_model import SMALL, _randomise
from tests.test_torch_port_routed import MIXED, FixedGate, JaxFixedGate

BF = torch.bfloat16
MODULE_TOL = 2e-2
NET_TOL = 5e-2
ROUTED_TOL = 8e-3


def _t16(x) -> torch.Tensor:
    """numpy/JAX values → a bf16 tensor (exact for bf16 values)."""
    return torch.from_numpy(np.asarray(x, np.float32).copy()).to(BF)


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


def _bf16_module(module):
    layers.set_compute_dtype(module, BF)
    return module


def _nchw16(x) -> torch.Tensor:
    return _t16(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


# ---------------------------------------- plain versions vs Pallas, bf16
@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(21)
    r = jnp.asarray(rng.standard_normal((2, 16, 24, 64)), jnp.bfloat16)
    d = jnp.asarray(rng.standard_normal((2, 16, 24, 64)), jnp.bfloat16)
    return rng, r, d


def test_channel_sums_plain_matches_pallas(maps):
    _, r, d = maps
    ref = jsf.channel_sums(r, d, interpret=True)
    out = se.channel_sums_plain(_t16(r), _t16(d))
    for o, ref_o in zip(out, ref):
        assert o.dtype == torch.float32
        assert _rel(o, ref_o) <= 1e-5


def test_stem_fuse_pool_plain_bit_identical_to_pallas(maps):
    rng, r, d = maps
    s_r, s_d = (jnp.asarray(rng.uniform(size=(2, 64)), jnp.bfloat16)
                for _ in range(2))
    ref = jsf.fused_stem_fusion(r, d, s_r, s_d, interpret=True)
    out = stem_fuse.stem_fuse_pool_plain(_t16(r), _t16(d), _t16(s_r),
                                         _t16(s_d))
    for o, ref_o in zip(out, ref):
        assert o.dtype == BF
        np.testing.assert_array_equal(_f32(o), _f32(ref_o))


def test_se_plain_matches_pallas(maps):
    rng, r, _ = maps
    c, cr = 64, 4
    w = [(rng.standard_normal((c, cr)) / 8).astype(np.float32),
         (rng.standard_normal(cr) * 0.1).astype(np.float32),
         (rng.standard_normal((cr, c)) / 2).astype(np.float32),
         (rng.standard_normal(c) * 0.1).astype(np.float32)]
    x = r.reshape(2, -1, c)
    ref = jse.fused_se(x, *w, interpret=True)
    out = se.se_reference(_t16(x), *map(torch.from_numpy, w))
    assert out.dtype == BF and ref.dtype == jnp.bfloat16
    assert _rel(out, ref) <= 8e-3


def test_learned_upsample_plain_matches_pallas(maps):
    rng, r, _ = maps
    taps = jnp.asarray(rng.standard_normal((3, 3, 64)) * 0.3, jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(64) * 0.1, jnp.bfloat16)
    ref = jup.fused_learned_upsample(r, taps, bias, interpret=True)
    out = upsample.learned_upsample_plain(_t16(r), _t16(taps), _t16(bias))
    assert out.dtype == BF
    assert _rel(out, ref) <= 1e-2


def test_nbt1d_kernels_take_no_bf16(monkeypatch):
    """A bf16 map never reaches the NBt1D kernels: the wrappers raise on
    one (as on the card, which ``on_card`` pretends) instead of converting
    it."""
    from dynmm_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "on_card", lambda *t: True)
    x = torch.zeros(1, 2, 2, 4, dtype=BF)
    p = [torch.zeros(3, 4, 4), torch.zeros(4)] * 2 + [torch.ones(4),
                                                      torch.zeros(4)]
    with pytest.raises(TypeError, match="no bf16 form"):
        nbt1d.nbt1d_pair(x, *p)
    with pytest.raises(TypeError, match="no bf16 form"):
        nbt1d.nbt1d_fused(x, *p, *p)


# ----------------------------------------------------- modules vs JAX bf16
def test_nonbottleneck1d_bf16_matches_jax():
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 8, 10, 16)).astype(np.float32)
    jm = JaxNBt1D(16, dtype=jnp.bfloat16)
    v = _flax(jm, rng, x)
    tm = _bf16_module(_port(NonBottleneck1D(16, 16), v))
    assert tm.fusable and not tm.fused  # the unfused convs, in bf16
    ref = jm.apply(v, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = tm(_nchw16(x))
    assert out.dtype == BF
    assert _rel(_nhwc(out), ref) <= MODULE_TOL


def test_se_fusion_cell_bf16_matches_jax():
    rng = np.random.default_rng(23)
    rgb, depth = (rng.standard_normal((3, 6, 8, 32)).astype(np.float32)
                  for _ in range(2))
    jm = jl.SqueezeAndExciteFusionAdd(32, dtype=jnp.bfloat16)
    v = _flax(jm, rng, rgb, depth)
    tm = _bf16_module(_port(layers.SqueezeAndExciteFusionAdd(32), v))
    w = np.array([0.0, 0.4, 1.0], np.float32)
    r16, d16 = (jnp.asarray(a, jnp.bfloat16) for a in (rgb, depth))
    ref = jm.apply(v, r16, d16, w, method="fuse_mixed")
    with torch.no_grad():
        out = tm.fuse_mixed(_nchw16(rgb), _nchw16(depth), torch.from_numpy(w))
        unmixed = tm(_nchw16(rgb), _nchw16(depth), use_kernels=False)
        mixed0 = tm.fuse_mixed(_nchw16(rgb), _nchw16(depth), torch.zeros(3))
    assert out.dtype == BF
    assert _rel(_nhwc(out), ref) <= MODULE_TOL
    # the unmixed plain cell is the mixed one at w = 0, bit for bit
    torch.testing.assert_close(unmixed, mixed0, rtol=0, atol=0)


def test_upsample_bf16_matches_jax():
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    jm = jl.Upsample(mode="learned-3x3-zeropad", channels=8,
                     dtype=jnp.bfloat16)
    v = _flax(jm, rng, x)
    tm = _bf16_module(_port(layers.Upsample("learned-3x3-zeropad", 8), v))
    assert tm.taps.dtype == BF
    ref = jm.apply(v, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = tm(_nchw16(x))
    assert out.dtype == BF
    assert _rel(_nhwc(out), ref) <= MODULE_TOL


def test_pyramid_pooling_bf16_matches_jax():
    rng = np.random.default_rng(25)
    x = rng.standard_normal((2, 15, 20, 16)).astype(np.float32)
    jm = jctx.PyramidPoolingModule(8, upsampling_mode="nearest",
                                   dtype=jnp.bfloat16)
    v = _flax(jm, rng, x)
    tm = _bf16_module(_port(context.PyramidPoolingModule(16, 8), v))
    ref = jm.apply(v, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = tm(_nchw16(x))
    assert out.dtype == BF
    assert _rel(_nhwc(out), ref) <= MODULE_TOL


def test_first_argmax_bf16_matches_jax():
    rng = np.random.default_rng(26)
    x = rng.standard_normal((5, 40, 6)).astype(np.float32)
    x[1, 3:7] = x[1].max() + 1  # ties go to the first index
    x16 = jnp.asarray(x, jnp.bfloat16)
    out = layers.first_argmax(_t16(x16), dim=1)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jl.first_argmax(x16, axis=1)))


# -------------------------------------------------------- the whole net
@pytest.fixture(scope="module")
def net():
    """The SMALL net's JAX variables, the port's bf16 twin (live gate and
    the gate override), and inputs: B=3 (the seed of
    ``test_torch_port_model.py``, whose gate decisions are clear) and B=8."""
    rng = np.random.default_rng(0)
    live = (rng.standard_normal((3, 64, 64, 3)).astype(np.float32),
            rng.standard_normal((3, 64, 64, 1)).astype(np.float32))
    jmodel = jskip.SkipGateESANet(JaxConfig(**SMALL))
    variables = jax.jit(lambda r, d: jmodel.init(
        jax.random.PRNGKey(0), r, d, train=False))(*live)
    variables = _randomise(variables, rng)
    rng8 = np.random.default_rng(11)
    big = (rng8.standard_normal((8, 64, 64, 3)).astype(np.float32),
           rng8.standard_normal((8, 64, 64, 1)).astype(np.float32))
    tmodel = FixedGate(ESANetConfig(**SMALL, dtype=BF)).eval()
    load_flax_variables(tmodel, variables)
    return variables, tmodel, live, big


def _jax_dense(variables, inputs, dtype, paths=None):
    cls = jskip.SkipGateESANet if paths is None else JaxFixedGate
    model = cls(JaxConfig(**SMALL, dtype=dtype))
    if paths is not None:
        variables = {**variables,
                     "test_paths": {"paths": jnp.asarray(paths, jnp.int32)}}
    fn = fast_jit(lambda v, r, d: model.apply(
        v, r, d, train=False, hard=True, return_weight=True))
    out, w = fn(variables, *inputs)
    return _f32(out), np.asarray(w)


def _port_run(tmodel, method, inputs, paths=None, **kw):
    tmodel.paths = paths
    rgb, depth = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        if method == "dense":
            out, w = tmodel(rgb, depth, hard=True, return_weight=True, **kw)
        else:
            out, w = getattr(tmodel, method)(rgb, depth, return_weight=True,
                                             **kw)
    return out, _f32(w)


def test_live_gate_and_logits_match_jax(net):
    variables, tmodel, live, _ = net
    ref32, w32 = _jax_dense(variables, live, None)
    ref16, w16 = _jax_dense(variables, live, jnp.bfloat16)
    out, w = _port_run(tmodel, "dense", live)
    assert out.dtype == BF and w.dtype == np.float32
    np.testing.assert_array_equal(w16, w32)  # the JAX gate computes in fp32
    np.testing.assert_array_equal(w, w16)
    scale = np.abs(ref32).max()
    assert scale > 0.1
    assert _rel(out, ref32, scale) < NET_TOL
    assert _rel(out, ref16, scale) < NET_TOL
    # serve() takes the fp32 images and serves the bf16 net
    reset_launches()
    class_map, w_served = serve(tmodel, *(torch.from_numpy(a) for a in live),
                                mode="dense")
    np.testing.assert_array_equal(w_served.numpy(), w16)
    assert class_map.dtype == torch.int32
    np.testing.assert_array_equal(class_map.numpy(),
                                  layers.first_argmax(out).numpy())
    assert sum(LAUNCHES.values()) == 0  # CPU tensors: the plain versions


def test_stems_raw_and_packed_match_jax(net):
    """Both stems (7×7/2 conv on the images, and the 4×4 conv on the 2×2
    packed ones) and the stem cell, bf16 against the JAX bf16 model."""
    variables, tmodel, live, _ = net
    jmodel = jskip.SkipGateESANet(JaxConfig(**SMALL, dtype=jnp.bfloat16))
    stems = fast_jit(lambda v, r, d: jmodel.apply(v, r, d, False,
                                                  method=jmodel._stems))
    packed = tuple(space_to_depth_host(a) for a in live)
    for inputs in (live, packed):
        ref = stems(variables, *inputs)
        with torch.no_grad():
            out = tmodel._stems(*(torch.from_numpy(a) for a in inputs))
        for o, r in zip(out, ref):
            assert o.dtype == BF
            assert _rel(_nhwc(o), r) <= MODULE_TOL


@pytest.mark.parametrize("method, batch, kw", [
    ("forward_switch_batched", 8, {}),
    ("forward_routed_compact", 8, {}),
    ("forward_routed_compact", 8,
     {"caps": ((6,), (2,), (2,), (1,)), "strict_caps": True}),
    ("forward_switch", 1, {}),
], ids=["batchmax", "compact", "compact-strict", "switch"])
def test_routed_bf16_matches_dense_and_jax(net, method, batch, kw):
    """Fixed per-sample paths (the gate override of
    ``test_torch_port_routed.py``): each routed request equals the port's
    dense bf16 forward on the same paths (overflowed strict rows lose
    their depth term in both packages) and the JAX bf16 strategy."""
    variables, tmodel, _, big = net
    inputs = tuple(a[:batch] for a in big)
    paths = MIXED[:batch] if batch > 1 else [3]
    ref32, _ = _jax_dense(variables, inputs, None, paths)
    scale = np.abs(ref32).max()
    jmodel = JaxFixedGate(JaxConfig(**SMALL, dtype=jnp.bfloat16))
    v = {**variables, "test_paths": {"paths": jnp.asarray(paths, jnp.int32)}}
    static = {k: v_ for k, v_ in kw.items()}
    jfn = fast_jit(lambda v, r, d: jmodel.apply(
        v, r, d, return_weight=True, method=getattr(jmodel, method),
        **static))
    ref, w_ref = jfn(v, *inputs)
    out, w = _port_run(tmodel, method, inputs, paths, **kw)
    np.testing.assert_array_equal(w, _f32(w_ref))
    assert _rel(out, ref, scale) < NET_TOL
    if not kw.get("strict_caps"):
        dense, w_d = _port_run(tmodel, "dense", inputs, paths)
        np.testing.assert_array_equal(w, w_d)
        assert _rel(out, dense) <= ROUTED_TOL
