"""The port's building blocks against the JAX modules on the same weights.

Each flax module is initialised, every leaf randomised (kernels, biases, BN
affines and statistics), and carried across with ``load_flax_variables``;
both sides run the same numpy inputs. Modules take NCHW in the port, so
inputs and outputs are permuted at the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.core import gates as jgates
from dynmm_tpu.models import context as jctx
from dynmm_tpu.models.resnet import NonBottleneck1D as JaxNBt1D
from dynmm_tpu.models.skip_gate import GlobalGate as JaxGlobalGate
from dynmm_tpu.nn import layers as jl
from dynmm_tpu_torch.core import gates
from dynmm_tpu_torch.models import context
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.models.skip_gate import GlobalGate
from dynmm_tpu_torch.nn import layers
from dynmm_tpu_torch.utils.weights import load_flax_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flax(module, rng, *args, **kwargs):
    """Init ``module`` and randomise every leaf."""
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)

    def leaf(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        scale = 0.3 if name == "kernel" else 0.1
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _port(module, variables):
    """Load flax ``variables`` into the port's ``module``. The tree is
    nested under one name, as inside a model, so the key rules that need a
    parent (``.ds_conv.``, ``.feature0.``, ``gate_layer.conv1.``) apply."""
    name = "gate_layer" if isinstance(module, GlobalGate) else "m"
    nested = {k: {name: v} for k, v in variables.items()}
    load_flax_variables(torch.nn.ModuleDict({name: module}), nested)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _close(port_nchw, ref, **tol):
    np.testing.assert_allclose(port_nchw.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------- fusion
def _fusion(rng, c=32):
    rgb, depth = _np(rng, 3, 6, 8, c), _np(rng, 3, 6, 8, c)
    jm = jl.SqueezeAndExciteFusionAdd(c)
    v = _flax(jm, rng, rgb, depth)
    return jm, v, _port(layers.SqueezeAndExciteFusionAdd(c), v), rgb, depth


def test_fuse_mixed_matches_jax():
    rng = np.random.default_rng(0)
    jm, v, tm, rgb, depth = _fusion(rng)
    w = np.array([0.0, 0.4, 1.0], np.float32)
    ref = jm.apply(v, rgb, depth, w, method="fuse_mixed")
    with torch.no_grad():
        out = tm.fuse_mixed(_nchw(rgb), _nchw(depth), torch.from_numpy(w))
    _close(out, ref)


def test_fuse_and_pool_matches_jax():
    rng = np.random.default_rng(1)
    jm, v, tm, rgb, depth = _fusion(rng, c=64)
    ref = jm.apply(v, rgb, depth, method="fuse_and_pool")
    with torch.no_grad():
        out = tm.fuse_and_pool(_nchw(rgb), _nchw(depth))
    for o, r in zip(out, ref):
        _close(o, r)


def test_se_module_forward_and_scale_match_jax():
    rng = np.random.default_rng(2)
    x = _np(rng, 2, 5, 7, 32)
    jm = jl.SqueezeAndExcitation(32)
    v = _flax(jm, rng, x)
    tm = _port(layers.SqueezeAndExcitation(32), v)
    with torch.no_grad():
        _close(tm(_nchw(x)), jm.apply(v, x))
        np.testing.assert_allclose(
            tm.map_scale(_nchw(x)).numpy(),
            np.asarray(jm.apply(v, x, method="scale")), **TOL)


# -------------------------------------------------------------- upsample
@pytest.mark.parametrize("mode", ["learned-3x3-zeropad", "learned-3x3",
                                  "nearest", "bilinear"])
def test_upsample_matches_jax(mode):
    rng = np.random.default_rng(3)
    x = _np(rng, 2, 5, 6, 8)
    jm = jl.Upsample(mode=mode, channels=8)
    v = _flax(jm, rng, x)
    tm = _port(layers.Upsample(mode, 8), v)
    with torch.no_grad():
        _close(tm(_nchw(x)), jm.apply(v, x))


def test_resize_nearest_fractional_matches_jax():
    """PPM's 5×5 → 15×20 resize: a non-integer ratio, exact integer index."""
    rng = np.random.default_rng(4)
    x = _np(rng, 2, 5, 5, 3)
    out = layers.resize_nearest(torch.from_numpy(x), (15, 20))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jl.resize_nearest(x, (15, 20))))


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(5)
    x = _np(rng, 1, 5, 5, 3)
    out = layers.resize_bilinear(torch.from_numpy(x), (15, 20))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jl.resize_bilinear(x, (15, 20))),
                               **TOL)


@pytest.mark.parametrize("size,out", [((15, 20), (5, 5)), ((2, 2), (5, 5)),
                                      ((15, 20), (1, 1))])
def test_adaptive_avg_pool2d_matches_jax(size, out):
    rng = np.random.default_rng(6)
    x = _np(rng, 2, *size, 4)
    np.testing.assert_allclose(
        context.adaptive_avg_pool2d(torch.from_numpy(x), out).numpy(),
        np.asarray(jctx.adaptive_avg_pool2d(jnp.asarray(x), out)), **TOL)


def test_first_argmax_ties_go_first():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (4, 6, 5)).astype(np.float32)  # many ties
    out = layers.first_argmax(torch.from_numpy(x))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jl.first_argmax(jnp.asarray(x))))
    np.testing.assert_array_equal(
        layers.first_argmax(torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]])),
        [1, 0])


# ----------------------------------------------------------------- gates
def test_diff_softmax_matches_jax():
    rng = np.random.default_rng(8)
    logits = _np(rng, 6, 5)
    for hard in (False, True):
        out = gates.diff_softmax(torch.from_numpy(logits), tau=0.7, hard=hard)
        ref = jgates.diff_softmax(jnp.asarray(logits), tau=0.7, hard=hard)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_hard_gate_has_soft_gradient():
    logits = torch.randn(4, 5, requires_grad=True)
    g = torch.randn(4, 5)
    (gates.diff_softmax(logits, hard=True) * g).sum().backward()
    hard_grad = logits.grad.clone()
    logits.grad = None
    (gates.diff_softmax(logits, hard=False) * g).sum().backward()
    torch.testing.assert_close(hard_grad, logits.grad)


def test_hard_one_hot_ties_go_first():
    y = torch.tensor([[0.2, 0.4, 0.4], [0.5, 0.5, 0.0]])
    torch.testing.assert_close(gates.hard_one_hot(y),
                               torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]))


def test_gumbel_softmax_takes_a_generator():
    logits = torch.randn(8, 5)
    a = gates.gumbel_softmax(logits, torch.Generator().manual_seed(3),
                             hard=True)
    b = gates.gumbel_softmax(logits, torch.Generator().manual_seed(3),
                             hard=True)
    torch.testing.assert_close(a, b)
    assert ((a == 0) | (a == 1)).all() and (a.sum(1) == 1).all()
    soft = gates.gumbel_softmax(logits, torch.Generator().manual_seed(4))
    torch.testing.assert_close(soft.sum(1), torch.ones(8))


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("stride", [1, 2])
def test_nonbottleneck1d_matches_jax(stride):
    """Stride 1 takes the packed two-pair path (kernel site); stride 2 with
    its downsample stays plain torch convs."""
    rng = np.random.default_rng(9 + stride)
    c_in, c = (16, 16) if stride == 1 else (8, 16)
    x = _np(rng, 2, 8, 10, c_in)
    jm = JaxNBt1D(c, stride=stride, has_downsample=stride != 1)
    v = _flax(jm, rng, x)
    tm = _port(NonBottleneck1D(c_in, c, stride=stride,
                               has_downsample=stride != 1), v)
    assert tm.fused == (stride == 1)
    with torch.no_grad():
        _close(tm(_nchw(x)), jm.apply(v, x), rtol=1e-5, atol=2e-5)


def test_global_gate_matches_jax():
    rng = np.random.default_rng(11)
    rgb, depth = _np(rng, 3, 16, 16, 64), _np(rng, 3, 16, 16, 64)
    jm = JaxGlobalGate()
    v = _flax(jm, rng, rgb, depth)
    tm = _port(GlobalGate(), v)
    with torch.no_grad():
        out = tm(_nchw(rgb), _nchw(depth), temp=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(v, rgb, depth)),
                               **TOL)


@pytest.mark.parametrize("hw", [(15, 20), (2, 2)])
def test_pyramid_pooling_matches_jax(hw):
    rng = np.random.default_rng(12)
    x = _np(rng, 2, *hw, 16)
    jm = jctx.PyramidPoolingModule(8, upsampling_mode="nearest")
    v = _flax(jm, rng, x)
    tm = _port(context.PyramidPoolingModule(16, 8), v)
    with torch.no_grad():
        _close(tm(_nchw(x)), jm.apply(v, x))


def test_conv_bn_act_matches_jax():
    rng = np.random.default_rng(13)
    x = _np(rng, 2, 7, 9, 8)
    jm = jl.ConvBNAct(12, 3)
    v = _flax(jm, rng, x)
    tm = _port(layers.ConvBNAct(8, 12, 3), v)
    with torch.no_grad():
        _close(tm(_nchw(x)), jm.apply(v, x))
