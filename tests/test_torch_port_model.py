"""The port's SkipGateESANet against the JAX model on the same weights.

A small config (64×64, resnet18 NonBottleneck1D encoders, decoder (32,32,32)
with one block each, SE-add, PPM, learned-3x3-zeropad) is initialised in
JAX, its biases and BN statistics randomised, carried across with
``state_dict_from_flax`` + strict load, and both models run the same numpy
inputs. On the CPU every kernel wrapper of the port takes its plain version,
so this holds the whole slice (stems, gate, fusion cells, encoders, PPM,
decoder, upsamples) and the weight packing against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.serve import serve
from dynmm_tpu_torch.utils.weights import load_flax_variables

SMALL = dict(
    height=64, width=64, num_classes=5,
    encoder_rgb="resnet18", encoder_depth="resnet18",
    encoder_block="NonBottleneck1D",
    channels_decoder=(32, 32, 32), nr_decoder_blocks=(1, 1, 1),
    fuse_depth_in_rgb_encoder="SE-add", context_module="ppm",
    upsampling="learned-3x3-zeropad",
)
BATCH = 3
SEED = 0


def _randomise(variables, rng):
    """Biases, BN affines and running stats away from their init values, so
    the folded-BN paths and the NBt1D boundary masks carry real values."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "bias":
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.0, x.shape).astype(np.float32)
        if name == "mean":
            return (rng.standard_normal(x.shape) * 0.1).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(SEED)
    rgb = rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    depth = rng.standard_normal((BATCH, 64, 64, 1)).astype(np.float32)
    jmodel = JaxSkipGate(JaxConfig(**SMALL))
    variables = jax.jit(lambda r, d: jmodel.init(
        jax.random.PRNGKey(0), r, d, train=False))(rgb, depth)
    variables = _randomise(variables, rng)
    apply = jax.jit(
        lambda v, r, d, hard: jmodel.apply(v, r, d, train=False, hard=hard,
                                           return_weight=True),
        static_argnums=3)
    jax_out = {hard: tuple(np.asarray(a) for a in apply(
        variables, jnp.asarray(rgb), jnp.asarray(depth), hard))
        for hard in (False, True)}

    tmodel = SkipGateESANet(ESANetConfig(**SMALL)).eval()
    load_flax_variables(tmodel, variables)
    return tmodel, torch.from_numpy(rgb), torch.from_numpy(depth), jax_out


def _run(tmodel, rgb, depth, hard):
    with torch.no_grad():
        out, w = tmodel(rgb, depth, hard=hard, return_weight=True)
    return out.numpy(), w.numpy()


@pytest.mark.parametrize("hard", [False, True])
def test_logits_match_jax(models, hard):
    tmodel, rgb, depth, jax_out = models
    out, _ = _run(tmodel, rgb, depth, hard)
    ref = jax_out[hard][0]
    assert out.shape == ref.shape == (BATCH, 64, 64, 5)
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)


def test_soft_gate_weights_match_jax(models):
    tmodel, rgb, depth, jax_out = models
    _, w = _run(tmodel, rgb, depth, hard=False)
    np.testing.assert_allclose(w, jax_out[False][1], rtol=0, atol=1e-5)


def test_hard_gate_choices_identical(models):
    tmodel, rgb, depth, jax_out = models
    soft = jax_out[False][1]
    top2 = np.sort(soft, axis=1)[:, -2:]
    # the seed gives every sample a clear gate decision
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    _, w = _run(tmodel, rgb, depth, hard=True)
    np.testing.assert_array_equal(w, jax_out[True][1])
    np.testing.assert_array_equal(w.argmax(1), soft.argmax(1))


def test_serve_class_map_matches_jax(models):
    tmodel, rgb, depth, jax_out = models
    reset_launches()
    class_map, w = serve(tmodel, rgb, depth)
    assert class_map.dtype == torch.int32 and class_map.shape == (BATCH, 64, 64)
    np.testing.assert_array_equal(w.numpy(), jax_out[True][1])
    ref = jax_out[True][0].argmax(-1)
    assert (class_map.numpy() == ref).mean() >= 0.999
    # CPU tensors take the plain versions: no kernel launch is counted
    assert sum(LAUNCHES.values()) == 0


def test_plain_path_equals_kernel_path_on_cpu(models):
    tmodel, rgb, depth, _ = models
    with torch.no_grad():
        a = tmodel(rgb, depth, hard=True)
        b = tmodel(rgb, depth, hard=True, use_kernels=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_baseline_and_gate_only(models):
    tmodel, rgb, depth, jax_out = models
    with torch.no_grad():
        _, w = tmodel(rgb, depth, baseline=True, return_weight=True)
        g = tmodel.gate_only(rgb, depth)
    assert (w[:, 4] == 1).all() and (w.sum(1) == 1).all()
    np.testing.assert_array_equal(g.numpy(), jax_out[True][1])
