"""Shared set-up of the port's segmentation-variant tests: small configs of
both packages (64×64, decoder (64, 32, 16) with one block each), seeded
random flax variables from ``jax.eval_shape`` (no init is compiled), the
port model loading them through the JAX package's ``export_state_dict``
with ``strict=True``, the JAX Gumbel draws handed to the port's local
gates, and seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.core.gates import sample_gumbel as jax_sample_gumbel
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.utils.torch_export import export_state_dict
from dynmm_tpu_torch.core import gates as port_gates
from dynmm_tpu_torch.models.esanet import ESANetConfig

H = W = 64
B = 2
CLASSES = 5
SMALL = dict(height=H, width=W, num_classes=CLASSES,
             encoder_rgb="resnet18", encoder_depth="resnet18",
             encoder_block="NonBottleneck1D", channels_decoder=(64, 32, 16),
             nr_decoder_blocks=(1, 1, 1), fuse_depth_in_rgb_encoder="SE-add",
             context_module="ppm", upsampling="learned-3x3-zeropad")
R50 = dict(SMALL, encoder_rgb="resnet50", encoder_depth="resnet50")
# XLA's backend at level 1 compiles these nets several times faster on the
# CPU than its default, which is most of the files' time
FAST_COMPILE = {"xla_backend_optimization_level": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while the module runs (the suite runs
    several workers on the CPU's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**over):
    """(JAX config, port config) of ``SMALL`` with ``over``."""
    kw = dict(SMALL, **over)
    return JaxConfig(**kw), ESANetConfig(**kw)


def inputs(seed: int = 0, b: int = B):
    """Seeded (rgb, depth) NHWC float32 numpy images."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, H, W, 3)).astype(np.float32),
            rng.standard_normal((b, H, W, 1)).astype(np.float32))


def fast_jit(fn):
    """``jax.jit(fn)`` compiled at ``FAST_COMPILE``, once for each tree and
    shapes of its arguments."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), np.result_type(a)) for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=FAST_COMPILE)
        return compiled[key](*args)

    return call


def random_variables(init, seed: int = 0) -> dict:
    """{"params", "batch_stats"} of ``init`` (a function returning a flax
    variable tree, traced with ``jax.eval_shape``), numpy float32:
    He-normal kernels, small random biases, BN affines and statistics away
    from identity."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            x = rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
        elif name in ("bias", "mean"):
            x = rng.standard_normal(s.shape) * 0.1
        elif name == "scale":
            x = rng.uniform(0.5, 1.0, s.shape)
        else:  # var
            x = rng.uniform(0.5, 1.5, s.shape)
        return x.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats", {})}


def load_exported(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """``model`` with the JAX package's ``export_state_dict`` of
    ``variables`` loaded strictly."""
    sd = export_state_dict(variables["params"], variables["batch_stats"])
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return model


def assert_logits_close(out, ref, rel: float = 1e-4):
    """fp32 logits within ``rel`` of the reference's largest magnitude."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * scale)


def jax_gumbel_draws(rng_key, batch: int, n_gates: int = 4,
                     dtype=jnp.float32):
    """The Gumbel noise the JAX SkipESANet's gates draw from ``rng_key``
    (``jax.random.split(key, 4)``, gate i from key i, (batch, 2))."""
    keys = jax.random.split(rng_key, 4)
    return [np.asarray(jax_sample_gumbel(keys[i], (batch, 2), dtype))
            for i in range(n_gates)]


class GumbelFromJax:
    """Hands the port's ``sample_gumbel`` the queued JAX draws in order (the
    gates draw 0..3 in the JAX order)."""

    def __init__(self, monkeypatch, draws):
        self.draws = list(draws)
        monkeypatch.setattr(port_gates, "sample_gumbel", self)

    def __call__(self, shape, generator, dtype=torch.float32, device=None):
        g = self.draws.pop(0)
        assert tuple(shape) == g.shape
        return torch.tensor(g, dtype=dtype, device=device)
