"""Shared set-up of the port's training tests: the small SkipGateESANet of
both packages, seeded random flax variables (from ``jax.eval_shape``, so no
init is compiled), the port model carrying them, and seeded synthetic
batches."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset
from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.utils.weights import load_flax_variables

H, W, B, CLASSES = 64, 96, 2, 5
# XLA's CPU backend spends ~40 s optimising this net's float64 gradient at
# its default level 3 and ~6 s at level 1 (same results; the program runs in
# 0.5 s either way)
FAST_COMPILE = {"xla_backend_optimization_level": 1}
SMALL = dict(
    height=H, width=W, num_classes=CLASSES,
    encoder_rgb="resnet18", encoder_depth="resnet18",
    encoder_block="NonBottleneck1D",
    channels_decoder=(32, 32, 32), nr_decoder_blocks=(1, 1, 1),
    fuse_depth_in_rgb_encoder="SE-add", context_module="ppm",
    upsampling="learned-3x3-zeropad",
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while the module runs: the suite runs
    several workers on the CPU's cores, and torch's OpenMP threads spinning
    beside other processes slow every worker several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model() -> JaxSkipGate:
    return JaxSkipGate(JaxConfig(**SMALL))


@functools.lru_cache(maxsize=1)
def variable_shapes():
    """The small model's variable tree of ShapeDtypeStructs (traced once)."""
    return jax.eval_shape(lambda: jax_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), train=False))


def random_variables(seed: int = 0) -> dict:
    """{"params", "batch_stats"} of the small model, numpy float32: He-normal
    kernels, small random biases, BN affines and statistics away from
    identity."""
    shapes = variable_shapes()
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
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def port_model(variables: dict, dtype=torch.float32) -> SkipGateESANet:
    model = SkipGateESANet(ESANetConfig(**SMALL))
    load_flax_variables(model, variables)
    return model.to(dtype)


def batches(n: int = 3, phase: str = "train", seed: int = 0, h: int = H,
            w: int = W) -> list[dict]:
    """``n`` preprocessed synthetic batches of ``B`` at h×w (labels
    0..CLASSES)."""
    ds = SyntheticSegDataset(n=n * B, height=h, width=w, n_classes=CLASSES,
                             seed=seed, split=phase, mixed_modality_frac=0.5)
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, h, w, phase=phase)
    return list(SegLoader(ds, pre, batch_size=B, shuffle=phase == "train",
                          drop_last=phase == "train", seed=seed, prefetch=0))


def as_f64(batch: dict) -> dict:
    out = dict(batch)
    out["image"] = batch["image"].astype(np.float64)
    out["depth"] = batch["depth"].astype(np.float64)
    return out


def class_weights(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.5, 2.0, CLASSES).astype(
        np.float32)


def leaf_errors(got: dict, want: dict, floor: float = 0.0) -> dict:
    """{path: max|got − want| / max(max|want|, floor)} over two nested trees
    of arrays with the same keys."""
    out = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, path
        out[path] = float(np.abs(a - b).max()
                          / max(np.abs(b).max(), floor, 1e-300))

    walk(got, want, "")
    return out


def compile_fast(jitted, *args):
    """``jitted`` lowered for ``args`` and compiled at ``FAST_COMPILE``."""
    return jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
