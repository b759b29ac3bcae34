"""Shared set-up of the modality-level port tests: the three routers of
both packages on the same variables (the JAX model's tree, seeded values
for every leaf: kernels, biases, LayerNorm and BN affines, BN statistics,
so every layout rule shows), and seeded numpy inputs (MM-IMDB at its
widths, CMU-MOSEI at T = 12 with ragged lengths)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynmm_tpu.models import modality as jmod
from dynmm_tpu_torch.models import modality as tmod
from dynmm_tpu_torch.utils.weights import load_flax_variables

B, T = 8, 12
DIMS = {"imdb": (300, 4096), "mosei": (35, 74, 300)}
ROUTERS = {
    "imdb": (lambda: jmod.IMDBDynMMNet(dropout_rate=0.0),
             lambda: tmod.IMDBDynMMNet(dropout_rate=0.0)),
    "mosei": (jmod.MoseiDynMMNetV2, tmod.MoseiDynMMNetV2),
    "tribranch": (jmod.MoseiTriBranchDynMMNet, tmod.MoseiTriBranchDynMMNet),
}


def inputs(kind: str, b: int = B, seed: int = 0):
    """(inputs, lengths) as numpy float32 / int32; lengths None for IMDB.
    MOSEI lengths are ragged in [1, T], the first sample full."""
    rng = np.random.default_rng(seed)
    if kind == "imdb":
        return [rng.standard_normal((b, d)).astype(np.float32)
                for d in DIMS["imdb"]], None
    lengths = rng.integers(1, T + 1, size=b).astype(np.int32)
    lengths[0] = T
    xs = []
    for d in DIMS["mosei"]:
        x = rng.standard_normal((b, T, d)).astype(np.float32)
        x[np.arange(T)[None, :] >= lengths[:, None]] = 0.0
        xs.append(x)
    return xs, [lengths] * 3


def random_tree(shapes, rng):
    """Numpy float32 values for a flax variable tree of shapes: dense
    kernels normal with variance 1/fan_in (flax's ``lecun_normal`` scale;
    fan_in of an attention ``out`` kernel (H, D, out) is H·D, of a q/k/v
    kernel (in, H, D) its first axis), biases and BN means small normals,
    scales and BN variances uniform in [0.5, 1.5]."""

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        if name == "kernel":
            parent = path[-2].key
            fan_in = (shape[0] if parent in ("query", "key", "value")
                      else int(np.prod(shape[:-1])))
            x = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.standard_normal(shape)
        else:  # scale, var
            x = rng.uniform(0.5, 1.5, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(kind: str, seed: int = 0) -> dict:
    """Variables of the JAX router's own tree (``init`` traced with
    ``jax.eval_shape``; every submodule, the IMDB image branch too) with
    seeded values (``random_tree``)."""
    model = ROUTERS[kind][0]()
    xs, ls = inputs("mosei" if kind == "tribranch" else kind, b=2)
    xs = [jnp.asarray(x) for x in xs]
    if kind == "imdb":
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), xs, method=model.init_all))
    else:
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), xs, [jnp.asarray(l) for l in ls]))
    return random_tree(shapes, np.random.default_rng(seed))


def port_router(kind: str, variables: dict, dtype=torch.float32):
    model = ROUTERS[kind][1]()
    load_flax_variables(model, variables)
    return model.to(dtype).eval()


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def as_torch(xs, ls, dtype=torch.float32):
    return ([torch.from_numpy(x).to(dtype) for x in xs],
            None if ls is None else [torch.from_numpy(l).long() for l in ls])
