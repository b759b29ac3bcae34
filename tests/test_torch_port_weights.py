"""The weight bridge, the import guard and the device rule of the port.

* The full flagship's flax key set and shapes load strictly into the port's
  module (variables from ``jax.eval_shape`` of ``init`` at 480×640, as
  ``__graft_entry__.entry`` gets them, so nothing is computed).
* The port's copy of the key rules agrees with ``torch_export``.
* No file of the port, nor ``chip_smoke.py``, imports JAX, flax or the JAX
  package.
* Entry points without a device raise when there is no card.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from dynmm_tpu.utils.torch_export import export_state_dict, flax_to_torch_key
from dynmm_tpu_torch import serve as serve_mod
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.utils import weights
from dynmm_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def flagship_shapes():
    model = _flagship(480, 640)
    x = jnp.zeros((1, 480, 640, 3), jnp.float32)
    d = jnp.zeros((1, 480, 640, 1), jnp.float32)
    return jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, d, train=False))


def _zeros(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


def test_flagship_key_set_and_shapes_load_strictly(flagship_shapes):
    variables = _zeros(flagship_shapes)
    sd = weights.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    port = SkipGateESANet(ESANetConfig())
    own = port.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    for k in ("encoder_rgb.layer1.0.conv3x1_1.weight",
              "encoder_rgb.layer2.0.downsample.1.running_var",
              "se_layer0.se_rgb.fc.0.weight", "skip_layer1.0.conv.weight",
              "context_module.features.0.1.conv.weight",
              "decoder.decoder_module_1.decoder_blocks.0.conv1x3_2.bias",
              "decoder.decoder_module_3.side_output.weight"):
        assert k in own
    assert tuple(own["gate_layer.conv.0.weight"].shape) == (8, 128, 5, 5)
    assert tuple(own["gate_layer.fc.weight"].shape) == (5, 8, 1, 1)
    assert not any("num_batches_tracked" in k for k in own)
    port.load_state_dict(sd, strict=True)


def test_key_rules_agree_with_torch_export(flagship_shapes):
    flat = jax.tree_util.tree_flatten_with_path(flagship_shapes)[0]
    for path, _ in flat:
        key = ".".join(p.key for p in path[1:])
        assert weights.flax_to_torch_key(key) == flax_to_torch_key(key)


def test_values_and_layouts_agree_with_torch_export():
    rng = np.random.default_rng(0)
    params = {"encoder_rgb": {
        "conv1": {"kernel": rng.standard_normal((7, 7, 3, 64))},
        "layer1": {"block0": {"bn1": {"scale": rng.standard_normal(64),
                                      "bias": rng.standard_normal(64)}}}},
        "gate_layer": {"fc": {"kernel": rng.standard_normal((1, 1, 8, 5))}},
        "dense": {"kernel": rng.standard_normal((4, 6))}}
    stats = {"encoder_rgb": {"layer1": {"block0": {"bn1": {
        "mean": rng.standard_normal(64), "var": rng.random(64)}}}}}
    ours = weights.state_dict_from_flax(params, stats)
    ref = export_state_dict(params, stats)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_load_repacks_kernel_weights():
    """Kernel-layout copies follow every load_state_dict."""
    blk = torch.nn.ModuleDict({"b": NonBottleneck1D(8, 8)})
    sd = {k: torch.randn(v.shape) for k, v in blk.state_dict().items()}
    sd["b.bn1.running_var"] = sd["b.bn1.running_var"].abs() + 0.5
    blk.load_state_dict(sd, strict=True)
    m = blk["b"]
    torch.testing.assert_close(
        m.w1, sd["b.conv3x1_1.weight"][:, :, :, 0].permute(2, 1, 0))
    torch.testing.assert_close(
        m.w4, sd["b.conv1x3_2.weight"][:, :, 0, :].permute(2, 1, 0))
    s = sd["b.bn1.weight"] / torch.sqrt(sd["b.bn1.running_var"] + 1e-3)
    torch.testing.assert_close(m.s1, s)
    torch.testing.assert_close(m.t1, sd["b.bn1.bias"]
                               - sd["b.bn1.running_mean"] * s)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    """JAX, flax, the JAX package, and what the card lacks (msgpack, cv2,
    orbax, tensorstore)."""
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib", "flax", "msgpack", "cv2", "orbax",
                    "tensorstore")
            or top == "dynmm_tpu")


def test_port_imports_no_jax():
    files = sorted((REPO / "dynmm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if _forbidden(m)]
    assert bad == []
    # the guard tells the package's own name from the JAX package's
    assert not _forbidden("dynmm_tpu_torch.kernels")
    assert not _forbidden("dynmm_tpu_torch.utils.msgpack")
    assert _forbidden("dynmm_tpu") and _forbidden("dynmm_tpu.native")
    assert _forbidden("msgpack") and _forbidden("cv2")
    assert _forbidden("orbax.checkpoint") and _forbidden("tensorstore")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.build_flagship()
    assert resolve_device("cpu") == torch.device("cpu")
