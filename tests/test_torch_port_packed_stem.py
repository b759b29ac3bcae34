"""The port's 2×2 space-to-depth packed stem against the JAX package's
(``dynmm_tpu/models/resnet.py:203-258``, ``:361-400``): ``s2d_weight``
equals ``_s2d_kernel``; the packed stem on a packed input matches the JAX
stem and the port's raw stem within 1e-5 relative; ``space_to_depth_host``
(native and numpy) equals JAX's; the packed
``SkipGateESANet`` forward matches the JAX packed forward with the same
gate choices; a float64 packed-stem train step matches the raw one within
1e-8; a wrong channel count raises the JAX message."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynmm_tpu.models.resnet as jax_resnet
from _port_train_setup import (B, H, SMALL, W, as_f64, batches, class_weights,
                               compile_fast, jax_model, port_model,
                               random_variables)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu_torch.models.resnet import (make_resnet, s2d_weight,
                                           space_to_depth_host)
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("c", [3, 1])
def test_s2d_weight_equals_jax(c):
    w = np.random.default_rng(c).standard_normal((7, 7, c, 64)).astype(
        np.float32)
    want = np.asarray(jax_resnet._s2d_kernel(jnp.asarray(w)))  # HWIO
    got = s2d_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))  # OIHW
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


@pytest.mark.parametrize("c", [3, 1])
def test_space_to_depth_equals_jax(c):
    x = np.random.default_rng(c).standard_normal((2, 8, 12, c))
    want = jax_resnet.space_to_depth_host(x.astype(np.float32))
    np.testing.assert_array_equal(space_to_depth_host(x.astype(np.float32)),
                                  want)  # native
    np.testing.assert_array_equal(space_to_depth_host(x),  # numpy, float64
                                  jax_resnet.space_to_depth_host(x))
    np.testing.assert_array_equal(
        np.asarray(jax_resnet._space_to_depth(jnp.asarray(x, jnp.float32))),
        want)


@pytest.mark.parametrize("c", [3, 1])
def test_packed_stem_matches_jax_and_raw(c):
    rng = np.random.default_rng(10 + c)
    x = rng.standard_normal((2, H, W, c)).astype(np.float32)
    enc = jax_resnet.make_resnet("resnet18", block="NonBottleneck1D",
                                 input_channels=c)
    v = jax.tree_util.tree_map(np.asarray, enc.init(
        jax.random.PRNGKey(0), jnp.asarray(x), method=enc.stem))
    bn = v["params"]["bn1"]
    bn["scale"] = rng.uniform(0.5, 1.0, 64).astype(np.float32)
    bn["bias"] = rng.standard_normal(64).astype(np.float32) * 0.1
    v["batch_stats"]["bn1"] = {
        "mean": rng.standard_normal(64).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, 64).astype(np.float32)}
    packed = space_to_depth_host(x)
    ref = np.asarray(enc.apply(v, jnp.asarray(packed), method=enc.stem))
    ref_raw = np.asarray(enc.apply(v, jnp.asarray(x), method=enc.stem))

    port = make_resnet("resnet18", input_channels=c).eval()
    sd = port.state_dict()
    sd.update({
        "conv1.weight": torch.from_numpy(
            v["params"]["conv1"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bn1.weight": torch.from_numpy(bn["scale"]),
        "bn1.bias": torch.from_numpy(bn["bias"]),
        "bn1.running_mean": torch.from_numpy(v["batch_stats"]["bn1"]["mean"]),
        "bn1.running_var": torch.from_numpy(v["batch_stats"]["bn1"]["var"])})
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.stem(torch.from_numpy(packed).permute(0, 3, 1, 2))
        raw = port.stem(torch.from_numpy(x).permute(0, 3, 1, 2))
    got, raw = got.permute(0, 2, 3, 1).numpy(), raw.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, H // 2, W // 2, 64)
    assert _rel(got, ref) < 1e-5
    assert _rel(got, raw) < 1e-5
    assert _rel(raw, ref_raw) < 1e-5


def test_skip_gate_packed_forward_matches_jax():
    variables = random_variables(seed=4)
    batch = batches(1, phase="test", seed=4)[0]
    rgb, depth = batch["image"], batch["depth"]
    prgb, pdepth = space_to_depth_host(rgb), space_to_depth_host(depth)
    jm = jax_model()
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, hard=True,
                                             return_weight=True))
    call = (variables, jnp.asarray(prgb), jnp.asarray(pdepth))
    ref, ref_w = (np.asarray(a) for a in compile_fast(apply, *call)(*call))

    model = port_model(variables).eval()
    with torch.no_grad():
        out, w = model(torch.from_numpy(prgb), torch.from_numpy(pdepth),
                       hard=True, return_weight=True)
        raw, raw_w = model(torch.from_numpy(rgb), torch.from_numpy(depth),
                           hard=True, return_weight=True)
    assert out.shape == (B, H, W, SMALL["num_classes"]) == ref.shape
    assert _rel(out.numpy(), ref) < 1e-4
    np.testing.assert_array_equal(w.numpy(), ref_w)
    assert _rel(out.numpy(), raw.numpy()) < 1e-5
    np.testing.assert_array_equal(raw_w.numpy(), w.numpy())
    # every routed forward takes the packed input (through _stems)
    with torch.no_grad():
        p, r = torch.from_numpy(prgb), torch.from_numpy(pdepth)
        np.testing.assert_array_equal(model.gate_only(p, r).numpy(), ref_w)
        for fwd in (model.forward_switch_batched,
                    model.forward_routed_compact):
            routed = fwd(p, r)
            assert _rel(routed.numpy(), out.numpy()) < 1e-5
        one = model.forward_switch(p[:1], r[:1])
        assert _rel(one.numpy(), out[:1].numpy()) < 1e-5


def test_packed_stem_train_step_matches_raw_float64():
    variables = random_variables(seed=5)
    batch = as_f64(batches(1, phase="train", seed=5)[0])
    trained = []
    for packed in (False, True):
        model = port_model(variables, torch.float64)
        cfg = SegTrainConfig(loss_ratio=1e-4, packed_stem=packed, epochs=2)
        trainer = SegTrainer(model, cfg, class_weights(), device="cpu")
        trainer.class_weights = trainer.class_weights.double()
        state = trainer.init_state()
        _, logs = trainer.train_one_epoch(state, [batch], 0, 0.01, 1.0)
        assert np.isfinite(logs["loss_train_total"])
        trained.append({k: v.clone() for k, v in model.state_dict().items()})
    raw, packed = trained
    start = port_model(variables, torch.float64).state_dict()
    assert not torch.equal(packed["encoder_rgb.conv1.weight"],
                           start["encoder_rgb.conv1.weight"])
    for k in raw:
        scale = max(raw[k].abs().max().item(), 1e-12)
        assert (packed[k] - raw[k]).abs().max().item() / scale < 1e-8, k


def test_wrong_channel_count_raises():
    enc = make_resnet("resnet18", input_channels=3).eval()
    with pytest.raises(ValueError, match=r"stem expects 3 channels \(raw\) "
                                         r"or 12 \(space-to-depth packed\); "
                                         r"got 6"):
        enc.stem(torch.zeros(1, 6, 8, 8))
    model = port_model(random_variables(seed=6)).eval()
    with pytest.raises(ValueError, match="got 5"):
        with torch.no_grad():
            model(torch.zeros(1, H // 2, W // 2, 5),
                  torch.zeros(1, H // 2, W // 2, 4))
