"""The port's flax-msgpack checkpoints against the JAX package's.

* ``utils/msgpack.py`` (pure Python) against ``flax.serialization``: the
  bytes it writes equal flax's, each reads what the other wrote, for every
  extension type (ndarray, numpy scalar, complex), the dtypes and int/float
  widths, str against bin, nesting and flax's chunked arrays.
* A checkpoint the JAX package writes (``save_ckpt``, with an optax state)
  loads into the port, and one the port writes loads into the JAX model: the
  eval logits agree within 1e-4 of their largest magnitude (float32, the
  same weights) and the hard-gate choices are identical.
* Resuming from the port's rolling checkpoint gives exactly the state that
  continuing gives (CPU, bit-equal), for SGD, Adam and a ``grad_accum``
  checkpoint taken between two accumulated batches.
* The recipe gate asset merged into both models at a small shape gives
  identical hard-gate choices and matching logits on
  ``make_recipe_eval_batch`` inputs.
"""

import csv

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (H, W, batches, class_weights, compile_fast,
                               jax_model, port_model, random_variables,
                               variable_shapes)
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils import msgpack as pm
from dynmm_tpu_torch.utils.checkpoint import (get_best_checkpoint, load_ckpt,
                                              save_ckpt, save_ckpt_every_epoch)
from dynmm_tpu_torch.utils.weights import (RECIPE_ASSET_DIR,
                                           flax_from_state_dict,
                                           load_checkpoint_into,
                                           load_recipe_gate, merge_subtree,
                                           state_dict_from_flax)

TREES = {
    "ints_floats": {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "flags": [True, False, None],
    },
    "str_bin": {"short": "a", "fix31": "x" * 31, "str8": "é" * 100,
                "str16": "s" * 300, "bin8": b"\x00\xff", "bin16": b"b" * 300,
                "empty": "", "empty_bin": b""},
    "arrays": {
        **{str(np.dtype(t)): np.arange(-3, 9).astype(t).reshape(3, 4)
           for t in (np.float16, np.float32, np.float64, np.int8, np.int16,
                     np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                     np.uint64, np.bool_, np.complex64)},
        "scalar0d": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
        "big": np.linspace(0, 1, 70000, dtype=np.float32),  # ext32
        "fixext": np.zeros((), np.uint8),
    },
    "numpy_scalars": {"f32": np.float32(1.5), "i64": np.int64(-3),
                      "b": np.bool_(True), "u8": np.uint8(7)},
    "nesting": {"z": {"y": {"x": {"w": [1, [2, {"v": np.ones(2)}]]}}},
                "complex": 1.5 - 2j, **{f"k{i:02d}": i for i in range(40)}},
}


def _assert_same(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        assert np.shape(a) == np.shape(b), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), path


@pytest.mark.parametrize("name", list(TREES))
def test_msgpack_bytes_and_both_directions(name):
    tree = TREES[name]
    ref = flax.serialization.msgpack_serialize(tree)
    ours = pm.msgpack_serialize(tree)
    assert ours == ref
    _assert_same(pm.msgpack_restore(ref), flax.serialization.msgpack_restore(ref))
    _assert_same(flax.serialization.msgpack_restore(ours), pm.msgpack_restore(ours))


def test_msgpack_reads_chunked_arrays(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(10, 10), "b": 1}
    data = flax.serialization.msgpack_serialize(tree)
    out = pm.msgpack_restore(data)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert out["b"] == 1


def test_msgpack_reads_the_recipe_asset():
    data = (RECIPE_ASSET_DIR / "gate_recipe.msgpack").read_bytes()
    _assert_same(pm.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    assert pm.msgpack_serialize(pm.msgpack_restore(data)) == data


def test_flax_state_dict_round_trip():
    """state_dict_from_flax then flax_from_state_dict is the identity, on
    the small model and on the flagship's tree (shapes from eval_shape)."""
    v = random_variables(0)
    back = flax_from_state_dict(state_dict_from_flax(v["params"],
                                                     v["batch_stats"]))
    _assert_same(back["params"], jax.tree_util.tree_map(np.asarray, v["params"]))
    _assert_same(back["batch_stats"],
                 jax.tree_util.tree_map(np.asarray, v["batch_stats"]))
    shapes = jax.eval_shape(lambda: JaxSkipGate(JaxConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 480, 640, 3)),
        jnp.zeros((1, 480, 640, 1)), train=False))
    flag = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    back = flax_from_state_dict(state_dict_from_flax(flag["params"],
                                                     flag["batch_stats"]))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(
                {"params": flag["params"], "batch_stats": flag["batch_stats"]}))


@pytest.fixture(scope="module")
def jax_eval():
    """Jitted JAX hard-gate eval of the small model on B=2 inputs."""
    jm = jax_model()
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, hard=True,
                                             return_weight=True))
    compiled = {}

    def run(variables, rgb, depth):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                   variables)
        args = (v, jnp.asarray(rgb), jnp.asarray(depth))
        if "fn" not in compiled:
            compiled["fn"] = compile_fast(apply, *args)
        return tuple(np.asarray(a) for a in compiled["fn"](*args))

    return run


def _port_eval(model, rgb, depth):
    model.eval()
    pack_weights(model)
    with torch.no_grad():
        out, w = model(torch.from_numpy(rgb), torch.from_numpy(depth),
                       hard=True, return_weight=True)
    return out.numpy(), w.numpy()


def _assert_eval_close(got, want):
    (out, w), (ref, ref_w) = got, want
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(w, ref_w)


def test_jax_checkpoint_loads_into_port(tmp_path, jax_eval, capsys):
    v = random_variables(2)
    test = batches(1, phase="test", seed=5)[0]
    state = {"params": v["params"],
             "model_state": {"batch_stats": v["batch_stats"]},
             "opt_state": optax.sgd(0.1, momentum=0.9).init(v["params"])}
    path = jax_ckpt.save_ckpt(str(tmp_path), state, 3)
    model = port_model(random_variables(7))
    payload = load_checkpoint_into(model, path)
    assert payload["epoch"] == 3
    want = jax_eval(v, test["image"], test["depth"])
    _assert_eval_close(_port_eval(model, test["image"], test["depth"]), want)
    # into a training state: the weights load, the optax state does not
    trainer = SegTrainer(port_model(random_variables(7)), SegTrainConfig(),
                         class_weights(), device="cpu")
    restored, epoch, best, best_epoch = load_ckpt(path, trainer.init_state())
    assert (epoch, best, best_epoch) == (3, 0.0, 0)
    assert "optimizer starts fresh" in capsys.readouterr().out
    assert restored.optimizer.count == 0
    _assert_eval_close(_port_eval(restored.model, test["image"],
                                  test["depth"]), want)


def test_port_checkpoint_loads_into_jax(tmp_path, jax_eval):
    v = random_variables(3)
    train = batches(1)[0]
    test = batches(1, phase="test", seed=5)[0]
    trainer = SegTrainer(port_model(v), SegTrainConfig(lr=0.01),
                         class_weights(), device="cpu")
    state = trainer.init_state()
    state, _ = trainer.train_one_epoch(state, [train], 0, 0.01, 1.0)
    path = save_ckpt_every_epoch(str(tmp_path), state, 0, 0.25, 0)
    payload = jax_ckpt.load_checkpoint(path)
    assert (payload["epoch"], payload["best_miou"], payload["best_miou_epoch"]
            ) == (0, 0.25, 0)
    # flax's own round trip of the payload gives the file's bytes
    with open(path, "rb") as f:
        assert flax.serialization.msgpack_serialize(payload) == f.read()
    shapes = variable_shapes()
    params = flax.serialization.from_state_dict(shapes["params"],
                                                payload["state"]["params"])
    stats = flax.serialization.from_state_dict(
        shapes["batch_stats"], payload["state"]["model_state"]["batch_stats"])
    opt = payload["state"]["opt_state"]
    assert (opt["format"], opt["optimizer"], opt["count"]) == (
        "dynmm_tpu_torch", "SGD", 1)
    assert (jax.tree_util.tree_structure(opt["momentum"])
            == jax.tree_util.tree_structure(payload["state"]["params"]))
    want = jax_eval({"params": params, "batch_stats": stats}, test["image"],
                    test["depth"])
    _assert_eval_close(_port_eval(state.model, test["image"], test["depth"]),
                       want)


@pytest.mark.parametrize("kw", [{}, {"optimizer": "Adam"}, {"grad_accum": 2}],
                         ids=["sgd", "adam", "grad_accum"])
def test_resume_equals_continuing(tmp_path, kw):
    cfg = SegTrainConfig(lr=0.01, loss_ratio=0.1, **kw)
    b = batches(3)
    trainer = SegTrainer(port_model(random_variables(4)), cfg,
                         class_weights(), device="cpu")
    state = trainer.init_state()
    state, _ = trainer.train_one_epoch(state, b[:1], 0, 0.01, 0.9)
    path = save_ckpt_every_epoch(str(tmp_path), state, 0, 0.5, 0)
    state, _ = trainer.train_one_epoch(state, b[1:], 1, 0.01, 0.9)

    trainer2 = SegTrainer(port_model(random_variables(9)), cfg,
                          class_weights(), device="cpu")
    state2, epoch, best, best_epoch = load_ckpt(path, trainer2.init_state())
    assert (epoch, best, best_epoch) == (0, 0.5, 0)
    state2, _ = trainer2.train_one_epoch(state2, b[1:], 1, 0.01, 0.9)
    ours, ref = state2.model.state_dict(), state.model.state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    assert state2.optimizer.count == state.optimizer.count
    _assert_same(state2.optimizer.state_tree(), state.optimizer.state_tree())


def test_recipe_gate_merged_into_both_models(jax_eval):
    v = random_variables(5)
    j_vars, j_ratios, j_prov = bench.load_recipe_gate(
        {"params": v["params"], "batch_stats": v["batch_stats"]})
    model = port_model(v)
    ratios, prov = load_recipe_gate(model)
    np.testing.assert_array_equal(ratios, j_ratios)
    assert prov == j_prov
    gate = flax_from_state_dict(model.state_dict())["params"]["gate_layer"]
    _assert_same(gate, jax.tree_util.tree_map(np.asarray,
                                              j_vars["params"]["gate_layer"]))
    rgb, depth = make_recipe_eval_batch(2, H, W)
    want = jax_eval(j_vars, rgb, depth)
    got = _port_eval(model, rgb, depth)
    _assert_eval_close(got, want)
    # a depth-needed and an rgb-sufficient sample: the gate routes them apart
    assert len(set(got[1].argmax(1).tolist())) == 2


def test_merge_subtree_is_strict():
    dst = {"a": {"k": np.zeros((2, 3), np.float32)}}
    out = merge_subtree(dst, {"a": {"k": np.ones((2, 3), np.float64)}})
    assert out["a"]["k"].dtype == np.float32 and out["a"]["k"].sum() == 6
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_subtree(dst, {"a": {"k": np.ones((3, 2))}})
    with pytest.raises(KeyError):
        merge_subtree(dst, {"b": np.ones(1)})


def test_get_best_checkpoint(tmp_path):
    rows = [{"mIoU_test": "0.2", "epoch": "0"}, {"mIoU_test": "0.5", "epoch": "3"},
            {"mIoU_test": "0.5", "epoch": "5"}, {"mIoU_test": "", "epoch": "6"}]
    with open(tmp_path / "logs.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["mIoU_test", "epoch"])
        writer.writeheader()
        writer.writerows(rows)
    (tmp_path / "ckpt_epoch_3.msgpack").write_bytes(b"")
    assert get_best_checkpoint(str(tmp_path)).endswith("ckpt_epoch_3.msgpack")
