"""Mesh training and sharded routing of the port (``dynmm_tpu_torch/parallel``)
against the JAX package's ``parallel`` and its one-device step, on gloo with
CPU tensors (ranks spawned by ``parallel/launch.py::run_ranks``, one
spawn a check group, each with its own timeout of 120 s).

* ``param_spec`` splits exactly the weights JAX's ``param_spec`` splits on
  the same tree (flax paths mapped to torch names as ``export_state_dict``
  maps them), for 2 and 4 'model' ranks at ``min_out`` 128 and 256;
  ``ProcessShard`` partitions a dataset as JAX's does.
* The small dynamic global-gate ``SkipGateESANet`` (float64, SGD, the FLOP
  hinge, two steps of B=4) on a 2×2 mesh (``min_out`` 128) and a 4×1 mesh
  against the port's one-process step and JAX's one-device step on the
  same weights and batches: the logged losses within 1e-6 relative, every
  parameter and BN statistic within 1e-5 of its leaf's largest entry (the
  bounds of ``tests/test_torch_port_train_steps.py``). Each rank holds
  only its slices of the split weights and of their momentum. The
  warm-up stage's random paths (``epoch_ini``) are the global batch's:
  the 2×2 step equals the one-process one there too.
* The 2×2 mesh's bf16 step (``ESANetConfig(dtype=bfloat16)``, fp32
  parameters; one step of B=8, as the bf16 step tests take it) against
  the one-process bf16 step, by the rule ``tests/test_torch_port_bf16_train.py``
  holds the port's bf16 step to JAX's: the loss and the BN statistics lie
  closer than half the one-process fp32 step's distance, the updates
  closer than the fp32 step's, at a norm within a factor 2.
* Validation on the mesh (a ragged tail batch that does not split over 4)
  equals one-process validation: the confusion matrix exactly, the mIoU,
  the loss within 1e-6 relative, the gate weights in order.
* The 2×2 mesh's checkpoint, written by rank 0, loads into JAX's
  ``load_ckpt`` and holds JAX's parameters, BN statistics and momentum.
* The two sharded routed forwards over D = 2, one shard all blank (path 0)
  and one hard (path 4): each rank's rows equal the one-process routed
  forward of its shard (and the dense forward), the blank shard's rank
  ran no depth stage and the hard one's all four.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_mesh_setup as ms
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (SMALL, as_f64, batches, class_weights,
                               compile_fast, jax_model, leaf_errors,
                               random_variables, variable_shapes)
from dynmm_tpu.parallel import mesh as jax_mesh
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu.utils.torch_export import flax_to_torch_key
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.parallel import ProcessShard, param_spec
from dynmm_tpu_torch.parallel.launch import run_ranks

LR, TEMP, B = 0.005, 0.7, 4
BF = torch.bfloat16
BF_B = 8  # the PPM's 1×1 bin normalises over the batch, degenerate at 2
SGD = dict(optimizer="SGD", loss_ratio=0.1, flop_budget=1.0, lr=LR)
TIMEOUT = 120  # seconds a spawn may take
TREE_TOL, LOSS_TOL = 1e-5, 1e-6
LOG_KEYS = ("loss_train_total", "loss_flop", "loss_train_full_size",
            "loss_train_down_8", "loss_train_down_16", "loss_train_down_32")


@pytest.fixture(scope="module")
def data():
    """Weights, two train batches of 4 (float64), a test split of 6 at B=4
    (a tail of 2), class weights."""
    return (random_variables(1), [as_f64(b) for b in batches(2, b=B)],
            batches(1, phase="test", seed=3, b=B)
            + batches(1, phase="test", seed=4, b=2), class_weights())


def _low_kw(variables, cw, dtype) -> dict:
    """``train_and_validate``'s arguments for one SGD step of B=8 with fp32
    parameters, computing in ``dtype``."""
    model_kw = SMALL if dtype is None else {**SMALL, "dtype": dtype}
    return dict(model_kw=model_kw, variables=variables,
                train_batches=batches(1, b=BF_B, seed=5), cw=cw, lr=LR,
                temp=TEMP, valid_batches=None, train_kw=SGD,
                dtype=torch.float32)


@pytest.fixture(scope="module")
def one(data):
    variables, train, valid, cw = data
    kw = dict(model_kw=SMALL, variables=variables, train_batches=train,
              cw=cw, lr=LR, temp=TEMP)
    return {"sgd": ms.train_and_validate(valid_batches=valid, train_kw=SGD,
                                         **kw),
            "ini": ms.train_and_validate(valid_batches=None,
                                         train_kw={**SGD, "epoch_ini": 1},
                                         **kw),
            "bf16": ms.train_and_validate(**_low_kw(variables, cw, BF)),
            "fp32": ms.train_and_validate(**_low_kw(variables, cw, None))}


@pytest.fixture(scope="module")
def jax_state(data):
    """JAX's one-device float64 step over the same two batches."""
    variables, train, _, cw = data
    cfg = jax_seg.SegTrainConfig(epochs=1, **SGD)
    trainer = jax_seg.SegTrainer(jax_model(), cfg, cw)
    with jax.enable_x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   variables)
        trainer.tx = jax_seg.make_seg_optimizer(cfg, v["params"])
        state = {"params": v["params"],
                 "model_state": {"batch_stats": v["batch_stats"]},
                 "opt_state": trainer.tx.init(v["params"])}
        key = (False, False, False)
        b0 = train[0]
        targets = [jnp.asarray(b0["label"])] + [
            jnp.asarray(b0["label_down"][r]) for r in (8, 16, 32)]
        trainer._train_steps[key] = compile_fast(
            trainer._get_train_step(key), state, jnp.asarray(b0["image"]),
            jnp.asarray(b0["depth"]), targets, LR, TEMP,
            jax.random.PRNGKey(0))
        state, logs = trainer.train_one_epoch(state, train, 0, LR, TEMP)
        return jax.tree_util.tree_map(np.asarray, state), logs, trainer.tx


@pytest.fixture(scope="module")
def meshes(data, tmp_path_factory):
    """Two worlds of 4 ranks: the 2×2 mesh (its checkpoint written), the
    2×2 mesh in the warm-up stage and the 2×2 mesh's bf16 step; the 4×1
    mesh."""
    variables, train, valid, cw = data
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    kw = dict(model_kw=SMALL, variables=variables, train_batches=train,
              cw=cw, lr=LR, temp=TEMP)
    worlds = (
        [dict(kw, valid_batches=valid, train_kw=SGD, mesh_shape=(2, 2),
              min_out=128, ckpt_dir=str(ckpt)),
         dict(kw, valid_batches=None, train_kw={**SGD, "epoch_ini": 1},
              mesh_shape=(2, 2), min_out=128),
         dict(_low_kw(variables, cw, BF), mesh_shape=(2, 2), min_out=128)],
        [dict(kw, valid_batches=valid, train_kw=SGD, mesh_shape=(4, 1))])
    out = []
    for runs in worlds:
        ranks = run_ranks(ms.mesh_runs, 4, (runs,), device="cpu",
                          timeout=TIMEOUT)
        out += [[r[i] for r in ranks] for i in range(len(runs))]
    return dict(zip(("2x2", "2x2-ini", "2x2-bf16", "4x1"), out)), ckpt


def _port_names(n_model: int, min_out: int, model) -> set:
    return {n for n, p in model.named_parameters()
            if param_spec(n, p, n_model, min_out) is not None}


def _jax_names(n_model: int, min_out: int) -> set:
    names = set()

    def visit(path, leaf):
        keys = tuple(p.key for p in path)
        spec = jax_mesh.param_spec(keys, leaf, n_model, min_out)
        if any(axis == "model" for axis in spec):
            names.add(flax_to_torch_key(".".join(keys[:-1]) + ".weight"))

    jax.tree_util.tree_map_with_path(visit, variable_shapes()["params"])
    return names


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("min_out", [128, 256])
def test_param_spec_splits_the_weights_jax_splits(n_model, min_out):
    model = SkipGateESANet(ESANetConfig(**SMALL))
    want = _jax_names(n_model, min_out)
    assert want and _port_names(n_model, min_out, model) == want
    assert _port_names(1, min_out, model) == set()


def test_process_shard_partitions_as_jax():
    data = list(range(11))
    for count in (1, 2, 3, 4):
        for index in range(count):
            ours = ProcessShard(data, index, count)
            theirs = jax_mesh.ProcessShard(data, index, count)
            assert len(ours) == len(theirs)
            assert [ours[i] for i in range(len(ours))] == [
                theirs[i] for i in range(len(theirs))]
    with pytest.raises(IndexError):
        ProcessShard(data, 0, 4)[2]


def _same_tree(got: dict, want: dict) -> None:
    for coll, key in (("params", "params"), ("batch_stats", "model_state")):
        g = got[coll] if coll == "params" else got[key]["batch_stats"]
        w = want[coll] if coll == "params" else want[key]["batch_stats"]
        errs = leaf_errors(g, w)
        worst = max(errs, key=errs.get)
        assert errs[worst] < TREE_TOL, (coll, worst, errs[worst])


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_mesh_step_equals_one_process_and_jax(data, one, jax_state, meshes,
                                              shape):
    ranks = meshes[0][shape]
    got = ranks[0]
    j_state, j_logs, _ = jax_state
    for k in LOG_KEYS:
        assert got["logs"][k] == pytest.approx(one["sgd"]["logs"][k],
                                               rel=LOSS_TOL), k
        assert got["logs"][k] == pytest.approx(j_logs[k], rel=LOSS_TOL), k
    _same_tree(got["tree"], one["sgd"]["tree"])
    _same_tree(got["tree"], j_state)
    # each rank holds only its slices of the split weights and momentum
    full = one["sgd"]["local"]
    n_model = 2 if shape == "2x2" else 1
    split = _port_names(n_model, 128,
                        SkipGateESANet(ESANetConfig(**SMALL)))
    assert bool(split) == (n_model > 1)
    for r in ranks:
        for name, s in full.items():
            want = ((s[0] // n_model,) + s[1:]) if name in split else s
            assert r["local"][name] == want, (r["rank"], name)
            if name in r["moments"]:
                assert r["moments"][name] == want


def test_mesh_warmup_draws_are_the_global_batch(one, meshes):
    got = meshes[0]["2x2-ini"][0]
    for k in LOG_KEYS:
        assert got["logs"][k] == pytest.approx(one["ini"]["logs"][k],
                                               rel=LOSS_TOL), k
    _same_tree(got["tree"], one["ini"]["tree"])
    # the warm-up's random paths moved the step away from the gated one
    errs = leaf_errors(got["tree"]["params"], one["sgd"]["tree"]["params"])
    assert max(errs.values()) > 1e-3


def _moves(run: dict, variables: dict) -> dict:
    """A step's loss, parameter updates and BN statistic changes (flat)."""
    flat = lambda tree: np.concatenate([
        np.asarray(a, np.float64).ravel()
        for a in jax.tree_util.tree_leaves(tree)])
    tree = run["tree"]
    return {"loss": np.float64([run["logs"]["loss_train_total"]]),
            "updates": flat(tree["params"]) - flat(variables["params"]),
            "BN statistics": (flat(tree["model_state"]["batch_stats"])
                              - flat(variables["batch_stats"]))}


def test_mesh_bf16_step_rounds_as_the_one_process_step(data, one, meshes):
    variables = data[0]
    mesh16 = _moves(meshes[0]["2x2-bf16"][0], variables)
    one16, one32 = (_moves(one[k], variables) for k in ("bf16", "fp32"))
    err = lambda part, m: (np.linalg.norm(m[part] - one16[part])
                           / np.linalg.norm(one16[part]))
    for part in ("loss", "BN statistics"):
        ours, bound = err(part, mesh16), 0.5 * err(part, one32)
        print(f"2x2 bf16 step: {part} err(mesh, one process) {ours:.3g}, "
              f"bound ½ err(fp32 step, bf16 step) {bound:.3g}")
        assert np.isfinite(ours) and ours <= bound, part
    ours, fp32 = err("updates", mesh16), err("updates", one32)
    size = (np.linalg.norm(mesh16["updates"])
            / np.linalg.norm(one16["updates"]))
    print(f"2x2 bf16 step: updates err(mesh, one process) {ours:.3g}, the "
          f"fp32 step's {fp32:.3g}; |mesh update| / |one-process update| "
          f"{size:.3g}")
    assert ours < fp32 and 0.5 <= size <= 2.0


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_mesh_validation_equals_one_process(one, meshes, shape):
    want = one["sgd"]
    for r in meshes[0][shape]:  # every rank gets the global results
        np.testing.assert_array_equal(r["cms"]["kv1"], want["cms"]["kv1"])
        assert r["miou"] == want["miou"]
        assert r["vlogs"]["loss_test"] == pytest.approx(
            want["vlogs"]["loss_test"], rel=LOSS_TOL)
        np.testing.assert_array_equal(r["gates"], want["gates"])
    assert len(want["gates"]) == 6


def test_mesh_checkpoint_loads_in_jax(meshes, jax_state):
    j_state, _, tx = jax_state
    target = {"params": variable_shapes()["params"],
              "model_state": {"batch_stats":
                              variable_shapes()["batch_stats"]}}
    target["opt_state"] = tx.init(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), target["params"]))
    state, epoch, _, _ = jax_ckpt.load_ckpt(
        str(meshes[1] / "ckpt_latest.msgpack"), target)
    assert epoch == 0
    _same_tree(state, j_state)
    trace = state["opt_state"].inner_state[1][0].trace
    j_trace = j_state["opt_state"].inner_state[1][0].trace
    errs = leaf_errors(trace, j_trace)
    assert max(errs.values()) < TREE_TOL


def test_sharded_routed_forwards_are_local(data):
    variables = data[0]
    rng = np.random.default_rng(7)
    rgb = rng.standard_normal((4, 64, 96, 3)).astype(np.float32)
    depth = rng.standard_normal((4, 64, 96, 1)).astype(np.float32)
    rgb[:2], depth[:2] = 0.0, 0.0  # shard 0: blank, path 0
    methods = [("forward_switch_batched", {}),
               ("forward_routed_compact", {"caps": (0, 2)})]
    ranks = run_ranks(ms.routed, 2, (SMALL, variables, rgb, depth, 2,
                                     methods), device="cpu", timeout=TIMEOUT)
    model = ms.port_model(SMALL, variables, torch.float32).eval()
    ms.PathsGate(model)
    with torch.no_grad():
        dense = model(torch.from_numpy(rgb), torch.from_numpy(depth),
                      hard=True).numpy()
        for i, (method, kw) in enumerate(methods):
            want = np.concatenate([getattr(model, method)(
                torch.from_numpy(rgb[s]), torch.from_numpy(depth[s]),
                **kw).numpy() for s in (slice(0, 2), slice(2, 4))])
            for r in ranks:
                np.testing.assert_array_equal(r[i]["out"], want)
            np.testing.assert_allclose(want, dense, rtol=0,
                                       atol=1e-5 * np.abs(dense).max())
            assert ranks[0][i]["stages"] == []  # the blank shard skipped
            assert ranks[1][i]["stages"] == [1, 2, 3, 4]
