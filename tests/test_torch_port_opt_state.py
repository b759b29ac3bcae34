"""The optimizer state across the two packages: the port's checkpoint holds
``opt_state`` in the layout of the JAX trainer's optax state, so a run
moves between the packages mid-recipe in either direction.

Five configs: SGD, Adam, ``grad_accum=2``, ``freeze``, and ``freeze`` with
``grad_accum=2`` (Adam: ``MultiSteps`` inside ``multi_transform``'s train
branch). For each:

* layout: the tree the port writes has the tree structure and the leaf
  dtypes and shapes of ``to_state_dict(tx.init(params))``;
* JAX → port: the JAX trainer takes a step, saves (under ``grad_accum``
  with the batch accumulated, no update yet) and takes the next step; the
  port loads the file (its optimizer state then equal to the file's arrays
  bit for bit) and takes that next step;
* port → JAX: the same with the packages swapped, through the JAX
  package's own ``load_ckpt(path, target=state)``.

Both packages train the training harness's net in float64
(``tests/_port_train_setup.py``); the step
after the resume lies within 1e-5 of each leaf's largest entry of the
other package's uninterrupted run (the training harness's bound: two
packages already differ by up to 5e-8 after one float64 step). A negative
control takes the same step from a fresh optimizer, which must fall outside
that bound. Then: a checkpoint of the port's former layout
(``{"format": "dynmm_tpu_torch", ...}``) still resumes, and a layout that
does not fit the config raises ``ValueError`` in both packages.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (as_f64, batches, class_weights, compile_fast,
                               jax_model, leaf_errors, port_model,
                               random_variables)
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.train.seg_losses import multiscale_ce
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu_torch.train.seg import (OPT_STATE_FORMAT, SegTrainConfig,
                                       SegTrainer, layout_name)
from dynmm_tpu_torch.utils.checkpoint import (load_ckpt, save_checkpoint,
                                              save_ckpt_every_epoch)
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_flax_variables)

TEMP = 0.7
BOUND = 1e-5
CONFIGS = {
    "sgd": dict(optimizer="SGD", lr=0.005),
    "adam": dict(optimizer="Adam", lr=1e-4),
    "grad_accum": dict(optimizer="SGD", lr=0.005, grad_accum=2),
    "freeze": dict(optimizer="SGD", lr=0.005, freeze=True),
    "freeze_grad_accum": dict(optimizer="Adam", lr=1e-4, freeze=True,
                              grad_accum=2),
}


@pytest.fixture(scope="module")
def data():
    return (random_variables(1), [as_f64(b) for b in batches(2)],
            class_weights())


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_grad(data):
    """The gradient of the JAX trainer's loss (``SegTrainer._model_train_out``
    and ``multiscale_ce``, soft gate, no FLOP term) and its new BN
    statistics, jitted once in float64 for every config: the optimizer
    states differ between the configs, the gradient's program does not."""
    _, (b0, _), cw = data
    trainer = jax_seg.SegTrainer(jax_model(), jax_seg.SegTrainConfig(), cw)
    flags = {"hard": False, "baseline": False, "ini": False}

    def grad(params, model_state, image, depth, targets):
        def loss_fn(p):
            preds, _, new_state = trainer._model_train_out(
                {"params": p, **model_state}, image, depth, TEMP, flags,
                jax.random.PRNGKey(0))
            return multiscale_ce(preds, targets, trainer.class_weights)[0], \
                new_state
        (_, new_state), grads = jax.value_and_grad(loss_fn,
                                                   has_aux=True)(params)
        return grads, new_state

    compiled = {}

    def run(params, model_state, batch):
        args = (params, model_state, jnp.asarray(batch["image"]),
                jnp.asarray(batch["depth"]),
                [jnp.asarray(batch["label"])] + [
                    jnp.asarray(batch["label_down"][r]) for r in (8, 16, 32)])
        if "fn" not in compiled:
            compiled["fn"] = compile_fast(jax.jit(grad), *args)
        return compiled["fn"](*args)

    return run


class JaxRun:
    """The JAX trainer's step on the gradients of ``jax_grad``: its
    ``_set_lr``, ``tx.update`` (``make_seg_optimizer``) and
    ``optax.apply_updates``, in float64."""

    def __init__(self, kw, params, grad):
        self.cfg = jax_seg.SegTrainConfig(epochs=1, **kw)
        self.tx = jax_seg.make_seg_optimizer(self.cfg, params)
        self.grad = grad

        def apply(grads, opt_state, params):
            opt_state = jax_seg._set_lr(opt_state, self.cfg.lr)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        self.apply = jax.jit(apply)

    def step(self, state, batch):
        grads, model_state = self.grad(state["params"],
                                       state["model_state"], batch)
        params, opt_state = self.apply(grads, state["opt_state"],
                                       state["params"])
        return _host({"params": params, "model_state": model_state,
                      "opt_state": opt_state})


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request) -> str:
    """A config's name; the tests that take it run config by config, so
    both directions share one JAX run."""
    return request.param


@pytest.fixture(scope="module")
def jax_run(data, jax_grad, config):
    """The JAX run of ``config``: its start state (numpy leaves), the state
    after one step and after two (params and BN statistics). One config's
    run is held at a time: each float64 state of the harness net holds
    ~0.3-0.4 GB."""
    variables, (b0, b1), _ = data
    with jax.enable_x64():
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        run = JaxRun(CONFIGS[config], v["params"], jax_grad)
        state0 = _host({"params": v["params"],
                        "model_state": {"batch_stats": v["batch_stats"]},
                        "opt_state": jax.jit(run.tx.init)(v["params"])})
        state1 = run.step(state0, b0)
        yield dict(run=run, state0=state0, state1=state1,
                   state2=_flat(run.step(state1, b1)))


def _port_trainer(kw, variables, cw):
    model = port_model(variables, torch.float64)
    return SegTrainer(model, SegTrainConfig(epochs=1, **kw), cw, device="cpu")


def _assert_bits(got, want, path=""):
    """Two trees of numpy leaves: the same keys, and each leaf of the same
    dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_bits(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), path
    bits = f"u{got.dtype.itemsize}"
    assert np.array_equal(got.view(bits), want.view(bits)), path


def _worst(got: dict, want: dict) -> tuple[str, float]:
    """The largest leaf error (``leaf_errors``) over params and BN
    statistics, and its leaf."""
    errs = {}
    for coll in ("params", "batch_stats"):
        for k, e in leaf_errors(got[coll], want[coll]).items():
            errs[f"{coll}{k}"] = e
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _flat(state) -> dict:
    """{params, batch_stats} of a JAX state dict or a port TrainState."""
    if isinstance(state, dict):
        return {"params": state["params"],
                "batch_stats": state["model_state"]["batch_stats"]}
    v = flax_from_state_dict(state.model.state_dict())
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_opt_state_layout_is_optax(data, name):
    """The port's ``opt_state`` against ``to_state_dict`` of the JAX
    trainer's ``tx.init(params)`` (float32, as the trainers write it)."""
    variables, _, cw = data
    kw = CONFIGS[name]
    trainer = SegTrainer(port_model(variables), SegTrainConfig(**kw), cw,
                         device="cpu")
    ours = trainer.init_state().optimizer.state_tree()
    tx = jax_seg.make_seg_optimizer(jax_seg.SegTrainConfig(**kw),
                                    variables["params"])
    want = _host(flax.serialization.to_state_dict(
        tx.init(variables["params"])))
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(want)):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)


def test_jax_checkpoint_resumes_in_port(data, jax_run, tmp_path, config):
    variables, (_, b1), cw = data
    name, kw, run = config, CONFIGS[config], jax_run
    path = jax_ckpt.save_checkpoint(str(tmp_path / "jax.msgpack"),
                                    run["state1"], 0)
    # the weights of another seed: the file's must replace them
    trainer = _port_trainer(kw, random_variables(7), cw)
    state, epoch, _, _ = load_ckpt(path, trainer.init_state())
    os.remove(path)
    assert epoch == 0
    # the file's arrays (msgpack is exact)
    written = _host(flax.serialization.to_state_dict(run["state1"]))
    _assert_bits(state.optimizer.state_tree(), written["opt_state"])
    _assert_bits(_flat(state), _flat(written))
    state, _ = trainer.train_one_epoch(state, [b1], 0, kw["lr"], TEMP)
    worst, err = _worst(_flat(state), run["state2"])
    print(f"{name}: resumed step vs JAX's uninterrupted run {err:.3g} "
          f"({worst})")
    assert err < BOUND, (worst, err)

    # negative control: the file's weights, a fresh optimizer
    fresh = _port_trainer(kw, random_variables(7), cw)
    load_flax_variables(fresh.model, _flat(written))
    state, _ = fresh.train_one_epoch(fresh.init_state(), [b1], 0, kw["lr"],
                                     TEMP)
    worst, err = _worst(_flat(state), run["state2"])
    print(f"{name}: fresh optimizer {err:.3g} ({worst})")
    assert err > BOUND


def test_port_checkpoint_resumes_in_jax(data, jax_run, tmp_path, config):
    variables, (b0, b1), cw = data
    name, kw, run = config, CONFIGS[config], jax_run
    trainer = _port_trainer(kw, variables, cw)
    state, _ = trainer.train_one_epoch(trainer.init_state(), [b0], 0,
                                       kw["lr"], TEMP)
    path = save_ckpt_every_epoch(str(tmp_path), state, 0, 0.0, 0)
    written = state.tree()  # the file's arrays (msgpack is exact)
    state, _ = trainer.train_one_epoch(state, [b1], 0, kw["lr"], TEMP)
    ours = _flat(state)

    with jax.enable_x64():
        restored, epoch, _, _ = jax_ckpt.load_ckpt(path, run["state0"])
        os.remove(path)
        assert epoch == 0
        _assert_bits(_host(flax.serialization.to_state_dict(restored)),
                     written)
        worst, err = _worst(_flat(run["run"].step(restored, b1)), ours)
        print(f"{name}: JAX's resumed step vs the port's uninterrupted run "
              f"{err:.3g} ({worst})")
        assert err < BOUND, (worst, err)

        # negative control: the file's weights, a fresh optimizer
        fresh = {**restored, "opt_state": run["state0"]["opt_state"]}
        worst, err = _worst(_flat(run["run"].step(fresh, b1)), ours)
        print(f"{name}: fresh optimizer {err:.3g} ({worst})")
        assert err > BOUND


def test_former_port_layout_resumes(data, tmp_path):
    """A checkpoint whose ``opt_state`` is the port's former layout (the
    momentum buffers under ``momentum``, the counters beside them) resumes
    to the state the optax layout gives."""
    variables, (b0, _), cw = data
    kw = CONFIGS["sgd"]
    trainer = _port_trainer(kw, variables, cw)
    state, _ = trainer.train_one_epoch(trainer.init_state(), [b0], 0,
                                       kw["lr"], TEMP)
    tree = state.tree()
    new = tree["opt_state"]
    trace = new["inner_state"]["1"]["0"]["trace"]
    tree["opt_state"] = {"format": OPT_STATE_FORMAT, "optimizer": "SGD",
                         "count": 1, "mini_step": 0, "momentum": trace}
    path = save_checkpoint(str(tmp_path / "former.msgpack"), tree, 0)
    resumed, _, _, _ = load_ckpt(path, _port_trainer(kw, variables, cw)
                                 .init_state())
    got = resumed.optimizer.state_tree()
    # the former layout holds no learning rate: the one set at start
    got["hyperparams"] = new["hyperparams"]
    _assert_bits(got, new)


def _jax_init(kw, params):
    tx = jax_seg.make_seg_optimizer(jax_seg.SegTrainConfig(**kw), params)
    return tx.init(params)


# (the layout written, the config that reads it)
MISMATCHES = {
    "optax_sgd_under_sgd": (None, {}),
    "adam_under_sgd": ({"optimizer": "Adam"}, {}),
    "freeze_under_sgd": ({"freeze": True}, {}),
    "sgd_under_grad_accum": ({}, {"grad_accum": 2}),
}


@pytest.mark.parametrize("name", list(MISMATCHES))
def test_mismatched_layout_raises_in_both(data, tmp_path, name):
    """A JAX checkpoint whose optax state does not fit the reading config:
    the JAX package's ``load_ckpt`` raises ``ValueError``, and so does the
    port's, naming both layouts."""
    variables, _, cw = data
    written, reading = MISMATCHES[name]
    params = variables["params"]
    opt = (optax.sgd(0.1, momentum=0.9).init(params) if written is None
           else _jax_init(written, params))
    state = {"params": params,
             "model_state": {"batch_stats": variables["batch_stats"]},
             "opt_state": opt}
    path = jax_ckpt.save_ckpt(str(tmp_path), state, 1)
    target = {**state, "opt_state": _jax_init(reading, params)}
    with pytest.raises(ValueError):
        jax_ckpt.load_ckpt(path, target)
    trainer = SegTrainer(port_model(variables), SegTrainConfig(**reading),
                         cw, device="cpu")
    state = trainer.init_state()
    with pytest.raises(ValueError) as err:
        load_ckpt(path, state)
    print(err.value)
    assert layout_name(state.optimizer.state_tree()) in str(err.value)
    assert state.optimizer.count == 0
