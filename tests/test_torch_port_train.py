"""The port's training math against the JAX package's: losses, per-leaf
gradients and BN statistics of one train-mode forward/backward, the
learning-rate schedule and the optimizer.

Gradients are compared in float64 on both sides (``jax.enable_x64`` and
``model.double()``): at random init the fp32 gradient of this net is
chaotically conditioned (relu and max-pool boundary flips amplify rounding
noise, ``tests/test_torch_train_parity.py``), so only a float64 comparison
separates semantics from rounding. Tolerances: losses 1e-9 relative;
every gradient leaf within 1e-6 of its own largest entry, with a floor of
1e-6 of the largest gradient overall for leaves that are zero in exact
arithmetic (a conv bias right before train-mode BN, whose float64 rounding
noise depends on the summation order of the thread count); BN statistics
1e-9 relative. The ``ini`` mode hands the port the paths that
``jax.random.randint`` drew in the JAX model (the streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (B, CLASSES, as_f64, batches, class_weights,
                               compile_fast, jax_model, leaf_errors,
                               port_model, random_variables)
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.train.seg_losses import multiscale_ce as jax_multiscale_ce
from dynmm_tpu_torch.core.resource import (GateStats, budget_hinge,
                                           expected_cost_loss)
from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
from dynmm_tpu_torch.train.seg import (SegOptimizer, SegTrainConfig,
                                       onecycle_lr)
from dynmm_tpu_torch.train.seg_losses import (StreamingValidLoss,
                                              multiscale_ce)
from dynmm_tpu_torch.utils.weights import flax_from_state_dict

TEMP, RATIO, BUDGET = 0.7, 0.1, 1.0
DOWN = (8, 16, 32)
MODES = {"soft": {}, "hard": {"hard": True}, "baseline": {"baseline": True},
         "ini": {"ini_stage": True}}


@pytest.fixture(scope="module")
def setup():
    return random_variables(0), as_f64(batches(1)[0]), class_weights()


def _targets(batch):
    return [batch["label"]] + [batch["label_down"][r] for r in DOWN]


def _jax_run(variables, batch, cw, mode):
    """(total, per-scale, loss_flop, grads, batch_stats, ini paths) in f64."""
    jm = jax_model()
    kw = dict(MODES[mode])
    key = jax.random.PRNGKey(7)
    if mode == "ini":
        kw["rng"] = key
    targets = [jnp.asarray(t) for t in _targets(batch)]

    def loss_fn(params, bs):
        (preds, lf), new = jm.apply(
            {"params": params, "batch_stats": bs}, batch["image"],
            batch["depth"], train=True, temp=TEMP, mutable=["batch_stats"],
            **kw)
        seg, per = jax_multiscale_ce(preds, targets, jnp.asarray(cw))
        return seg + RATIO * jnp.maximum(lf - BUDGET, 0.0), (per, lf, new)

    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)
    args = (v["params"], v["batch_stats"])
    (total, (per, lf, new)), grads = compile_fast(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), *args)(*args)
    paths = np.asarray(jax.random.randint(key, (B,), 0, 5))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (float(total), np.asarray(per), float(lf), to_np(grads),
            to_np(new["batch_stats"]), paths)


def _port_run(variables, batch, cw, mode, paths):
    model = port_model(variables, torch.float64).train()
    kw = dict(MODES[mode])
    if mode == "ini":
        model.random_paths = lambda bs, g: torch.from_numpy(paths)
        kw["generator"] = torch.Generator()
    t = lambda a: torch.from_numpy(np.asarray(a))
    reset_launches()
    preds, lf = model(t(batch["image"]), t(batch["depth"]), temp=TEMP, **kw)
    seg, per = multiscale_ce(preds, [t(x) for x in _targets(batch)],
                             torch.tensor(cw, dtype=torch.float64))
    total = seg + RATIO * budget_hinge(lf, BUDGET)
    total.backward()
    assert sum(LAUNCHES.values()) == 0
    grads = flax_from_state_dict({
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in model.named_parameters()})["params"]
    stats = flax_from_state_dict(model.state_dict())["batch_stats"]
    return (total.item(), torch.stack(per).detach().numpy(), lf.item(), grads,
            stats, [p.shape[1:3] for p in preds])


@pytest.mark.parametrize("mode", list(MODES))
def test_losses_gradients_and_bn_match_jax(setup, mode):
    variables, batch, cw = setup
    with jax.enable_x64():
        total, per, lf, grads, stats, paths = _jax_run(variables, batch, cw,
                                                        mode)
    if mode == "ini":
        assert len(set(paths.tolist())) > 1
    p_total, p_per, p_lf, p_grads, p_stats, shapes = _port_run(
        variables, batch, cw, mode, paths)
    # full, 1/8, 1/16, 1/32 predictions in that order
    assert shapes == [(64, 96), (8, 12), (4, 6), (2, 3)]
    np.testing.assert_allclose(p_per, per, rtol=1e-9)
    np.testing.assert_allclose(p_lf, lf, rtol=1e-9)
    np.testing.assert_allclose(p_total, total, rtol=1e-9)
    top = max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    errs = leaf_errors(p_grads, grads, floor=1e-6 * top)
    assert len(errs) > 200
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-6, (worst, errs[worst])
    if mode in ("baseline", "ini"):  # the gate takes no part
        gate = jax.tree_util.tree_leaves(p_grads["gate_layer"])
        assert all(np.all(g == 0) for g in gate)
    s_errs = leaf_errors(p_stats, stats)
    worst = max(s_errs, key=s_errs.get)
    assert s_errs[worst] < 1e-9, (worst, s_errs[worst])


def test_flop_loss_and_gate_stats():
    rng = np.random.default_rng(0)
    w = rng.dirichlet(np.ones(5), size=4)
    table = np.array([0.25, 3.1, 6.9, 12.7, 15.5])
    got = expected_cost_loss(torch.from_numpy(w), table)
    assert float(got) == pytest.approx(float((w.mean(0) * table).mean()),
                                       rel=1e-12)
    assert float(budget_hinge(torch.tensor(2.0), 3.0)) == 0.0
    stats = GateStats()
    hard = np.eye(5)[[0, 2, 2, 4]]
    stats.append(torch.from_numpy(hard[:2]))
    stats.append(hard[2:])
    np.testing.assert_array_equal(stats.selection_counts(), [1, 0, 2, 0, 1])
    assert stats.selection_flops(table) == pytest.approx(
        (table * [0.25, 0, 0.5, 0, 0.25]).sum())
    assert stats.expected_flops(table) == pytest.approx(
        (table * hard.mean(0)).sum())


def test_streaming_valid_loss_matches_jax():
    from dynmm_tpu.train.seg_losses import StreamingValidLoss as JaxLoss

    rng = np.random.default_rng(0)
    cw = class_weights()
    ours, ref = StreamingValidLoss(torch.from_numpy(cw)), JaxLoss(
        jnp.asarray(cw))
    for _ in range(2):
        logits = rng.standard_normal((2, 8, 12, CLASSES)).astype(np.float32)
        label = rng.integers(0, CLASSES + 1, (2, 8, 12))
        ours.add_batch(torch.from_numpy(logits), torch.from_numpy(label))
        ref.add_batch(jnp.asarray(logits), jnp.asarray(label))
    assert ours.pixels == ref.pixels
    assert ours.compute() == pytest.approx(ref.compute(), rel=1e-5)


@pytest.mark.parametrize("epochs", [1, 4, 5, 60, 500])
def test_onecycle_lr_matches_optax(epochs):
    cfg = SegTrainConfig(epochs=epochs, lr=0.01)
    ours = onecycle_lr(cfg)
    ref = jax_seg.onecycle_lr(jax_seg.SegTrainConfig(epochs=epochs, lr=0.01))
    # optax computes in float32: within 1e-6 of the peak lr
    tol = 1e-6 * 0.01
    for epoch in range(epochs + 3):
        assert ours(epoch) == pytest.approx(ref(epoch), abs=tol), epoch
    if epochs >= 10:
        sched = optax.cosine_onecycle_schedule(
            transition_steps=epochs, peak_value=0.01, pct_start=0.1,
            div_factor=25.0, final_div_factor=1e4)
        for epoch in range(epochs + 3):
            assert ours(epoch) == pytest.approx(float(sched(epoch)), abs=tol)
        assert ours(int(0.1 * epochs)) == pytest.approx(0.01, rel=1e-12)
    else:  # constant below 5 epochs; NaN-guarded to constant below 10
        assert all(ours(e) == 0.01 for e in range(epochs + 3))


class _Toy(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.gate_w = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal((3, 4))))
        self.body = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal((5,))))


def _optax_tx(cfg):
    inner = (optax.sgd(cfg.lr, momentum=cfg.momentum, nesterov=True)
             if cfg.optimizer == "SGD" else optax.adam(cfg.lr, 0.9, 0.999))
    tx = optax.chain(optax.add_decayed_weights(cfg.weight_decay), inner)
    if cfg.grad_accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=cfg.grad_accum)
    if cfg.freeze:
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()},
            {"gate_w": "train", "body": "freeze"})
    return tx


@pytest.mark.parametrize("kw", [
    {}, {"optimizer": "Adam"}, {"grad_accum": 2}, {"freeze": True},
    {"optimizer": "Adam", "grad_accum": 3, "freeze": True}],
    ids=["sgd-nesterov", "adam", "multisteps-mean", "freeze",
         "adam-multisteps-freeze"])
def test_optimizer_matches_optax(kw):
    """Five gradient steps of ``SegOptimizer`` against the optax chain the
    JAX trainer builds, float64, 1e-12 relative: Nesterov's first step, L2
    decay on the gradient, MultiSteps' mean (not a sum), freeze."""
    cfg = SegTrainConfig(lr=0.05, weight_decay=0.01, **kw)
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt = SegOptimizer(cfg, model)
    tx = _optax_tx(cfg)
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        state = tx.init(jp)
        for _ in range(5):
            g = {n: rng.standard_normal(p.shape) for n, p in params.items()}
            for n, p in model.named_parameters():
                if p.requires_grad:
                    p.grad = torch.from_numpy(g[n])
            opt.step()
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
            for n, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                           rtol=1e-12, atol=1e-14)
    if cfg.freeze:
        np.testing.assert_array_equal(model.body.detach().numpy(),
                                      params["body"])
