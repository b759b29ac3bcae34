"""Three training steps of the port's ``SegTrainer`` against the JAX
package's ``dynmm_tpu.train.seg.SegTrainer`` on the same weights and
batches, then the eval forward on the trained weights.

Both trainers run ``train_one_epoch`` over the same three batches in
float64 (see ``test_torch_port_train.py`` for why), the JAX one with its own
jitted step (compiled at ``FAST_COMPILE``). Configurations: SGD with the
soft gate and the FLOP hinge; Adam with the hard (straight-through) gate;
``freeze``; ``grad_accum=2`` with ``baseline`` (one update and one
accumulated batch). SGD runs at lr 0.005, Adam at 1e-4, a usual Adam rate:
Adam's normalised step moves every weight by ~lr whatever its gradient, and
at 0.005 it leaves this small net (stage 4 maps of 2×3) so ill-conditioned
that the two packages, within 5e-8 after the first step, differ by
1e-5-1e-3 after the third (float64 rounding amplified, in some weights, by
the normalisation). Tolerances: every
parameter, BN statistic and accumulated gradient within 1e-5 of its leaf's
largest entry (observed ≤ 5e-7), the logged losses 1e-6 relative. The eval check casts the trained weights to float32:
the port's eval forward after ``pack_weights`` (on the CPU the kernels' plain
versions read the packed copies, as the kernels do on the card) against
the JAX eval, logits within 1e-4 of their largest magnitude, gate choices
identical; and ``validate`` against the JAX ``validate``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (CLASSES, H, W, as_f64, batches, class_weights,
                               compile_fast, jax_model, leaf_errors,
                               port_model, random_variables)
from dynmm_tpu.data.nyuv2 import SyntheticSegDataset as JaxSynthetic
from dynmm_tpu.data.seg_preprocessing import (SegLoader as JaxLoader,
                                              SegPreprocessor as JaxPre)
from dynmm_tpu.core.resource import GateStats as JaxGateStats
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.train.seg_losses import StreamingValidLoss as JaxLoss
from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.train.seg_losses import StreamingValidLoss
from dynmm_tpu_torch.utils.weights import flax_from_state_dict

LR, TEMP = 0.005, 0.7  # SGD's lr; Adam's is in its config
CONFIGS = {
    "sgd": dict(optimizer="SGD", loss_ratio=0.1, flop_budget=1.0),
    "adam": dict(optimizer="Adam", loss_ratio=0.1, lr=1e-4),
    "freeze": dict(optimizer="SGD", freeze=True, loss_ratio=0.1),
    "grad_accum": dict(optimizer="SGD", grad_accum=2, baseline=True),
}
LOG_KEYS = ("loss_train_total", "loss_flop", "loss_train_full_size",
            "loss_train_down_8", "loss_train_down_16", "loss_train_down_32")


@pytest.fixture(scope="module")
def data():
    return random_variables(1), [as_f64(b) for b in batches(3)], class_weights()


def _jax_train(kw, variables, train_batches, cw):
    kw = {"lr": LR, **kw}
    cfg = jax_seg.SegTrainConfig(epochs=1, **kw)
    trainer = jax_seg.SegTrainer(jax_model(), cfg, cw)
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)
    trainer.tx = jax_seg.make_seg_optimizer(cfg, v["params"])
    state = {"params": v["params"],
             "model_state": {"batch_stats": v["batch_stats"]},
             "opt_state": trainer.tx.init(v["params"])}
    key = (0 >= cfg.epoch_hard, bool(cfg.baseline), 0 < cfg.epoch_ini)
    b0 = train_batches[0]
    targets = [jnp.asarray(b0["label"])] + [
        jnp.asarray(b0["label_down"][r]) for r in (8, 16, 32)]
    trainer._train_steps[key] = compile_fast(
        trainer._get_train_step(key), state, jnp.asarray(b0["image"]),
        jnp.asarray(b0["depth"]), targets, cfg.lr, TEMP, jax.random.PRNGKey(0))
    state, logs = trainer.train_one_epoch(state, train_batches, 0, cfg.lr, TEMP)
    return jax.tree_util.tree_map(np.asarray, state), logs


@pytest.fixture(scope="module")
def trained(data):
    variables, train_batches, cw = data
    out = {}
    for name, kw in CONFIGS.items():
        with jax.enable_x64():
            j_state, j_logs = _jax_train(kw, variables, train_batches, cw)
        model = port_model(variables, torch.float64)
        cfg = SegTrainConfig(epochs=1, **{"lr": LR, **kw})
        trainer = SegTrainer(model, cfg, cw, device="cpu")
        state, logs = trainer.train_one_epoch(trainer.init_state(),
                                              train_batches, 0, cfg.lr, TEMP)
        out[name] = (j_state, j_logs, trainer, state, logs)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_jax(data, trained, name):
    variables = data[0]
    j_state, j_logs, _, state, logs = trained[name]
    for k in LOG_KEYS:
        assert logs[k] == pytest.approx(j_logs[k], rel=1e-6), k
    ours = flax_from_state_dict(state.model.state_dict())
    for coll, want in (("params", j_state["params"]),
                       ("batch_stats", j_state["model_state"]["batch_stats"])):
        errs = leaf_errors(ours[coll], want)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-5, (coll, worst, errs[worst])
    moved = leaf_errors(ours["params"], variables["params"])
    if name == "freeze":
        assert {k for k, e in moved.items() if e > 0} == {
            k for k in moved if k.startswith("/gate_layer")}
    else:
        assert min(moved.values()) > 0  # weight decay moves every leaf
    if name == "grad_accum":  # the third batch is accumulated, not applied
        opt = state.optimizer
        assert (opt.count, opt.mini_step) == (1, 1)
        acc = j_state["opt_state"].acc_grads
        top = max(np.abs(a).max() for a in jax.tree_util.tree_leaves(acc))
        errs = leaf_errors(flax_from_state_dict(opt.acc)["params"], acc,
                           floor=1e-9 * top)
        assert max(errs.values()) < 1e-5


def test_eval_after_steps_through_packed_path(data, trained):
    """The trained weights in float32: the port's eval (packed copies, the
    kernels' layout) against the JAX eval; before ``pack_weights`` the
    copies still hold the weights from before the steps."""
    j_state, _, trainer, state, _ = trained["sgd"]
    test = [b for b in batches(1, phase="test", seed=3)][0]
    jm = jax_model()
    v32 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        {"params": j_state["params"], **j_state["model_state"]})
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, hard=True,
                                             return_weight=True))
    args = (v32, jnp.asarray(test["image"]), jnp.asarray(test["depth"]))
    ref, ref_w = (np.asarray(a) for a in compile_fast(apply, *args)(*args))

    model = state.model.float().eval()
    rgb, depth = (torch.from_numpy(test[k]) for k in ("image", "depth"))
    with torch.no_grad():
        stale = model(rgb, depth, hard=True)
        pack_weights(model)
        out, w = model(rgb, depth, hard=True, return_weight=True)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape == (2, H, W, CLASSES)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(w.numpy(), ref_w)
    assert np.abs(stale.numpy() - ref).max() > 1e-2 * scale


def test_validate_matches_jax(data, trained):
    """``validate`` (resize → first argmax → void mask → label − 1 →
    confusion matrix; the gate weights collected) on the float32 trained
    weights against the JAX trainer's, on the same test loader."""
    j_state, _, trainer, state, _ = trained["sgd"]
    cw = data[2]
    kw = dict(n=4, height=H, width=W, n_classes=CLASSES, seed=3,
              split="test", mixed_modality_frac=0.5)
    loader = JaxLoader(JaxSynthetic(**kw), JaxPre(1.0, 1.0, H, W, phase="test"),
                       batch_size=2)
    j_trainer = jax_seg.SegTrainer(jax_model(), jax_seg.SegTrainConfig(), cw)
    j32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                 {"params": j_state["params"],
                                  "model_state": j_state["model_state"]})
    j_cms, cms = {}, {}
    j_gates, gates = JaxGateStats(), GateStats()
    j_miou, j_logs = j_trainer.validate(
        j32, loader, valid_loss=JaxLoss(jnp.asarray(cw)),
        collect_weights=j_gates, out_cms=j_cms)
    trainer.model.float()
    miou, logs = trainer.validate(
        state, loader, valid_loss=StreamingValidLoss(torch.from_numpy(cw)),
        collect_weights=gates, out_cms=cms)
    assert miou["kv1"] == pytest.approx(j_miou["kv1"], abs=1e-3)
    assert (np.abs(cms["kv1"] - j_cms["kv1"]).sum()
            <= 1e-3 * j_cms["kv1"].sum())
    assert logs["loss_test"] == pytest.approx(j_logs["loss_test"], rel=1e-4)
    assert set(logs) == set(j_logs)
    np.testing.assert_array_equal(gates.weights, j_gates.weights)
