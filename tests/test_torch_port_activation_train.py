"""One fp32-net training step of swish and hswish nets against the JAX
package's: ``SegTrainer`` against the JAX ``SegTrainer``'s jitted step
(compiled at XLA's level 1), both in float64, on the same weights and
batch (``test_torch_port_variants_train.py``'s harness): the swish
global-gate net (the flagship's small form, soft gate with the FLOP loss)
and the hswish static ESANet. The logged losses within 1e-5 relative,
every parameter and BN statistic after the SGD update within 1e-5 of its
leaf's largest entry. In training every cell runs its plain PyTorch form
on the parameters themselves, so this holds the swish and hswish cells'
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_train_setup import (as_f64, batches, class_weights, compile_fast,
                               leaf_errors)
from _port_variants_setup import H, W, configs, random_variables
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu_torch.models import esanet
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_flax_variables)


TRAIN = {  # id: (JAX model, port model, config over SMALL, trainer flags)
    "swish-gate": (JaxSkipGate, SkipGateESANet, {"activation": "swish"},
                   dict(dynamic=True, global_gate=True, loss_ratio=0.1)),
    "hswish-static": (jesanet.ESANet, esanet.ESANet,
                      {"activation": "hswish"}, dict(dynamic=False)),
}


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(name):
    """One SGD step of ``SegTrainer`` against the JAX trainer's jitted
    step, both in float64, on the same weights and batch."""
    jcls, tcls, over, flags = TRAIN[name]
    jcfg, cfg = configs(**over)
    jm = jcls(jcfg)
    batch = as_f64(batches(1, h=H, w=W)[0])
    image, depth = (jnp.asarray(batch[k][:1]) for k in ("image", "depth"))
    variables = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), image, depth, train=False), 41)
    cw = class_weights()
    kw = dict(epochs=1, lr=0.005, optimizer="SGD", **flags)
    with jax.enable_x64():
        jcfg_t = jax_seg.SegTrainConfig(**kw)
        jtrainer = jax_seg.SegTrainer(jm, jcfg_t, cw)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   variables)
        jtrainer.tx = jax_seg.make_seg_optimizer(jcfg_t, v["params"])
        state = {"params": v["params"],
                 "model_state": {"batch_stats": v["batch_stats"]},
                 "opt_state": jtrainer.tx.init(v["params"])}
        key = (0 >= jcfg_t.epoch_hard, bool(jcfg_t.baseline),
               0 < jcfg_t.epoch_ini)
        targets = [jnp.asarray(batch["label"])] + [
            jnp.asarray(batch["label_down"][r]) for r in (8, 16, 32)]
        jtrainer._train_steps[key] = compile_fast(
            jtrainer._get_train_step(key), state,
            jnp.asarray(batch["image"]), jnp.asarray(batch["depth"]),
            targets, 0.005, 0.7, jax.random.PRNGKey(0))
        j_state, j_logs = jtrainer.train_one_epoch(state, [batch], 0, 0.005,
                                                   0.7)
        j_state = jax.tree_util.tree_map(np.asarray, j_state)
    model = tcls(cfg)
    load_flax_variables(model, variables)
    trainer = SegTrainer(model.double(), SegTrainConfig(**kw), cw,
                         device="cpu")
    state, logs = trainer.train_one_epoch(trainer.init_state(), [batch], 0,
                                          0.005, 0.7)
    for k in ("loss_train_total", "loss_flop", "loss_train_full_size",
              "loss_train_down_32"):
        assert logs[k] == pytest.approx(j_logs[k], rel=1e-5, abs=1e-12), k
    ours = flax_from_state_dict(state.model.state_dict())
    for coll, want in (("params", j_state["params"]),
                       ("batch_stats", j_state["model_state"]["batch_stats"])):
        errs = leaf_errors(ours[coll], want)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-5, (coll, worst, errs[worst])


