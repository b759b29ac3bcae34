"""Training and the CLIs of the port's segmentation variants against the
JAX package's.

One ``SegTrainer`` step per new model (the static ESANet with SE-add and
with add fusion, the local-gate SkipESANet, ESANetOneModality on rgb with
SE and on depth) against the JAX ``SegTrainer``'s jitted step, both in
float64 (fp32 gradients of these nets differ ~1e-3 between the packages by
rounding alone) on the same weights and batch: the logged losses within
1e-5 relative, every parameter and BN statistic after the SGD update within
1e-5 of its leaf's largest entry. The local gates sample the JAX draws of
the step's key. Then ``cli.train`` → ``cli.eval`` in process on the verify
recipe's TINY configuration (resnet18 BasicBlock, no context module,
bilinear upsampling), the flows it names (the local gate, one modality,
the static ESANet: ``--baseline`` in the recipe), the R50 net with APPM
and the depth-only net, each eval's mIoU that of the trainer's last
validation of the same weights."""

import csv
import glob
import io
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_train_setup import (as_f64, batches, class_weights, compile_fast,
                               leaf_errors)
from _port_variants_setup import (GumbelFromJax, configs, jax_gumbel_draws,
                                  random_variables)
from _port_variants_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models import esanet as jesanet
from dynmm_tpu.models import one_modality as jone
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu_torch.cli import eval as eval_cli
from dynmm_tpu_torch.cli import train as train_cli
from dynmm_tpu_torch.models import esanet, one_modality, skip_local
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_flax_variables)

H = W = 64
LR, TEMP = 0.005, 0.7
LOG_KEYS = ("loss_train_total", "loss_train_full_size", "loss_train_down_8",
            "loss_train_down_16", "loss_train_down_32")

# name: (JAX model, port model, trainer flags, input channels)
MODELS = {
    "static-se-add": (
        lambda c: jesanet.ESANet(c[0]), lambda c: esanet.ESANet(c[1]),
        dict(dynamic=False), {}),
    "static-add": (
        lambda c: jesanet.ESANet(c[0]), lambda c: esanet.ESANet(c[1]),
        dict(dynamic=False),
        {"fuse_depth_in_rgb_encoder": "add", "encoder_block": "BasicBlock"}),
    "local-1122": (
        lambda c: jlocal.SkipESANet(c[0], block_rule=(1, 1, 2, 2)),
        lambda c: skip_local.SkipESANet(c[1], block_rule=(1, 1, 2, 2)),
        dict(dynamic=True, global_gate=False),
        {"fuse_depth_in_rgb_encoder": "add"}),
    "rgb-se": (
        lambda c: jone.ESANetOneModality(c[0], 3, "SE-add"),
        lambda c: one_modality.ESANetOneModality(c[1], 3, "SE-add"),
        dict(dynamic=False, modality="rgb"), {"encoder_block": "BasicBlock"}),
    "depth": (
        lambda c: jone.ESANetOneModality(c[0], 1, "None"),
        lambda c: one_modality.ESANetOneModality(c[1], 1, "None"),
        dict(dynamic=False, modality="depth"), {}),
}


@pytest.fixture(scope="module")
def batch():
    return as_f64(batches(1, h=H, w=W)[0])


def _init_fn(jmodel, flags, b):
    image, depth = jnp.asarray(b["image"][:1]), jnp.asarray(b["depth"][:1])
    inputs = {"rgbd": (image, depth), "rgb": (image,),
              "depth": (depth,)}[flags.get("modality", "rgbd")]
    if flags.get("dynamic"):
        return lambda: jmodel.init(jax.random.PRNGKey(0), *inputs,
                                   jax.random.PRNGKey(1))
    return lambda: jmodel.init(jax.random.PRNGKey(0), *inputs, train=False)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(batch, monkeypatch, name):
    make_jax, make_port, flags, over = MODELS[name]
    cfgs = configs(**over)
    jmodel = make_jax(cfgs)
    variables = random_variables(_init_fn(jmodel, flags, batch), 2)
    cw = class_weights()
    kw = dict(epochs=1, lr=LR, optimizer="SGD", **flags)

    with jax.enable_x64():
        jcfg = jax_seg.SegTrainConfig(**kw)
        jtrainer = jax_seg.SegTrainer(jmodel, jcfg, cw)
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   variables)
        jtrainer.tx = jax_seg.make_seg_optimizer(jcfg, v["params"])
        state = {"params": v["params"],
                 "model_state": {"batch_stats": v["batch_stats"]},
                 "opt_state": jtrainer.tx.init(v["params"])}
        key = (False, False, False)
        targets = [jnp.asarray(batch["label"])] + [
            jnp.asarray(batch["label_down"][r]) for r in (8, 16, 32)]
        jtrainer._train_steps[key] = compile_fast(
            jtrainer._get_train_step(key), state, jnp.asarray(batch["image"]),
            jnp.asarray(batch["depth"]), targets, LR, TEMP,
            jax.random.PRNGKey(0))
        j_state, j_logs = jtrainer.train_one_epoch(state, [batch], 0, LR, TEMP)
        j_state = jax.tree_util.tree_map(np.asarray, j_state)
        # the step's key: the first split of PRNGKey(epoch)
        sub = jax.random.split(jax.random.PRNGKey(0))[1]
        draws = jax_gumbel_draws(sub, batch["image"].shape[0],
                                 dtype=jnp.float64)

    if flags.get("dynamic"):
        GumbelFromJax(monkeypatch, draws)
    model = make_port(cfgs)
    load_flax_variables(model, variables)
    trainer = SegTrainer(model.double(), SegTrainConfig(**kw), cw,
                         device="cpu")
    state, logs = trainer.train_one_epoch(trainer.init_state(), [batch], 0,
                                          LR, TEMP)
    for k in LOG_KEYS:
        assert logs[k] == pytest.approx(j_logs[k], rel=1e-5), k
    assert logs["loss_flop"] == j_logs["loss_flop"] == 0.0
    ours = flax_from_state_dict(state.model.state_dict())
    for coll, want in (("params", j_state["params"]),
                       ("batch_stats", j_state["model_state"]["batch_stats"])):
        errs = leaf_errors(ours[coll], want)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-5, (coll, worst, errs[worst])
    assert min(leaf_errors(ours["params"], variables["params"]).values()) > 0


# -------------------------------------------------------------------- CLIs
TINY = ["--device", "cpu", "--dataset", "synthetic", "--height", str(H),
        "--width", str(W), "--encoder", "resnet18", "--encoder_block",
        "BasicBlock", "--decoder_channels_mode", "constant",
        "--channels_decoder", "32", "--nr_decoder_blocks", "1",
        "--context_module", "None", "--upsampling", "bilinear",
        "--batch_size", "2", "--synthetic_n", "4"]
FLOWS = {
    "tiny-global-gate": ["--dynamic", "--global-gate", "--loss-ratio", "1e-4"],
    "local-gate": ["--dynamic", "--block-rule", "1122"],
    "one-modality-rgb": ["--modality", "rgb"],
    "static": ["--fuse_depth_in_rgb_encoder", "add"],
    "resnet50-appm": ["--dynamic", "--global-gate", "--encoder", "resnet50",
                      "--context_module", "appm"],
    "one-modality-depth": ["--modality", "depth"],
}


def _quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


@pytest.mark.parametrize("flow", list(FLOWS))
def test_train_then_eval_cli(tmp_path, flow):
    flags = FLOWS[flow]
    _, out = _quiet(train_cli.main, [*TINY, *flags, "--epochs", "1",
                                     "--results_dir", str(tmp_path)])
    assert "Training completed" in out
    (run,) = glob.glob(str(tmp_path / "synthetic" / "checkpoints_*"))
    for f in ("args.json", "logs.csv", "ckpt_latest.msgpack", "finished.txt"):
        assert os.path.exists(os.path.join(run, f)), f
    with open(os.path.join(run, "logs.csv"), newline="") as f:
        (row,) = list(csv.DictReader(f))
    assert np.isfinite(float(row["loss_train_total"]))
    hard = ["--hard"] if "--dynamic" in flags else []
    result, out = _quiet(eval_cli.main, [
        *TINY, *flags, *hard, "--ckpt_path",
        os.path.join(run, "ckpt_latest.msgpack")])
    assert "Run 0, mIoU" in out
    # the rolling checkpoint holds the weights the epoch's validation scored
    assert result[0] == pytest.approx(100 * float(row["mIoU_test_kv1"]),
                                      abs=1e-9)
