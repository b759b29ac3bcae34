"""``python -m dynmm_tpu_torch.cli.train`` on the CPU at a small NBt1D shape:
two epochs of two steps write the JAX trainer's artifacts (``logs.csv``
with the header the JAX trainer wrote for the recipe run, confusion-matrix
pickles, the rolling and best checkpoints, ``finished.txt``); the best
checkpoint loads into the JAX model and gives the port's eval logits
(within 1e-4 of their largest magnitude, identical gate choices);
``--last_ckpt`` resumes at the next epoch; flags of features not ported
raise (those ported since parse); ``--finetune`` reads a reference-style
``.pth``; ``--he_init`` re-draws the same kernels as the JAX package's."""

import csv
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_train_setup import compile_fast
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu.utils.init import apply_he_init as jax_he_init
from dynmm_tpu_torch.cli.seg_build import build_config, build_model
from dynmm_tpu_torch.cli.train import parse_args
from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
from dynmm_tpu_torch.utils.init import apply_he_init
from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_checkpoint_into)

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
TINY = ["--device", "cpu", "--dataset", "synthetic", "--height", str(H),
        "--width", str(W), "--encoder", "resnet18", "--channels_decoder", "32",
        "--decoder_channels_mode", "constant", "--nr_decoder_blocks", "1",
        "--batch_size", "2", "--synthetic_n", "4", "--dynamic",
        "--global-gate", "--loss-ratio", "1e-4", "--eval-every", "1"]


def _train(results: Path, *extra: str) -> Path:
    proc = subprocess.run(
        [sys.executable, "-m", "dynmm_tpu_torch.cli.train", *TINY,
         "--results_dir", str(results), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training completed" in proc.stdout
    (run,) = (results / "synthetic").iterdir()
    return run


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("cli"), "--epochs", "2")


def _header(path: Path) -> list[str]:
    with open(path, newline="") as f:
        return next(csv.reader(f))


def test_artifacts_and_log_header(run_dir):
    files = set(os.listdir(run_dir))
    assert {"args.json", "argsv.txt", "logs.csv", "finished.txt",
            "ckpt_latest.msgpack", "confusion_matrices"} <= files
    assert any(f.startswith("ckpt_epoch_") for f in files)
    jax_header = _header(REPO / "bench_assets" / "gate_recipe_logs"
                         / "stage_b_logs.csv")
    assert _header(run_dir / "logs.csv") == jax_header
    with open(run_dir / "logs.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert all(np.isfinite(float(r["loss_train_total"])) for r in rows)
    for e in (0, 1):
        with open(run_dir / "confusion_matrices" / f"cm_epoch_{e}.pickle",
                  "rb") as f:
            cms = pickle.load(f)
        assert cms["kv1"].shape == (40, 40) and cms["kv1"].sum() > 0
    args = json.loads((run_dir / "args.json").read_text())
    assert args["epochs"] == 2 and args["lr"] == pytest.approx(0.01 * 2 / 8)
    assert "best miou epoch" in (run_dir / "finished.txt").read_text()


def test_checkpoint_loads_in_jax(run_dir):
    (best,) = [f for f in os.listdir(run_dir) if f.startswith("ckpt_epoch_")]
    payload = jax_ckpt.load_checkpoint(str(run_dir / best))
    args = parse_args([*TINY, "--epochs", "2"])
    jm = JaxSkipGate(JaxConfig(**{
        k: getattr(build_config(args, 40), k) for k in (
            "height", "width", "num_classes", "encoder_rgb", "encoder_depth",
            "encoder_block", "channels_decoder", "nr_decoder_blocks",
            "context_module", "upsampling")}))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), train=False))
    state = payload["state"]
    variables = {
        "params": flax.serialization.from_state_dict(shapes["params"],
                                                     state["params"]),
        "batch_stats": flax.serialization.from_state_dict(
            shapes["batch_stats"], state["model_state"]["batch_stats"])}
    rgb, depth = make_recipe_eval_batch(2, H, W)
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, hard=True,
                                             return_weight=True))
    call = (variables, jnp.asarray(rgb), jnp.asarray(depth))
    ref, ref_w = (np.asarray(a) for a in compile_fast(apply, *call)(*call))

    model = build_model(args, 40)
    load_checkpoint_into(model, str(run_dir / best))
    model.eval()
    with torch.no_grad():
        out, w = model(torch.from_numpy(rgb), torch.from_numpy(depth),
                       hard=True, return_weight=True)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(w.numpy(), ref_w)


def test_last_ckpt_resumes_at_the_next_epoch(run_dir, tmp_path):
    run2 = _train(tmp_path, "--epochs", "3", "--last_ckpt",
                  str(run_dir / "ckpt_latest.msgpack"))
    with open(run2 / "logs.csv", newline="") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["2"]
    payload = jax_ckpt.load_checkpoint(str(run2 / "ckpt_latest.msgpack"))
    assert payload["epoch"] == 2
    assert payload["state"]["opt_state"]["count"] == 6  # 3 epochs × 2 steps


@pytest.mark.parametrize("flags", [
    ["--modality", "rgb"], ["--mesh-data", "2"], ["--dtype", "bfloat16"],
    ["--quant", "int8"]],
    ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_args([*TINY, *flags])


@pytest.mark.parametrize("flags", [
    ["--dataset", "nyuv2"], ["--packed_stem"],
    ["--pretrained_scenenet", "x.pth"]],
    ids=lambda f: f[0].lstrip("-"))
def test_flags_ported_with_the_eval_slice_parse(flags):
    """Flags that raised until the eval/predict slice ported their
    features: they parse, and the packed stem packs the train batches in
    the loader's prefetch thread."""
    from dynmm_tpu_torch.cli.seg_build import prepare_data
    from dynmm_tpu_torch.data.seg_preprocessing import pack_stem_batch

    args = parse_args([*TINY, *flags])
    if flags[0] == "--packed_stem":
        train_loader, valid_loader = prepare_data(args)
        assert train_loader.post is pack_stem_batch
        assert valid_loader.post is None  # validation packs after noise
        batch = next(iter(train_loader))
        assert batch["image"].shape == (2, H // 2, W // 2, 12)
        assert batch["depth"].shape == (2, H // 2, W // 2, 4)
    else:
        assert getattr(args, flags[0].lstrip("-")) == flags[1]


def test_local_gate_and_static_models_raise():
    for drop in (["--global-gate"], ["--dynamic", "--global-gate"]):
        with pytest.raises(NotImplementedError, match="A7"):
            parse_args([a for a in TINY if a not in drop])


def _tiny_model():
    return build_model(parse_args(TINY), 40)


def test_finetune_reads_a_reference_pth(tmp_path):
    src = _tiny_model()
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.encoder_rgb.bn1.num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": sd, "epoch": 7}, tmp_path / "ref.pth")
    dst = _tiny_model()
    # what --finetune calls for a .pth
    load_any_checkpoint(dst, str(tmp_path / "ref.pth"))
    ours, ref = dst.state_dict(), src.state_dict()
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


@pytest.mark.parametrize("flag, printed", [
    ("--finetune", "unconsumed: bogus_extra"),
    ("--pretrained_scenenet", "scenenet import: 1 unconsumed keys")],
    ids=["finetune", "pretrained_scenenet"])
def test_train_cli_merges_a_pth_non_strictly(tmp_path, monkeypatch, capsys,
                                             flag, printed):
    """``cli.train.main`` with a ``.pth`` holding an extra key and lacking
    one: the extra key is reported as the JAX importer reports it, the
    missing one keeps the model's value, the rest is the file's."""
    import dynmm_tpu_torch.cli.train as train_cli
    from dynmm_tpu_torch.train.seg import SegTrainer

    src = _tiny_model()
    for p in src.parameters():  # other values than a fresh model's
        p.data.add_(1.0)
    dropped = "encoder_depth.bn1.weight"
    sd = dict(src.state_dict())
    sd.pop(dropped)
    sd["bogus_extra"] = torch.ones(3)
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "odd.pth")

    built, trained = [], []

    def build(args, n_classes):
        model = _tiny_model()
        built.append((model, {k: v.clone()
                              for k, v in model.state_dict().items()}))
        return model

    monkeypatch.setattr(train_cli, "build_model", build)
    monkeypatch.setattr(SegTrainer, "fit",
                        lambda self, *a, **k: trained.append(self.model))
    train_cli.main([*TINY, "--epochs", "1", "--results_dir",
                    str(tmp_path / "out"), flag, str(tmp_path / "odd.pth")])
    out = capsys.readouterr().out
    assert printed in out and "Training completed" in out
    ((model, start),) = built
    assert trained == [model]
    got, file = model.state_dict(), src.state_dict()
    # the model's own value where the file lacks the key
    assert torch.equal(got[dropped], start[dropped])
    assert not torch.equal(got[dropped], file[dropped])
    assert torch.equal(got["encoder_rgb.conv1.weight"],
                       file["encoder_rgb.conv1.weight"])
    head = "decoder.conv_out.weight"  # SceneNet's import drops the heads
    assert torch.equal(got[head], file[head] if flag == "--finetune"
                       else start[head])


def test_he_init_redraws_the_jax_set_of_kernels(monkeypatch):
    model = _tiny_model()
    before = flax_from_state_dict(model.state_dict())["params"]
    apply_he_init(model, torch.Generator().manual_seed(42), 40)
    after = flax_from_state_dict(model.state_dict())["params"]
    # which kernels the JAX function re-draws; its draws (one XLA program per
    # shape) are replaced by a constant
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: np.full(shape, 7.0, dtype))
    monkeypatch.setattr(jax.random, "split", lambda key: (key, key))
    ref = jax_he_init(before, jax.random.PRNGKey(42), 40)
    paths = lambda t: {jax.tree_util.keystr(p): np.asarray(x)
                       for p, x in jax.tree_util.tree_leaves_with_path(t)}
    b, a, r = paths(before), paths(after), paths(ref)
    changed = {k for k in b if not np.array_equal(a[k], b[k])}
    assert changed == {k for k in b if not np.array_equal(r[k], b[k])}
    assert len(changed) > 50
    for k in changed:  # fan-out He std
        kh, kw, _, c_out = a[k].shape
        assert a[k].std() == pytest.approx(np.sqrt(2 / (kh * kw * c_out)),
                                           rel=0.5)


def test_training_runs_on_the_card_unless_asked(monkeypatch):
    from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegTrainer(_tiny_model(), SegTrainConfig(), np.ones(40))
    args = [a for a in TINY if a not in ("--device", "cpu")]
    assert parse_args(args).device is None
