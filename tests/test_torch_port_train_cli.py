"""``python -m dynmm_tpu_torch.cli.train`` on the CPU at a small NBt1D shape:
two epochs of two steps write the JAX trainer's artifacts (``logs.csv``
with the header the JAX trainer wrote for the recipe run, confusion-matrix
pickles, the rolling and best checkpoints, ``finished.txt``); the best
checkpoint loads into the JAX model and gives the port's eval logits
(within 1e-4 of their largest magnitude, identical gate choices);
``--last_ckpt`` resumes at the next epoch; ``--activation swish`` trains
as JAX's ``train.py`` does on the same flags and weights, and so does
``--dtype bfloat16`` (within bf16's bounds); flags of
features not ported raise (those ported since train as JAX's do:
``--mesh-data 2`` as the one-process CLI); ``--finetune`` reads a
reference-style ``.pth``; ``--he_init`` re-draws the same kernels as the JAX package's."""

import csv
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_eval_setup import run_jax_cli, run_port_cli
from _port_train_setup import compile_fast
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu.utils.init import apply_he_init as jax_he_init
from dynmm_tpu_torch.cli import train as train_cli
from dynmm_tpu_torch.cli.seg_build import build_config, build_model
from dynmm_tpu_torch.cli.train import parse_args
from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
from dynmm_tpu_torch.utils.init import apply_he_init
from dynmm_tpu_torch.train.seg import SegTrainer
from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
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


def _train_output(results: Path, *extra: str) -> str:
    """What ``python -m dynmm_tpu_torch.cli.train`` printed for the TINY
    flags and ``extra`` (its ranks' output too)."""
    proc = subprocess.run(
        [sys.executable, "-m", "dynmm_tpu_torch.cli.train", *TINY,
         "--results_dir", str(results), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Training completed" in proc.stdout
    return proc.stdout


def _train(results: Path, *extra: str) -> Path:
    _train_output(results, *extra)
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


def _seeded_start(tmp_path: Path) -> str:
    """The rolling checkpoint of two epochs of the one-process CLI from
    weights drawn with torch's generator seeded 0 (torch seeds it at random
    in each process, so ``run_dir``'s weights differ from run to run)."""
    torch.manual_seed(0)
    v = flax_from_state_dict(build_model(parse_args(TINY), 40).state_dict())
    init = tmp_path / "init.msgpack"
    save_checkpoint(str(init), {"params": v["params"], "model_state": {
        "batch_stats": v["batch_stats"]}}, 0)
    run_port_cli(train_cli, [
        *(a for a in TINY if a not in ("--device", "cpu")), "--epochs", "2",
        "--finetune", str(init), "--results_dir", str(tmp_path / "start")])
    (run,) = (tmp_path / "start" / "synthetic").iterdir()
    return str(run / "ckpt_latest.msgpack")


def _float64_output(monkeypatch, argv: list[str]) -> str:
    """The one-process CLI's output on ``argv`` with the model and every
    float batch in float64."""
    build, tensor = train_cli.build_model, SegTrainer._tensor

    def to64(self, x):
        t = tensor(self, x)
        return t.double() if t.is_floating_point() else t

    with monkeypatch.context() as m:
        m.setattr(train_cli, "build_model",
                  lambda args, n: build(args, n).double())
        m.setattr(SegTrainer, "_tensor", to64)
        return run_port_cli(train_cli, argv)


@pytest.mark.parametrize("flags", [["--mesh-data", "2"], ["--quant", "int8"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise(tmp_path, monkeypatch, flags):
    """``--quant`` in training raises, as JAX's ``train.py`` refuses it.
    ``--mesh-data 2`` (ported) trains on a 2×1 mesh of two ranks the
    command starts itself, from the same seeded weights (``--finetune``)
    as the one-process CLI; rank 0 alone prints (the JAX CLI's mesh line
    once) and writes. Its epoch line and test-mIoU line equal the
    one-process CLI's, the numbers within the last printed digit, and its
    ``logs.csv`` losses lie within 1e-5 relative of the one-process run's;
    both bounds grow to 4× the one-process run's own relative distance
    from its float64 twin where that is larger. fp32 rounding moves a
    step's loss by an amount that depends on the weights: from these
    weights the one-process fp32 run lies 1.1e-4 from float64 and the mesh
    run 2.6e-7, and in twelve weight draws the mesh run lay at most
    1.75× as far from the one-process run as that run from float64."""
    if flags[0] == "--quant":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            parse_args([*TINY, *flags])
        return
    common = ["--epochs", "1", "--finetune", _seeded_start(tmp_path)]
    argv = [*(a for a in TINY if a not in ("--device", "cpu")), *common]
    mesh_out = _train_output(tmp_path / "mesh", *common, *flags)
    one_out = run_port_cli(train_cli, [
        *argv, "--results_dir", str(tmp_path / "one")])
    _float64_output(monkeypatch, [*argv, "--results_dir",
                                  str(tmp_path / "f64")])
    keys = ("loss_train_total", "loss_flop", "loss_train_full_size")
    rows = {}
    for name in ("mesh", "one", "f64"):
        (run,) = (tmp_path / name / "synthetic").iterdir()
        with open(run / "logs.csv", newline="") as f:
            row = next(csv.DictReader(f))
        rows[name] = np.array([float(row[k]) for k in keys])
    witness = np.max(np.abs(rows["one"] - rows["f64"]) / np.abs(rows["f64"]))
    print("mesh − one:", np.abs(rows["mesh"] - rows["one"]) / np.abs(
        rows["one"]), "one − float64:", witness)
    assert mesh_out.count("Using device mesh {'data': 2, 'model': 1}") == 1
    assert mesh_out.count("Training completed") == 1
    got, want = _epoch_lines(mesh_out), _epoch_lines(one_out)
    print("mesh:", got, "\none: ", want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                assert float(a) == pytest.approx(float(b), rel=0, abs=max(
                    2e-4, 4 * witness * abs(float(b))))
            except ValueError:
                assert a == b
    for key, m, o in zip(keys, rows["mesh"], rows["one"]):
        assert m == pytest.approx(o, rel=max(1e-5, 4 * witness)), key


def _epoch_lines(text: str) -> list[list[str]]:
    """The fields of each epoch's train-loss and test-mIoU lines."""
    return [re.split(r" \| |: | ", ln) for ln in text.splitlines()
            if ln.startswith(("Epoch ", "Test mIoU"))]


def test_swish_train_matches_jax(run_dir, tmp_path, monkeypatch):
    """``--activation swish`` through both train CLIs on the same flags,
    from the same weights (``--finetune`` of the relu run's checkpoint: an
    activation has no weights), one step (``--synthetic_n 2``): the
    epoch's train-loss line, and the test-mIoU line after the step, as the
    JAX CLI's, the numbers within the last printed digit (fp32 sums in
    other orders), the temperature and lr fields equal."""
    flags = ["--activation", "swish", "--epochs", "1", "--synthetic_n", "2",
             "--finetune", str(run_dir / "ckpt_latest.msgpack")]
    argv = [a for a in TINY if a not in ("--device", "cpu")] + flags
    jax_out = run_jax_cli("train", [*argv, "--results_dir",
                                    str(tmp_path / "jax")], monkeypatch)
    port_out = run_port_cli(train_cli, [*argv, "--results_dir",
                                        str(tmp_path / "port")])
    shutil.rmtree(tmp_path)  # both runs' checkpoints
    got, want = _epoch_lines(port_out), _epoch_lines(jax_out)
    print("port:", got, "\nJAX: ", want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                assert float(a) == pytest.approx(float(b), rel=0, abs=2e-4)
            except ValueError:
                assert a == b


def _walk_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk_leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


class _StrictStep:
    """A JAX train step compiled, once for each argument shapes, with
    ``xla_allow_excess_precision`` off: every op rounds to its dtype."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, {}

    def __call__(self, *args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(a), np.result_type(a)) for a in leaves))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 1,
                                  "xla_allow_excess_precision": False})
        return self.compiled[key](*args)


def _strict_jax_steps(monkeypatch):
    """The JAX ``SegTrainer``'s train steps as ``_StrictStep``s."""
    get = jax_seg.SegTrainer._get_train_step

    def strict(self, flags_key):
        step = get(self, flags_key)
        if not isinstance(step, _StrictStep):
            step = self._train_steps[flags_key] = _StrictStep(step)
        return step

    monkeypatch.setattr(jax_seg.SegTrainer, "_get_train_step", strict)


def _moves(ckpt: dict, start: dict, prefix: str) -> np.ndarray:
    """The leaves under ``prefix`` of a checkpoint minus the start's, one
    float64 vector."""
    return np.concatenate([
        (ckpt[k].astype(np.float64) - start[k].astype(np.float64)).ravel()
        for k in sorted(start) if k.startswith(prefix)])


def test_bf16_train_matches_jax(run_dir, tmp_path, monkeypatch):
    """``--dtype bfloat16`` through both train CLIs on the same flags, from
    the same weights (``--finetune`` of the fp32 run's checkpoint), one
    step of B = 8 (the PPM's 1×1 bin normalises over the batch), the JAX
    step rounding every op to its dtype (``tests/test_torch_port_bf16_
    train.py``). The port's fp32 CLI takes the same step: the fp32 distance
    (``tests/test_torch_port_train_steps.py`` holds its step to JAX's).

    - The epoch's train-loss line: the JAX CLI's fields (the FLOP loss,
      temperature and lr within the last printed digit), the loss within
      5e-3 relative (observed up to 5.7e-4; the ½ rule's bound in the
      whole-step test is 4.8e-3, and the fp32 loss here can lie as close
      to JAX's bf16 loss as the port's bf16 loss does).
    - The step's new BN statistics closer to JAX's bf16 ones than the
      port's fp32 step's are (relative L2). The ½ rule that the whole-step
      test holds at random init does not hold on these trained weights:
      each package's summation order flips more bf16 roundings with depth,
      until the deepest statistics sit near the fp32 distance.
    - Its updates closer to JAX's bf16 updates than a zero update is, at a
      norm within a factor 2 of JAX's.
    - Both checkpoints hold fp32 parameters and statistics in the same
      tree, the optimizer state in the same optax layout and dtypes."""
    start = str(run_dir / "ckpt_latest.msgpack")
    # one device: the JAX CLI shards a batch over the test's 8 CPU devices
    # otherwise, and sums bf16 gradients across them
    flags = ["--epochs", "1", "--synthetic_n", "8", "--finetune", start,
             "--mesh-data", "1"]
    argv = [a for a in TINY if a not in ("--device", "cpu")] + flags
    argv[argv.index("--batch_size") + 1] = "8"
    bf16 = ["--dtype", "bfloat16"]
    _strict_jax_steps(monkeypatch)
    outs = {"jax": run_jax_cli("train", [*argv, *bf16, "--results_dir",
                                         str(tmp_path / "jax")], monkeypatch),
            "port": run_port_cli(train_cli, [*argv, *bf16, "--results_dir",
                                             str(tmp_path / "port")]),
            "fp32": run_port_cli(train_cli, [*argv, "--results_dir",
                                             str(tmp_path / "fp32")])}
    ckpts = {}
    for side in outs:
        (path,) = (tmp_path / side / "synthetic").glob(
            "checkpoints_*/ckpt_latest.msgpack")
        ckpts[side] = dict(_walk_leaves(
            jax_ckpt.load_checkpoint(str(path))["state"]))
    begin = dict(_walk_leaves(jax_ckpt.load_checkpoint(start)["state"]))
    shutil.rmtree(tmp_path)  # the runs' checkpoints
    got, want, fp32 = (_epoch_lines(outs[s])[0]
                       for s in ("port", "jax", "fp32"))
    print("port:", got, "\nJAX: ", want, "\nport fp32:", fp32)
    assert len(got) == len(want)
    loss = got.index("loss") + 1
    for i, (a, b) in enumerate(zip(got, want)):
        try:
            assert float(a) == pytest.approx(float(b), rel=5e-3 if i == loss
                                             else 0, abs=2e-4)
        except ValueError:
            assert a == b
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    moves = {side: {part: _moves(ckpts[side], begin, prefix)
                    for part, prefix in (("stats", "/model_state"),
                                         ("updates", "/params"))}
             for side in ckpts}
    ref = moves["jax"]
    stats, stats32 = (rel(moves[s]["stats"], ref["stats"])
                      for s in ("port", "fp32"))
    upd = rel(moves["port"]["updates"], ref["updates"])
    size = (np.linalg.norm(moves["port"]["updates"])
            / np.linalg.norm(ref["updates"]))
    print(f"BN statistics: err(port bf16, JAX bf16) {stats:.3g}, the port's "
          f"fp32 step {stats32:.3g}; updates {upd:.3g} (a zero update 1), "
          f"norm ratio {size:.3g}")
    assert stats < stats32
    assert upd < 1.0 and 0.5 <= size <= 2.0
    assert sorted(ckpts["port"]) == sorted(ckpts["jax"])
    for k, v in ckpts["jax"].items():
        assert (ckpts["port"][k].dtype, ckpts["port"][k].shape) == (
            v.dtype, v.shape), k
        if not k.startswith("/opt_state"):
            assert v.dtype == np.float32, k


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
    """They raised until the variants were ported; now the flags parse and
    build the local-gate SkipESANet and the static ESANet (and
    ``--modality rgb`` the one-modality model)."""
    from dynmm_tpu_torch.models.esanet import ESANet
    from dynmm_tpu_torch.models.one_modality import ESANetOneModality
    from dynmm_tpu_torch.models.skip_local import SkipESANet

    for drop, extra, cls in (
            (["--global-gate"], [], SkipESANet),
            (["--dynamic", "--global-gate"], [], ESANet),
            (["--dynamic", "--global-gate"], ["--modality", "rgb"],
             ESANetOneModality)):
        args = parse_args([a for a in TINY if a not in drop] + extra)
        assert type(build_model(args, 40)) is cls


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
