"""``python -m dynmm_tpu_torch.cli.eval`` against the JAX package's
``eval.py`` on the CPU, from one JAX msgpack checkpoint of the small NBt1D
model (the recipe gate merged: the samples take paths 0, 2 and 3) and one
prepared NYUv2 layout written with cv2 (6 test samples at 72×104, so B=4
leaves a ragged tail batch of 2 and the model's 64×96 input is scored at
the files' size): hard, the noise runs, quarter resolution, capacity factor
8.0 (equal to hard), the packed stem, and ``--valid_full_res
--per_class_iou`` on a multi-camera SUNRGB-D layout. Per-run mIoU within
0.05 points, branch ratio and FLOP lines equal.

Also the ``.pth`` import (``utils/torch_import.py``) against the JAX
importer: a state_dict with an extra key, a missing gate key and BN
counters loads into the same parameters with the same unconsumed key, in
the library and through the CLI; whole-module pickles load; the flags the
port does not have yet raise naming their ROADMAP item."""

import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _port_eval_setup import (MODEL_FLAGS, lines_with, random_variables,
                              run_jax_cli, run_mious, run_port_cli,
                              save_jax_checkpoint, write_prepared)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.utils import torch_import as jax_import
from dynmm_tpu.utils.torch_export import export_state_dict
from dynmm_tpu_torch.cli import eval as port_eval
from dynmm_tpu_torch.cli.seg_build import build_model
from dynmm_tpu_torch.utils import torch_import
from dynmm_tpu_torch.utils.weights import flax_from_state_dict

MODEL = [*MODEL_FLAGS, "--dynamic", "--global-gate", "--hard"]
# a gate BN statistic: both packages initialise it to 1, so the CLIs'
# models agree on it where the file lacks it
DROPPED = "gate_layer.conv.1.running_var"
EXTRA = "bogus_extra"


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = write_prepared(tmp_path_factory.mktemp("nyuv2"), 6)
    variables = random_variables(seed=0)
    ckpt = save_jax_checkpoint(root / "ckpt.msgpack", variables)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_state_dict(variables["params"],
                            variables["batch_stats"]).items()}
    torch.save(sd, root / "ckpt.pth")
    # the repair's checkpoint: an extra key, a missing gate key and the BN
    # counters a torch-trained model carries
    odd = dict(sd)
    odd.pop(DROPPED)
    odd[EXTRA] = torch.ones(3)
    odd["encoder_rgb.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save({"state_dict": odd, "epoch": 3}, root / "odd.pth")
    return {"root": root, "ckpt": ckpt, "variables": variables,
            "args": ["--dataset", "nyuv2", "--dataset_dir", str(root),
                     *MODEL]}


def _compare(jax_out: str, port_out: str, n_runs: int = 1) -> list[float]:
    j, p = run_mious(jax_out), run_mious(port_out)
    assert len(j) == len(p) == n_runs
    np.testing.assert_allclose(p, j, rtol=0, atol=0.05)
    assert lines_with(port_out, "branch ratios") == lines_with(
        jax_out, "branch ratios")
    assert lines_with(port_out, "Mean") and lines_with(jax_out, "Mean")
    return p


MODES = {
    "hard": [],
    "noise": ["--num_runs", "2", "--mode", "2", "--noise", "0.5"],
    "quarter": ["--output_res", "quarter"],
    "capacity": ["--capacity_factor", "8.0"],
    "packed": ["--packed_stem"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_matches_jax(layout, monkeypatch, mode):
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], *MODES[mode]]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    mious = _compare(jax_out, port_out, 2 if mode == "noise" else 1)
    ratios = lines_with(port_out, "branch ratios")[0]
    assert "0.5 " in ratios or "0.333" in ratios  # a mix of paths
    if mode == "capacity":
        assert lines_with(port_out, "capacity-factor") == lines_with(
            jax_out, "capacity-factor")
        hard = port_eval.main([*layout["args"], "--ckpt_path",
                               layout["ckpt"], "--device", "cpu"])
        np.testing.assert_array_equal(
            port_eval.main([*argv, "--device", "cpu"]), hard)
    if mode == "noise":  # the noise changed something
        clean = run_mious(run_port_cli(port_eval, argv[:-6]))
        assert mious != clean * 2


def test_eval_pth_equals_msgpack(layout):
    base = [*layout["args"], "--device", "cpu"]
    from_msgpack = port_eval.main([*base, "--ckpt_path", layout["ckpt"]])
    from_pth = port_eval.main([*base, "--ckpt_path",
                               str(layout["root"] / "ckpt.pth")])
    np.testing.assert_array_equal(from_pth, from_msgpack)


def test_eval_full_res_cameras_per_class_iou(tmp_path, monkeypatch):
    root = write_prepared(tmp_path, 4, h=64, w=96, label_dir="labels_37",
                          n_classes=37,
                          cameras=["realsense", "kv2", "kv1", "xtion"])
    ckpt = save_jax_checkpoint(tmp_path / "ckpt.msgpack",
                               random_variables(n_classes=37, seed=2))
    argv = ["--dataset", "sunrgbd", "--dataset_dir", str(root), *MODEL,
            "--ckpt_path", ckpt, "--valid_full_res", "--per_class_iou"]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    _compare(jax_out, port_out)
    j_cam, p_cam = (re.findall(r"(\w+): ([\d.]+)",
                               lines_with(out, "per-camera mIoU")[0])
                    for out in (jax_out, port_out))
    assert [c for c, _ in p_cam] == [c for c, _ in j_cam] == [
        "realsense", "kv2", "kv1", "xtion"]
    np.testing.assert_allclose([float(v) for _, v in p_cam],
                               [float(v) for _, v in j_cam], atol=0.05)
    table = [lines_with(out, "class_") for out in (jax_out, port_out)]
    assert len(table[0]) == len(table[1]) == 37
    np.testing.assert_allclose([float(t.split()[-1]) for t in table[1]],
                               [float(t.split()[-1]) for t in table[0]],
                               atol=0.05)


def _port_variables(model) -> dict:
    v = flax_from_state_dict(model.state_dict())
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _fresh(layout, seed: int):
    """The small port model holding other seeded weights than the file."""
    from dynmm_tpu_torch.cli.eval import build_parser
    from dynmm_tpu_torch.utils.weights import load_flax_variables

    args = build_parser().parse_args([*layout["args"], "--ckpt_path", "x"])
    model = build_model(args, 40)
    other = random_variables(seed=seed)
    load_flax_variables(model, other)
    return model, other


def test_pth_import_equals_jax_importer(layout, capsys):
    path = str(layout["root"] / "odd.pth")
    model, start = _fresh(layout, seed=9)
    report = torch_import.import_torch_checkpoint(model, path)
    assert report == [f"unconsumed: {EXTRA}"]
    assert f"unconsumed: {EXTRA}" in capsys.readouterr().out
    params, state = jax_import.import_torch_checkpoint(
        path, start["params"], {"batch_stats": start["batch_stats"]})
    got = _port_variables(model)
    want = {"params": params, "batch_stats": state["batch_stats"]}

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=path)

    walk(got, want)
    # the missing gate statistic kept the model's value, the rest is the
    # file's
    np.testing.assert_array_equal(
        got["batch_stats"]["gate_layer"]["bn1"]["var"],
        start["batch_stats"]["gate_layer"]["bn1"]["var"])
    np.testing.assert_array_equal(
        got["params"]["decoder"]["conv_out"]["kernel"],
        layout["variables"]["params"]["decoder"]["conv_out"]["kernel"])


def test_scenenet_pretrain_import_equals_jax(layout, tmp_path, capsys):
    """A 13-class SceneNet checkpoint into the 40-class model: the heads and
    logit upsamples are dropped, the rest merges as in the JAX package."""
    src = random_variables(n_classes=13, seed=5)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_state_dict(src["params"], src["batch_stats"]).items()}
    torch.save({"state_dict": sd}, tmp_path / "scenenet.pth")
    model, start = _fresh(layout, seed=6)
    report = torch_import.import_scenenet_pretrain(
        model, str(tmp_path / "scenenet.pth"), context_module="ppm")
    assert report == []
    params, state = jax_import.import_scenenet_pretrain(
        str(tmp_path / "scenenet.pth"), start["params"],
        {"batch_stats": start["batch_stats"]}, context_module="ppm")
    got = _port_variables(model)
    for tree, want in ((got["params"], params),
                       (got["batch_stats"], state["batch_stats"])):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node = tree
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf),
                                          err_msg=str(path))
    # the class-count-dependent head kept the target's weights
    np.testing.assert_array_equal(
        got["params"]["decoder"]["conv_out"]["kernel"],
        start["params"]["decoder"]["conv_out"]["kernel"])
    np.testing.assert_array_equal(
        got["params"]["encoder_rgb"]["conv1"]["kernel"],
        src["params"]["encoder_rgb"]["conv1"]["kernel"])


def test_pth_import_through_the_eval_cli(layout, monkeypatch):
    argv = [*layout["args"], "--ckpt_path", str(layout["root"] / "odd.pth")]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    _compare(jax_out, port_out)
    assert lines_with(port_out, "unconsumed") == lines_with(jax_out,
                                                            "unconsumed")
    assert lines_with(port_out, "unconsumed") == [f"unconsumed: {EXTRA}"]


def test_pth_shape_mismatch_raises(layout, tmp_path):
    sd = torch.load(layout["root"] / "ckpt.pth")
    sd[DROPPED] = torch.ones(9)
    torch.save(sd, tmp_path / "bad.pth")
    model, _ = _fresh(layout, seed=1)
    with pytest.raises(ValueError, match=f"shape mismatch at {DROPPED}"):
        torch_import.import_torch_checkpoint(model, str(tmp_path / "bad.pth"))


def test_whole_module_pickles_load(layout, tmp_path):
    # a module of the port's own classes
    model, _ = _fresh(layout, seed=3)
    torch.save(model, tmp_path / "whole.pth")
    other, _ = _fresh(layout, seed=4)
    assert torch_import.import_torch_checkpoint(
        other, str(tmp_path / "whole.pth")) == []
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # a module whose class cannot be imported where it is read: the stub
    # unpickler recovers the same tensors as the JAX package's
    mod = types.ModuleType("_vanishing_classes")

    class Branch(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 2)
            self.register_buffer("stat", torch.arange(4.0))

    Branch.__module__ = mod.__name__
    Branch.__qualname__ = "Branch"
    mod.Branch = Branch
    sys.modules[mod.__name__] = mod
    try:
        torch.save(Branch(), tmp_path / "stub.pt")
    finally:
        del sys.modules[mod.__name__]
    got = torch_import.load_torch_module_pickle(str(tmp_path / "stub.pt"))
    want = jax_import.load_torch_module_pickle(str(tmp_path / "stub.pt"))
    assert sorted(got) == sorted(want) == ["fc.bias", "fc.weight", "stat"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_plain_checkpoints_load_weights_only(layout, tmp_path, monkeypatch):
    """A bare state_dict and a dict checkpoint are read with
    ``weights_only=True`` alone; only a whole pickled module, which that
    refuses, is unpickled in full."""
    calls, load = [], torch.load

    def spy(*args, **kwargs):
        calls.append(kwargs.get("weights_only"))
        return load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    model, _ = _fresh(layout, seed=2)
    for name in ("ckpt.pth", "odd.pth"):
        calls.clear()
        torch_import.import_torch_checkpoint(model, str(layout["root"] / name))
        assert calls == [True], name
    torch.save(model, tmp_path / "whole.pth")
    calls.clear()
    assert torch_import.import_torch_checkpoint(
        model, str(tmp_path / "whole.pth")) == []
    assert calls == [True, False]


def test_missing_checkpoint_exits(layout, capsys):
    with pytest.raises(SystemExit) as e:
        port_eval.main([*layout["args"], "--ckpt_path", "/nonexistent.pth",
                        "--device", "cpu"])
    assert e.value.code == 1
    assert "=> no checkpoint found at '/nonexistent.pth'" in \
        capsys.readouterr().out


@pytest.mark.parametrize("flags, item", [
    (["--quant", "int8"], "A6"), (["--dtype", "bfloat16"], "A3"),
    (["--modality", "rgb"], "A7")], ids=["int8", "bf16", "one-modality"])
def test_unported_eval_flags_raise(layout, flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        port_eval.main([*layout["args"], "--ckpt_path", layout["ckpt"],
                        "--device", "cpu", *flags])


def test_capacity_factor_needs_hard(layout):
    argv = [a for a in layout["args"] if a != "--hard"]
    with pytest.raises(SystemExit):
        port_eval.main([*argv, "--ckpt_path", layout["ckpt"], "--device",
                        "cpu", "--capacity_factor", "1.25"])
