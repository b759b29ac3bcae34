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
the library and through the CLI; whole-module pickles load; the nets the
JAX factory refuses to quantize raise as there. ``--activation swish``
scores the swish nets against the JAX CLI's (fp32 and bf16).

``--dtype bfloat16`` scores the net in bf16 against the JAX CLI at bf16:
the two packages round at other points, so the class maps are held equal
on the pixels whose top-two logit margin exceeds the measured logit error
(``bf16_class_maps``), and both mIoUs are printed. The same for the
static ESANet, in bf16 and with ``--quant int8 --dtype bfloat16``."""

import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _port_eval_setup import (MODEL_FLAGS, bf16_class_maps,
                              int8_class_maps, lines_with, random_variables,
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


@pytest.mark.parametrize("calib", [
    [], ["--calib_estimator", "percentile", "--calib_percentile", "99.9"]],
    ids=["absmax", "percentile"])
def test_eval_int8_matches_jax(layout, monkeypatch, calib):
    """``--quant int8``: the calibration line, mIoU and branch ratios of the
    JAX CLI (the two int8 nets differ by rounding flips at quantization
    boundaries, which move the mIoU in its last printed digit at most)."""
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], "--quant",
            "int8", "--calib_batches", "2", *calib]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    print("int8 eval:", lines_with(jax_out, "Run"),
          lines_with(port_out, "Run"))
    assert lines_with(port_out, "Calibrated int8") == lines_with(
        jax_out, "Calibrated int8")
    assert lines_with(port_out, "Calibrated int8")
    _compare(jax_out, port_out)


# the nets --quant int8 does not take, which the JAX factory refuses too:
# the local-gate net and the one-modality net (no quantized conv)
@pytest.mark.parametrize("flags, drop, match", [
    (["--quant", "int8"], ("--global-gate",),
     "--quant supports global-gate / static models only"),
    (["--quant", "int8", "--modality", "rgb"],
     ("--dynamic", "--global-gate"), "only, not ESANetOneModality")],
    ids=["int8", "int8-one-modality"])
def test_unported_eval_flags_raise(layout, flags, drop, match):
    args = [a for a in layout["args"] if a not in drop]
    with pytest.raises(NotImplementedError, match=match):
        port_eval.main([*args, "--ckpt_path", layout["ckpt"], "--device",
                        "cpu", *flags])


@pytest.mark.parametrize("net", ["bf16", "swish"])
def test_eval_swish_matches_jax(layout, request, monkeypatch, net):
    """The swish nets of the relu checkpoints (an activation has no
    weights), scored by both CLIs on the same flags: ``swish``, the fp32
    global-gate net, its mIoU within 0.05 points and its branch-ratio line
    equal (``_compare``); ``bf16``, the bf16 static net, by the margin rule
    of ``test_eval_static_bf16_matches_jax``."""
    if net == "swish":
        argv = [*layout["args"], "--ckpt_path", layout["ckpt"],
                "--activation", "swish"]
        _compare(run_jax_cli("eval", argv, monkeypatch),
                 run_port_cli(port_eval, argv))
        return
    static = request.getfixturevalue("static")
    argv = [*static["args"], "--dtype", "bfloat16", "--activation", "swish"]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    j, p = run_mious(jax_out), run_mious(port_out)
    maps = bf16_class_maps(argv, static["variables"], label_size=True,
                           static=True)
    print(f"static swish bf16 eval mIoU: JAX {j}, port {p}; class maps "
          f"equal on the {maps['sure'].mean() * 100:.2f} % of pixels with "
          f"margin > 2x{maps['err']:.3g}")
    assert len(j) == len(p) == 1
    assert maps["err"] < 5e-2 * maps["scale"]
    assert maps["sure"].mean() > 0.25
    np.testing.assert_array_equal(maps["port"][maps["sure"]],
                                  maps["jax"][maps["sure"]])


@pytest.mark.parametrize("mode", ["noise", "quarter", "capacity", "packed"])
def test_eval_bf16_chains_run(layout, mode):
    """Eval's noise, quarter-resolution, capacity-factor and packed-stem
    chains on the bf16 net; capacity 8.0 scores the exact chain's mIoU."""
    base = [*layout["args"], "--ckpt_path", layout["ckpt"], "--device",
            "cpu", "--dtype", "bfloat16"]
    result = port_eval.main([*base, *MODES[mode]])
    assert len(result) == (2 if mode == "noise" else 1)
    assert np.isfinite(result).all()
    if mode == "capacity":
        np.testing.assert_array_equal(result, port_eval.main(base))


def test_eval_bf16_matches_jax(layout, monkeypatch):
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], "--dtype",
            "bfloat16"]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    j, p = run_mious(jax_out), run_mious(port_out)
    maps = bf16_class_maps(argv, layout["variables"], label_size=True)
    print(f"bf16 eval mIoU: JAX {j}, port {p}; class maps equal on the "
          f"{maps['sure'].mean() * 100:.2f} % of pixels with margin > "
          f"2x{maps['err']:.3g}")
    assert len(j) == len(p) == 1
    assert lines_with(port_out, "branch ratios") == lines_with(
        jax_out, "branch ratios")
    assert maps["sure"].mean() > 0.5
    np.testing.assert_array_equal(maps["port"][maps["sure"]],
                                  maps["jax"][maps["sure"]])


@pytest.fixture(scope="module")
def static(layout):
    """A checkpoint of the small static ESANet (SE-add) on the layout, and
    the eval flags that build it."""
    variables = random_variables(seed=7, static=True)
    ckpt = save_jax_checkpoint(layout["root"] / "static.msgpack", variables)
    args = [a for a in layout["args"]
            if a not in ("--dynamic", "--global-gate", "--hard")]
    return {"variables": variables, "args": [*args, "--ckpt_path", ckpt]}


def test_eval_static_bf16_matches_jax(static, monkeypatch):
    """The static ESANet in bf16 against the JAX CLI at bf16: the logits at
    the labels' size within 5e-2 of max |JAX logits| (the whole-net bf16
    bound) and the class maps equal wherever the margin rule applies. This
    net's random weights leave most pixels' top-two margins within the
    two bf16 nets' error (JAX's own bf16 and fp32 nets differ by 1.8 % in
    relative L2 here), so the rule is asked to cover a quarter of them."""
    argv = [*static["args"], "--dtype", "bfloat16"]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    j, p = run_mious(jax_out), run_mious(port_out)
    maps = bf16_class_maps(argv, static["variables"], label_size=True,
                           static=True)
    print(f"static bf16 eval mIoU: JAX {j}, port {p}; class maps equal on "
          f"the {maps['sure'].mean() * 100:.2f} % of pixels with margin > "
          f"2x{maps['err']:.3g}")
    assert len(j) == len(p) == 1
    assert maps["err"] < 5e-2 * maps["scale"]
    assert maps["sure"].mean() > 0.25
    np.testing.assert_array_equal(maps["port"][maps["sure"]],
                                  maps["jax"][maps["sure"]])


def test_eval_static_int8_bf16_matches_jax(static, monkeypatch):
    """``--quant int8 --dtype bfloat16`` on the static ESANet against the
    JAX CLI, on the int8 rules of ``test_torch_port_quant.py`` (which holds
    this net's every conv exactly on JAX's inputs, ``static-bf16``): the
    two int8 nets differ by rounding flips at quantization boundaries that
    cascade, here on top of bf16's own 2 % (relative L2, the bf16 test
    above), so their H/4 logits are held by the JAX package's bounds for an
    int8 net against its float net (relative L2 < 0.12, class maps agree on
    > 85 %) and the margin rule; the calibration line is JAX's."""
    argv = [*static["args"], "--quant", "int8", "--dtype", "bfloat16",
            "--calib_batches", "2"]
    jax_out = run_jax_cli("eval", argv, monkeypatch)
    port_out = run_port_cli(port_eval, argv)
    assert lines_with(port_out, "Calibrated int8") == lines_with(
        jax_out, "Calibrated int8")
    assert lines_with(port_out, "Calibrated int8")
    j, p = run_mious(jax_out), run_mious(port_out)
    maps = int8_class_maps(argv, static["variables"], static=True)
    agree = (maps["port"] == maps["jax"]).mean()
    print(f"static int8-bf16 eval mIoU: JAX {j}, port {p}; H/4 logits "
          f"relative L2 {maps['rel_l2']:.3g}, class maps agree on "
          f"{agree * 100:.2f} %, equal on the {maps['sure'].mean() * 100:.2f}"
          f" % of pixels with margin > 2x{maps['err']:.3g}")
    assert len(j) == len(p) == 1
    assert maps["rel_l2"] < 0.12 and agree > 0.85
    np.testing.assert_array_equal(maps["port"][maps["sure"]],
                                  maps["jax"][maps["sure"]])


def test_capacity_factor_needs_hard(layout):
    argv = [a for a in layout["args"] if a != "--hard"]
    with pytest.raises(SystemExit):
        port_eval.main([*argv, "--ckpt_path", layout["ckpt"], "--device",
                        "cpu", "--capacity_factor", "1.25"])
