"""``python -m dynmm_tpu_torch.cli.predict`` against the JAX package's
``predict.py`` on the CPU, from one JAX msgpack checkpoint of the small
NBt1D model (the recipe gate merged: the samples take paths 0, 2 and 3) and
one prepared NYUv2 layout written with cv2 (6 test samples, B=4 and a
ragged tail of 2): every serve mode, compact with a capacity factor,
quarter resolution and the packed stem. The maps each CLI writes
(``pred_00000.png`` …, read back with cv2) are identical on ≥ 99.9 % of
pixels, with the same files, and the path distribution and expected-GFLOPs
lines are equal. Also a ``.pth`` with an extra and a missing key, and the
swish net (bf16 and int8) against the JAX CLI's. ``--dtype bfloat16`` against the JAX CLI
at bf16: the maps are held equal on the pixels whose top-two logit margin
exceeds the measured logit error (``bf16_class_maps``)."""

import os

import cv2
import numpy as np
import pytest
import torch

from _port_eval_setup import (MODEL_FLAGS, bf16_class_maps,
                              int8_class_maps, lines_with, random_variables,
                              run_jax_cli, run_port_cli, save_jax_checkpoint,
                              write_prepared)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.utils.torch_export import export_state_dict
from dynmm_tpu_torch.cli import predict as port_predict


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = write_prepared(tmp_path_factory.mktemp("nyuv2"), 6)
    variables = random_variables(seed=0)
    ckpt = save_jax_checkpoint(root / "ckpt.msgpack", variables)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_state_dict(variables["params"],
                            variables["batch_stats"]).items()}
    sd.pop("gate_layer.conv.1.running_var")  # both packages init it to 1
    sd["bogus_extra"] = torch.ones(2)
    torch.save(sd, root / "odd.pth")
    return {"root": root, "ckpt": ckpt, "variables": variables,
            "args": ["--dataset", "nyuv2", "--dataset_dir", str(root),
                     *MODEL_FLAGS]}


def _maps(out_dir):
    names = sorted(os.listdir(out_dir))
    return names, [cv2.imread(os.path.join(out_dir, n), cv2.IMREAD_UNCHANGED)
                   for n in names]


def _compare(layout, tmp_path, monkeypatch, extra, ckpt=None):
    argv = [*layout["args"], "--ckpt_path", ckpt or layout["ckpt"], *extra]
    jax_out = run_jax_cli("predict", [*argv, "--out_dir",
                                      str(tmp_path / "jax")], monkeypatch)
    port_out = run_port_cli(port_predict, [*argv, "--out_dir",
                                           str(tmp_path / "port")])
    for prefix in ("wrote", "path distribution", "expected total GFLOPs"):
        got = [ln.replace(str(tmp_path / "port"), "DIR")
               for ln in lines_with(port_out, prefix)]
        want = [ln.replace(str(tmp_path / "jax"), "DIR")
                for ln in lines_with(jax_out, prefix)]
        assert got == want and got, prefix
    assert lines_with(port_out, "model throughput")
    j_names, j_maps = _maps(tmp_path / "jax")
    p_names, p_maps = _maps(tmp_path / "port")
    assert p_names == j_names and p_names[0] == "pred_00000.png"
    for p, j in zip(p_maps, j_maps):
        assert p.shape == j.shape and p.dtype == j.dtype == np.uint8
        assert (p == j).all(axis=-1).mean() >= 0.999
    return port_out


MODES = {
    "batchmax": ["--serve_mode", "batchmax"],
    "dense": ["--serve_mode", "dense"],
    "compact": ["--serve_mode", "compact"],
    "compact_cf": ["--serve_mode", "compact", "--capacity_factor", "1.25"],
    "switch": ["--serve_mode", "switch", "--batch_size", "1", "--num", "3"],
    "switch_host": ["--serve_mode", "switch_host", "--batch_size", "1",
                    "--num", "3"],
    "quarter": ["--output_res", "quarter"],
    "packed": ["--packed_stem"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_matches_jax(layout, tmp_path, monkeypatch, mode):
    out = _compare(layout, tmp_path, monkeypatch, MODES[mode])
    dist = lines_with(out, "path distribution")[0]
    assert dist.count("0.") >= 2 or "0.333" in dist  # a mix of paths
    if mode == "compact_cf":
        assert lines_with(out, "capacity-factor serving")


def test_predict_pth_with_odd_keys_matches_jax(layout, tmp_path, monkeypatch):
    out = _compare(layout, tmp_path, monkeypatch, [],
                   ckpt=str(layout["root"] / "odd.pth"))
    assert lines_with(out, "unconsumed") == ["unconsumed: bogus_extra"]


def test_predict_bf16_matches_jax(layout, tmp_path, monkeypatch):
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], "--dtype",
            "bfloat16"]
    jax_out = run_jax_cli("predict", [*argv, "--out_dir",
                                      str(tmp_path / "jax")], monkeypatch)
    port_out = run_port_cli(port_predict, [*argv, "--out_dir",
                                           str(tmp_path / "port")])
    for prefix in ("path distribution", "expected total GFLOPs"):
        assert lines_with(port_out, prefix) == lines_with(jax_out, prefix)
    maps = bf16_class_maps(argv, layout["variables"], label_size=False)
    j_names, j_maps = _maps(tmp_path / "jax")
    p_names, p_maps = _maps(tmp_path / "port")
    assert p_names == j_names and len(p_names) == len(maps["sure"]) == 6
    same = np.stack([(p == j).all(axis=-1) for p, j in zip(p_maps, j_maps)])
    print(f"bf16 predict: maps equal on {same.mean() * 100:.2f} % of pixels; "
          f"{maps['sure'].mean() * 100:.2f} % have margin > "
          f"2x{maps['err']:.3g}")
    assert maps["sure"].mean() > 0.5
    assert same[maps["sure"]].all()


def test_predict_int8_matches_jax(layout, tmp_path, monkeypatch):
    """``--quant int8 --output_res quarter``: the calibration, path and
    GFLOPs lines as the JAX CLI's, and its maps equal to the JAX CLI's on
    every pixel whose JAX top-two margin at H/4 exceeds twice the max logit
    error of the two int8 nets (``int8_class_maps``: rounding flips at
    quantization boundaries cascade, so the int8 nets differ by about the
    int8 error itself)."""
    _predict_int8(layout, tmp_path, monkeypatch, [])


def test_predict_int8_bf16_packed_matches_jax(layout, tmp_path, monkeypatch):
    """The same at ``--dtype bfloat16 --packed_stem``, the JAX bench's int8
    serving chain (bf16 compute, packed stem, quarter-res class map)."""
    _predict_int8(layout, tmp_path, monkeypatch,
                  ["--dtype", "bfloat16", "--packed_stem"])


def _predict_int8(layout, tmp_path, monkeypatch, extra):
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], "--quant",
            "int8", "--output_res", "quarter", "--calib_batches", "2", *extra]
    jax_out = run_jax_cli("predict", [*argv, "--out_dir",
                                      str(tmp_path / "jax")], monkeypatch)
    port_out = run_port_cli(port_predict, [*argv, "--out_dir",
                                           str(tmp_path / "port")])
    for prefix in ("Calibrated int8", "path distribution",
                   "expected total GFLOPs"):
        assert lines_with(port_out, prefix) == lines_with(jax_out, prefix)
        assert lines_with(port_out, prefix)
    maps = int8_class_maps(argv, layout["variables"])
    j_names, j_maps = _maps(tmp_path / "jax")
    p_names, p_maps = _maps(tmp_path / "port")
    assert p_names == j_names and len(p_names) == len(maps["sure"]) == 6
    same = np.stack([(p == j).all(axis=-1) for p, j in zip(p_maps, j_maps)])
    print(f"int8 predict {extra}: maps equal on {same.mean() * 100:.2f} % of "
          f"pixels; "
          f"{maps['sure'].mean() * 100:.2f} % have margin > "
          f"2x{maps['err']:.3g}")
    assert maps["sure"].mean() > 0.2
    assert same[maps["sure"]].all()


@pytest.mark.parametrize("net", ["int8", "bf16"])
def test_predict_swish_matches_jax(layout, tmp_path, monkeypatch, net):
    """The swish global-gate net of the relu checkpoint (an activation has
    no weights) served by both CLIs: ``int8`` with ``--quant int8
    --output_res quarter`` on ``_predict_int8``'s rules, ``bf16`` with
    ``--dtype bfloat16`` on ``test_predict_bf16_matches_jax``'s, whose
    sure pixels are asked to cover 40 % of the maps where the relu net's
    cover 50 %: a swish net drifts further in bf16 (JAX's own bf16 swish
    gate net is 4.0 % of max |logits| from its fp32 net, printed by
    ``test_torch_port_activation_lowp.py::test_net_bf16_matches_jax``),
    which narrows the share of pixels whose margin exceeds the error."""
    if net == "int8":
        _predict_int8(layout, tmp_path, monkeypatch, ["--activation", "swish"])
        return
    argv = [*layout["args"], "--ckpt_path", layout["ckpt"], "--dtype",
            "bfloat16", "--activation", "swish"]
    jax_out = run_jax_cli("predict", [*argv, "--out_dir",
                                      str(tmp_path / "jax")], monkeypatch)
    port_out = run_port_cli(port_predict, [*argv, "--out_dir",
                                           str(tmp_path / "port")])
    for prefix in ("path distribution", "expected total GFLOPs"):
        assert lines_with(port_out, prefix) == lines_with(jax_out, prefix)
    maps = bf16_class_maps(argv, layout["variables"], label_size=False)
    j_names, j_maps = _maps(tmp_path / "jax")
    p_names, p_maps = _maps(tmp_path / "port")
    assert p_names == j_names and len(p_names) == len(maps["sure"]) == 6
    same = np.stack([(p == j).all(axis=-1) for p, j in zip(p_maps, j_maps)])
    print(f"swish bf16 predict: maps equal on {same.mean() * 100:.2f} % of "
          f"pixels; {maps['sure'].mean() * 100:.2f} % have margin > "
          f"2x{maps['err']:.3g}")
    assert maps["sure"].mean() > 0.4
    assert same[maps["sure"]].all()


@pytest.mark.parametrize("flags, message", [
    (["--serve_mode", "switch"], "--serve_mode switch requires --batch_size 1"),
    (["--capacity_factor", "1.25"],
     "--capacity_factor applies to --serve_mode compact"),
    (["--serve_mode", "switch_host", "--batch_size", "1", "--export_path",
      "x.pt2"], "cannot be exported as one artifact"),
    (["--export_platforms", "tpu"], "--export_platforms takes cuda, cpu")],
    ids=["switch-batch", "capacity-mode", "export-switch-host",
         "export-platforms"])
def test_parser_errors_as_jax(layout, tmp_path, capsys, flags, message):
    with pytest.raises(SystemExit) as e:
        port_predict.main([*layout["args"], "--ckpt_path", layout["ckpt"],
                           "--device", "cpu", "--out_dir", str(tmp_path),
                           *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err

