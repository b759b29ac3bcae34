"""The port's B=1 ``switch`` artifacts and a modality router's artifact
on the CPU (``_port_export_setup``; the B=4 forms and the ops are in
``test_torch_port_export.py``).

* ``switch`` on the live gate: one artifact whose per-stage ``torch.cond``s
  take sample 0's path (the JAX package's per-stage ``lax.cond``s),
  replayed for each sample of the recipe batch: equal to eager with error
  0, and to the JAX package's replay of its hard dense forward on the
  batch, that sample's row (the unmixed fusion of a hard path is the
  dense forward's mix at a one-hot weight): gate weights identical, logits
  within 1e-4 of max |JAX logits|;
* ``switch`` with each forced path, a Python int: a static graph, no cond
  (JAX's ``static_k``), equal to eager with error 0; path 0 fuses no stage.
  Path 0 goes through the file; paths 1-4 replay the same program in
  memory (``in_memory``: the save and load of ~68 MB took most of each
  case);
* the MM-IMDB router's dense forward, (text, image): equal to eager within
  1e-6, as the JAX package's ``test_export_modality_router``;
* ``cli.predict --quant int8 --export_path``: the reloaded artifact writes
  PNGs byte-equal to the CLI's own, the JAX package's
  ``test_int8_export_cli_byte_equal``.
"""

import os

import numpy as np
import pytest
import torch

from _port_eval_setup import lines_with, run_port_cli
from _port_export_setup import (B, SITES, check_replay, close_to_jax, conds,
                                in_memory, jax_refs, make_nets, roundtrip)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu_torch.cli import predict as predict_cli
from dynmm_tpu_torch.serve import ServingForward


@pytest.fixture(scope="module")
def nets():
    nets = make_nets(int8=False)
    nets["jax"] = jax_refs(nets, forms=("dense",))["dense"]
    return nets


def test_switch_artifact_live_gate(nets, tmp_path):
    module = ServingForward(nets["fp32"], "switch")
    rgb, depth = (torch.from_numpy(a) for a in nets["inputs"])
    fn = roundtrip(tmp_path, module, rgb[:1], depth[:1])
    assert conds(fn.program) == 4
    paths = []
    ref_out, ref_w = nets["jax"]
    for i in range(B):
        got = check_replay(fn, module, (rgb[i:i + 1], depth[i:i + 1]), SITES)
        paths.append(int(got[1].argmax()))
        close_to_jax(got, (ref_out[i:i + 1], ref_w[i:i + 1]))
    assert len(set(paths)) > 1


@pytest.mark.parametrize("path", range(5))
def test_switch_artifact_forced_path(nets, tmp_path, path):
    module = ServingForward(nets["fp32"], "switch", force_path=path)
    inputs = tuple(torch.from_numpy(a[:1]) for a in nets["inputs"])
    fn = (roundtrip(tmp_path, module, *inputs) if path == 0
          else in_memory(module, *inputs))
    check_replay(fn, module, inputs,
                 SITES if path else SITES - {"se_fuse_mixed"})
    assert conds(fn.program) == 0


def test_imdb_router_artifact(tmp_path):
    from _port_modality_setup import inputs as modality_inputs
    from _port_modality_setup import jax_variables, port_router

    class Dense(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.router = port_router("imdb", jax_variables("imdb")).eval()

        def forward(self, text, image):
            return self.router([text, image], hard=True)[0]

    module = Dense()
    text, image = (torch.from_numpy(np.asarray(a))
                   for a in modality_inputs("imdb")[0])
    fn = roundtrip(tmp_path, module, text, image)
    with torch.no_grad():
        want = module(text, image)
    torch.testing.assert_close(fn(text, image), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ --export_path (torch.export)
TINY = ["--dataset", "synthetic", "--height", "64", "--width", "64",
        "--encoder", "resnet18", "--encoder_block", "BasicBlock",
        "--decoder_channels_mode", "constant", "--channels_decoder", "32",
        "--nr_decoder_blocks", "1", "--context_module", "None",
        "--upsampling", "bilinear", "--batch_size", "2", "--synthetic_n",
        "4"]


def test_int8_export_cli_byte_equal(tmp_path):
    """The twin of the JAX package's ``test_int8_export_cli_byte_equal``:
    ``cli.train`` a tiny net; ``cli.predict --quant int8 --serve_mode
    dense``; the same chain with ``--export_path``; the artifact, reloaded
    with ``load_serving_fn`` (no model code), over the same feed writes
    PNGs (``data/png.py``) byte-equal to the CLI's."""
    from dynmm_tpu_torch.cli import train as port_train
    from dynmm_tpu_torch.cli.seg_build import make_dataset
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import class_colors
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor)
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.utils.serve_export import load_serving_fn

    run_port_cli(port_train, [*TINY, "--dynamic", "--global-gate",
                              "--epochs", "1", "--eval-every", "1",
                              "--results_dir", str(tmp_path)])
    (ckpt,) = tmp_path.glob("synthetic/*/ckpt_latest.msgpack")
    argv = [*TINY, "--ckpt_path", str(ckpt), "--quant", "int8",
            "--calib_batches", "1", "--serve_mode", "dense"]
    out = run_port_cli(predict_cli, [*argv, "--num", "2", "--out_dir",
                                      str(tmp_path / "preds")])
    assert "Calibrated int8 scales" in out
    names = sorted(os.listdir(tmp_path / "preds"))
    assert len(names) == 2
    art = tmp_path / "int8_dense.pt2"
    out = run_port_cli(predict_cli, [*argv, "--export_path", str(art)])
    assert lines_with(out, "exported serving artifact") == [
        f"exported serving artifact ({art.stat().st_size} bytes, mode=dense, "
        f"rgb=(2, 64, 64, 3)) to {art}"]

    args = predict_cli.build_parser().parse_args(argv)
    ds = make_dataset(args, "test")
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, 64, 64, phase="test")
    batch = next(iter(SegLoader(ds, pre, batch_size=2)))
    logits, _ = load_serving_fn(str(art))(torch.from_numpy(batch["image"]),
                                          torch.from_numpy(batch["depth"]))
    colors = class_colors(ds.n_classes_without_void + 1)
    (tmp_path / "preds_art").mkdir()
    for i, img in enumerate(first_argmax(logits).numpy()):
        png.write(str(tmp_path / "preds_art" / f"pred_{i:05d}.png"),
                  colors[img + 1])
    for name in names:
        assert ((tmp_path / "preds" / name).read_bytes()
                == (tmp_path / "preds_art" / name).read_bytes()), name
