"""Shared set-up of the port's eval / predict CLI tests: prepared on-disk
layouts written with cv2 (as ``tests/test_datasets.py`` writes them), a JAX
msgpack checkpoint of the small NBt1D SkipGateESANet with seeded random
weights, and the two packages' CLIs run in this process (``sys.argv``
patched for the JAX scripts, whose printed lines are parsed)."""

import contextlib
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np

from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset
from dynmm_tpu_torch.utils.msgpack import msgpack_restore
from dynmm_tpu_torch.utils.weights import merge_subtree

REPO = Path(__file__).resolve().parents[1]
H, W, B = 64, 96, 4
# the files' own size: the valid loader resizes the inputs to H×W and
# scores at this size (a non-integer ratio to H/4 × W/4)
FILE_H, FILE_W = 72, 104
SMALL = dict(
    height=H, width=W, encoder_rgb="resnet18", encoder_depth="resnet18",
    encoder_block="NonBottleneck1D", channels_decoder=(32, 32, 32),
    nr_decoder_blocks=(1, 1, 1), fuse_depth_in_rgb_encoder="SE-add",
    context_module="ppm", upsampling="learned-3x3-zeropad")
MODEL_FLAGS = ["--height", str(H), "--width", str(W), "--encoder", "resnet18",
               "--channels_decoder", "32", "--decoder_channels_mode",
               "constant", "--nr_decoder_blocks", "1", "--batch_size", str(B)]


def write_prepared(root: Path, n: int, h: int = FILE_H, w: int = FILE_W,
                   label_dir: str = "labels_40", n_classes: int = 40,
                   cameras=None, depth_dir: str = "depth", seed: int = 3,
                   splits=("train", "test")) -> Path:
    """A prepared RGB-D layout of ``n`` synthetic samples a split, written
    with cv2 (rgb as BGR files, depth uint16, labels uint8 in 0..n_classes);
    ``cameras``: one camera name a sample (``{split}_cameras.txt``)."""
    ds = SyntheticSegDataset(n=n, height=h, width=w, seed=seed,
                             mixed_modality_frac=0.5)
    for split in splits:
        for kind in ("rgb", depth_dir, label_dir):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        ids = []
        for i in range(n):
            s, name = ds[i], f"{split}_{i:03d}"
            ids.append(name)
            cv2.imwrite(str(root / split / "rgb" / f"{name}.png"),
                        s["image"][:, :, ::-1])
            cv2.imwrite(str(root / split / depth_dir / f"{name}.png"),
                        s["depth"].astype(np.uint16))
            cv2.imwrite(str(root / split / label_dir / f"{name}.png"),
                        (s["label"] % (n_classes + 1)).astype(np.uint8))
        (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
        if cameras is not None:
            (root / f"{split}_cameras.txt").write_text(
                "\n".join(cameras[:n]) + "\n")
    return root


def jax_model(n_classes: int = 40) -> JaxSkipGate:
    return JaxSkipGate(JaxConfig(num_classes=n_classes, **SMALL))


@functools.lru_cache(maxsize=4)
def _shapes(n_classes: int):
    return jax.eval_shape(lambda: jax_model(n_classes).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), train=False))


def random_variables(n_classes: int = 40, seed: int = 0) -> dict:
    """{"params", "batch_stats"} of the small model, numpy float32: He-normal
    kernels, small random biases, BN affines and statistics away from
    identity; then the recipe gate asset (gate, stems, stem fusion) merged
    in, so the synthetic samples take a mix of paths (0, 2, 3)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            x = rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
        elif name in ("bias", "mean"):
            x = rng.standard_normal(s.shape) * 0.1
        elif name == "scale":
            x = rng.uniform(0.5, 1.0, s.shape)
        else:  # var
            x = rng.uniform(0.5, 1.5, s.shape)
        return x.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, _shapes(n_classes))
    asset = msgpack_restore(
        (REPO / "bench_assets" / "gate_recipe.msgpack").read_bytes())
    sub = asset["subtree"]
    return {"params": merge_subtree(tree["params"], sub["params"]),
            "batch_stats": merge_subtree(tree["batch_stats"],
                                         sub["batch_stats"])}


def save_jax_checkpoint(path: Path, variables: dict) -> str:
    return jax_ckpt.save_checkpoint(str(path), {
        "params": variables["params"],
        "model_state": {"batch_stats": variables["batch_stats"]}}, epoch=0)


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}_cli", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_cli(name: str, argv: list[str], monkeypatch) -> str:
    """The JAX package's ``eval.py`` / ``predict.py`` ``main()`` with
    ``sys.argv`` patched; returns what it printed."""
    monkeypatch.setenv("DYNMM_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load_script(name).main()
    return out.getvalue()


def run_port_cli(module, argv: list[str]) -> str:
    """The port's CLI ``main(argv)`` on the CPU; returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main([*argv, "--device", "cpu"])
    return out.getvalue()


def run_mious(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"^Run \d+, mIoU: ([\d.]+)$", text,
                                         re.M)]


def lines_with(text: str, prefix: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(prefix)]
