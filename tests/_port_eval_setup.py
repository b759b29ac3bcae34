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

from dynmm_tpu.models.esanet import ESANet as JaxESANet
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


def jax_model(n_classes: int = 40, static: bool = False, **over):
    """The small JAX SkipGateESANet, or with ``static`` the static ESANet."""
    cls = JaxESANet if static else JaxSkipGate
    return cls(JaxConfig(num_classes=n_classes, **SMALL, **over))


@functools.lru_cache(maxsize=4)
def _shapes(n_classes: int, static: bool = False):
    return jax.eval_shape(lambda: jax_model(n_classes, static).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), train=False))


def random_variables(n_classes: int = 40, seed: int = 0,
                     static: bool = False) -> dict:
    """{"params", "batch_stats"} of the small model, numpy float32: He-normal
    kernels, small random biases, BN affines and statistics away from
    identity; then (the gate net only) the recipe gate asset (gate, stems,
    stem fusion) merged in, so the synthetic samples take a mix of paths
    (0, 2, 3)."""
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

    tree = jax.tree_util.tree_map_with_path(leaf, _shapes(n_classes, static))
    if static:
        return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
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


def _model_flags(static: bool) -> tuple[list[str], dict]:
    """(the flags that build the net, its forward kwargs): the hard
    global-gate net, or the static ESANet."""
    return ([], {}) if static else (["--dynamic", "--global-gate"],
                                    {"hard": True})


def bf16_class_maps(argv: list[str], variables: dict,
                    label_size: bool, static: bool = False) -> dict:
    """The class maps of the port's and the JAX package's bf16 nets
    (hard gate, or with ``static`` the static ESANet) on the test batches
    that the CLIs of ``argv`` read: at the labels' size through eval's chain
    (bilinear resize of the logits, then the first argmax) with
    ``label_size``, else at the model's size (predict's maps). ``sure``
    marks the pixels whose JAX top-two logit margin exceeds twice ``err``,
    the max abs difference of the two nets' logits there: no such
    difference can change their class; ``scale`` is max |JAX logits|."""
    import torch

    from dynmm_tpu.nn import layers as jl
    from dynmm_tpu_torch.cli import eval as port_eval
    from dynmm_tpu_torch.cli.seg_build import build_model, prepare_data
    from dynmm_tpu_torch.nn import layers
    from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint

    flags, kw = _model_flags(static)
    args = port_eval.build_parser().parse_args(
        [*argv, *flags, "--device", "cpu"])
    loader = prepare_data(args)[1]
    model = build_model(args, 40)
    load_any_checkpoint(model, args.ckpt_path)
    model = model.to(memory_format=torch.channels_last).eval()
    jm = jax_model(static=static, dtype=jnp.bfloat16,
                   activation=args.activation)
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, **kw))
    port, ref = [], []
    for b in loader:
        with torch.no_grad():
            lp = model(torch.from_numpy(b["image"]),
                       torch.from_numpy(b["depth"]), **kw)
        lj = apply(variables, b["image"], b["depth"])
        if label_size:
            hw = b.get("label_orig", b.get("label")).shape[1:3]
            lp, lj = layers.resize_bilinear(lp, hw), jl.resize_bilinear(lj, hw)
        port.append(lp.float().numpy())
        ref.append(np.asarray(lj.astype(jnp.float32)))
    port, ref = np.concatenate(port), np.concatenate(ref)
    err = float(np.abs(port - ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    return {"port": port.argmax(-1), "jax": ref.argmax(-1), "err": err,
            "scale": float(np.abs(ref).max()),
            "sure": top2[..., 1] - top2[..., 0] > 2 * err}


def int8_class_maps(argv: list[str], variables: dict,
                    static: bool = False) -> dict:
    """predict's quarter-resolution class maps (the H/4 argmax repeated ×4)
    of the port's and the JAX package's int8 nets (hard gate, dense, or
    with ``static`` the static ESANet; at ``--dtype``, on the
    ``--packed_stem`` feed where ``argv`` asks) on the test batches that the
    CLIs of ``argv`` read, each net calibrated as its predict CLI calibrates
    it (absmax over the first ``--calib_batches`` batches of that feed in
    fp32, then packed). ``sure`` as in ``bf16_class_maps``, from the H/4
    logits; ``rel_l2`` the relative L2 distance of the two nets' H/4
    logits."""

    import torch

    from dynmm_tpu.utils import quantize as jax_quantize
    from dynmm_tpu_torch.cli import eval as port_eval
    from dynmm_tpu_torch.cli.seg_build import build_model, prepare_data
    from dynmm_tpu_torch.data.seg_preprocessing import pack_stem_batch
    from dynmm_tpu_torch.utils import quantize
    from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint

    flags, kw = _model_flags(static)
    args = port_eval.build_parser().parse_args(
        [*argv, *flags, "--device", "cpu"])
    pack = pack_stem_batch if args.packed_stem else dict
    feed = [(b["image"], b["depth"]) for b in map(pack, prepare_data(args)[1])]
    calib = feed[:args.calib_batches]
    model = build_model(args, 40)
    load_any_checkpoint(model, args.ckpt_path)
    model = model.to(memory_format=torch.channels_last).eval()
    quantize.quantize_int8(model, [tuple(map(torch.from_numpy, b))
                                   for b in calib], **kw)
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else None
    qcoll = jax_quantize.calibrate(
        jax_model(static=static, quant="calib",
                  activation=args.activation), variables,
        [tuple(map(jnp.asarray, b)) for b in calib], train=False, **kw)
    packed = jax_quantize.pack_weights({**variables, "quant": qcoll})
    jm = jax_model(static=static, quant="int8", dtype=dtype,
                   activation=args.activation)
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False,
                                             low_res=True, **kw))
    port, ref = [], []
    for r, d in feed:
        with torch.no_grad():
            port.append(model(torch.from_numpy(r), torch.from_numpy(d),
                              low_res=True, **kw).float().numpy())
        ref.append(np.asarray(apply(packed, r, d).astype(jnp.float32)))
    port, ref = np.concatenate(port), np.concatenate(ref)
    err = float(np.abs(port - ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    up = lambda m: m.repeat(4, axis=1).repeat(4, axis=2)
    return {"port": up(port.argmax(-1)), "jax": up(ref.argmax(-1)),
            "err": err, "sure": up(top2[..., 1] - top2[..., 0] > 2 * err),
            "rel_l2": float(np.linalg.norm(port - ref) / np.linalg.norm(ref))}
