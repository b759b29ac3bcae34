"""Model factory and data preparation for the port's segmentation CLIs (the
torch subset of ``dynmm_tpu/cli/seg_build.py``; the reference's
``src/build_model.py`` and ``src/prepare_data.py``).

The port builds every model of the JAX factory: the global-gate
SkipGateESANet (``--dynamic --global-gate``), the local-gate SkipESANet
(``--dynamic``, ``--block_rule``), the static ESANet (rgbd) and
ESANetOneModality (``--modality rgb|depth``, SE under
``--fuse_depth_in_rgb_encoder SE-add``), on BasicBlock or NonBottleneck1D
resnet18/resnet34 or Bottleneck resnet50 encoders, SE-add or add fusion,
PPM, APPM or no context module, relu, swish or hswish (``--activation``;
the cells whose TPU kernels fuse relu run in PyTorch ops on a swish or
hswish net: ``models/esanet.py``), with the 2×2 packed stem under
``--packed_stem``, and reads every ``--dataset``: the prepared on-disk
layouts (``data/nyuv2.py``, ``data/other_datasets.py``) and ``synthetic``.
``check_supported`` raises ``NotImplementedError`` on every flag of a
feature the port does not have yet, naming its ROADMAP item; none is
silently ignored. ``--dtype bfloat16`` trains, serves and scores every
model in bf16 (fp32 parameters). ``--quant int8`` builds the global-gate
net or the static ESANet (each fp32 or bf16) with quantized convs for
cli.eval and cli.predict, which calibrate it; the local-gate net and the
one-modality net raise, and so does training.
"""

from __future__ import annotations

import numpy as np
import torch

from dynmm_tpu_torch.cli.seg_args import decoder_channels, nr_decoder_blocks
from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset, SyntheticSegDataset
from dynmm_tpu_torch.data.other_datasets import DATASETS
from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader, SegPreprocessor,
                                                    pack_stem_batch)
from dynmm_tpu_torch.models.esanet import ESANet, ESANetConfig
from dynmm_tpu_torch.models.one_modality import ESANetOneModality
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.models.skip_local import SkipESANet


def check_supported(args, training: bool = False) -> None:
    """Raise on flags of features not ported yet (``training``: for
    ``cli.train``)."""
    missing = []
    if args.mesh_data > 1 or args.mesh_model > 1:
        missing.append("--mesh-data/--mesh-model above 1 (mesh training, "
                       "ROADMAP A9)")
    if args.quant != "none" and training:
        missing.append(f"--quant {args.quant} in training (a serving-time "
                       "knob: cli.eval and cli.predict calibrate a trained "
                       "net; training stays float, ROADMAP A6)")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def build_config(args, n_classes: int) -> ESANetConfig:
    encoder_depth = args.encoder_depth
    if encoder_depth in (None, "None"):
        encoder_depth = args.encoder
    return ESANetConfig(
        height=args.height,
        width=args.width,
        num_classes=n_classes,
        encoder_rgb=args.encoder,
        encoder_depth=encoder_depth,
        encoder_block=args.encoder_block,
        channels_decoder=decoder_channels(args),
        nr_decoder_blocks=nr_decoder_blocks(args),
        activation=args.activation,
        encoder_decoder_fusion=args.encoder_decoder_fusion,
        context_module=args.context_module,
        fuse_depth_in_rgb_encoder=args.fuse_depth_in_rgb_encoder,
        upsampling=args.upsampling,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
        quant=None if args.quant == "none" else args.quant,
    )


def build_model(args, n_classes: int):
    """The model of the flags, with torch's default initialisation (as the
    reference's torch model): ``--dynamic --global-gate`` →
    SkipGateESANet; ``--dynamic`` → SkipESANet(block_rule); else ESANet
    (rgbd) or ESANetOneModality (rgb | depth)."""
    check_supported(args)
    cfg = build_config(args, n_classes)
    if args.dynamic:
        block_rule = tuple(int(s) for s in args.block_rule)
        assert len(block_rule) == 4
        if args.global_gate:
            return SkipGateESANet(cfg)
        if cfg.quant is not None:
            raise NotImplementedError(
                "--quant supports global-gate / static models only")
        return SkipESANet(cfg, block_rule=block_rule)
    if args.modality == "rgbd":
        return ESANet(cfg)
    return ESANetOneModality(
        cfg, input_channels=3 if args.modality == "rgb" else 1,
        weighting_in_encoder=args.fuse_depth_in_rgb_encoder)


def make_dataset(args, split: str):
    check_supported(args)
    depth_mode = "raw" if args.raw_depth else "refined"
    if args.dataset == "nyuv2":
        return NYUv2Dataset(args.dataset_dir, split=split,
                            depth_mode=depth_mode)
    if args.dataset == "synthetic":
        n_train = args.synthetic_n
        return SyntheticSegDataset(
            n=n_train if split == "train" else max(1, n_train // 2),
            height=args.height,
            width=args.width,
            split=split,
            mixed_modality_frac=args.synthetic_mixed_frac,
        )
    if args.dataset in DATASETS:
        return DATASETS[args.dataset](args.dataset_dir, split=split,
                                      depth_mode=depth_mode)
    raise NotImplementedError(f"Unknown dataset {args.dataset}")


def prepare_data(args):
    """(train_loader, valid_loader[, full-resolution valid_loader]): train
    shuffles and drops the ragged tail; valid keeps order with
    ``--batch_size_valid``. ``--packed_stem`` packs the train batches in the
    loader's prefetch thread (``pack_stem_batch``); validation packs in its
    loop, after eval.py's noise is injected on the raw layout."""
    train_ds = make_dataset(args, "train")
    valid_ds = make_dataset(args, "test")
    depth_mode = "raw" if args.raw_depth else "refined"
    mean, std = train_ds.depth_mean, train_ds.depth_std
    train_pre = SegPreprocessor(
        mean, std, args.height, args.width, phase="train",
        depth_mode=depth_mode,
        scale_range=(args.aug_scale_min, args.aug_scale_max))
    valid_pre = SegPreprocessor(mean, std, args.height, args.width,
                                phase="test", depth_mode=depth_mode)
    batch_valid = args.batch_size_valid or args.batch_size
    train_loader = SegLoader(
        train_ds, train_pre, batch_size=args.batch_size, shuffle=True,
        drop_last=True, post=pack_stem_batch if args.packed_stem else None)
    valid_loader = SegLoader(valid_ds, valid_pre, batch_size=batch_valid)
    if args.valid_full_res:
        full_pre = SegPreprocessor(mean, std, None, None, phase="test",
                                   depth_mode=depth_mode)
        return train_loader, valid_loader, SegLoader(
            make_dataset(args, "test"), full_pre, batch_size=batch_valid)
    return train_loader, valid_loader


def compute_depth_stats(dataset, depth_mode: str = "refined") -> dict:
    """Train-split depth mean/std (dataset_base.py:210-263): raw mode
    excludes invalid zero pixels from the statistics."""
    def valid_depths():
        for i in range(len(dataset)):
            depth = dataset[i]["depth"]
            yield depth[depth > 0] if depth_mode == "raw" else depth.reshape(-1)

    pixel_sum, pixel_nr = 0.0, 0
    for valid in valid_depths():
        pixel_sum += float(valid.sum())
        pixel_nr += valid.size
    mean = pixel_sum / max(pixel_nr, 1)
    sq_sum = sum(float(np.square(valid - mean).sum())
                 for valid in valid_depths())
    std = float(np.sqrt(sq_sum / max(pixel_nr, 1)))
    return {"mean": mean, "std": std}


def compute_class_weights(dataset, n_classes: int, mode: str, c: float = 1.02):
    """Class weights over a map-style dataset (a copy of the JAX package's;
    dataset_base.py:147-208):
    linear = pixel counts; median_frequency = median(freq)/freq with freq =
    pixels_of_class / pixels_of_images_containing_class; logarithmic =
    1/log(c + p)."""
    n_pixels = np.zeros(n_classes + 1)
    n_image_pixels_with_class = np.zeros(n_classes + 1)
    for i in range(len(dataset)):
        label = dataset[i]["label"] if isinstance(dataset[i], dict) else dataset.load_label(i)
        h, w = label.shape
        dist = np.bincount(label.flatten(), minlength=n_classes + 1)[: n_classes + 1]
        n_pixels += dist
        n_image_pixels_with_class += (dist > 0) * h * w
    n_pixels = n_pixels[1:]
    n_image_pixels_with_class = n_image_pixels_with_class[1:]
    if mode == "linear":
        return n_pixels
    if mode == "median_frequency":
        freq = n_pixels / np.maximum(n_image_pixels_with_class, 1)
        freq = np.where(freq > 0, freq, np.nan)
        w = np.nanmedian(freq) / freq
        return np.nan_to_num(w, nan=1.0)
    if mode == "logarithmic":
        p = n_pixels / n_pixels.sum()
        return 1.0 / np.log(c + p)
    if mode == "None":
        return np.ones(n_classes)
    raise ValueError(mode)
