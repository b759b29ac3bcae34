"""Shared flag system for segmentation train/eval (a copy of
``dynmm_tpu/cli/seg_args.py``, which the port does not import) — mirrors
``FusionDynMM/src/args.py:9-197`` (ArgumentParserRGBDSegmentation) flag for
flag, so reference command lines work unchanged. Flags of features the port
does not have yet are kept, so those command lines parse; the port's CLIs
raise on them (``cli/seg_build.py::check_supported``)."""

from __future__ import annotations

import argparse


class ArgumentParserRGBDSegmentation(argparse.ArgumentParser):
    def set_common_args(self):
        # paths
        self.add_argument("--results_dir", default="./results")
        self.add_argument("--last_ckpt", default="", type=str, metavar="PATH",
                          help="path to latest checkpoint")
        self.add_argument("--pretrained_dir", default="./trained_models/imagenet")
        # pretraining
        self.add_argument("--pretrained_scenenet", default="")
        self.add_argument("--no_imagenet_pretraining",
                          dest="pretrained_on_imagenet", default=True,
                          action="store_false")
        self.add_argument("--finetune", default=None, type=str,
                          help="path to weights to finetune on (msgpack or .pth)")
        # input dims
        self.add_argument("--batch_size", type=int, default=8)
        self.add_argument("--batch_size_valid", type=int, default=None)
        self.add_argument("--height", type=int, default=480)
        self.add_argument("--width", type=int, default=640)
        # epochs
        self.add_argument("--epochs", default=500, type=int, metavar="N")
        # training hyper parameters
        self.add_argument("--lr", "--learning-rate", default=0.01, type=float)
        self.add_argument("--weight_decay", "--wd", default=1e-4, type=float)
        self.add_argument("--momentum", default=0.9, type=float, metavar="M")
        self.add_argument("--optimizer", type=str, default="SGD",
                          choices=["SGD", "Adam"])
        self.add_argument("--class_weighting", type=str,
                          default="median_frequency",
                          choices=["median_frequency", "logarithmic", "None"])
        self.add_argument("--c_for_logarithmic_weighting", type=float, default=1.02)
        self.add_argument("--he_init", dest="he_init", default=False,
                          action="store_true")
        self.add_argument("--valid_full_res", default=False, action="store_true")
        # model / DynMM
        self.add_argument("--dynamic", action="store_true", help="dynamic NN")
        self.add_argument("--global-gate", action="store_true",
                          help="dynamic NN with global gates")
        self.add_argument("--block-rule", type=str, default="1111",
                          help="branch choice per block, 0: rgb, 1: rgb+d, 2: soft weight")
        self.add_argument("--temp", type=float, default=1.0)
        self.add_argument("--end-temp", type=float, default=0.001)
        self.add_argument("--loss-ratio", type=float, default=0.0)
        self.add_argument("--flop-budget", type=float, default=0.0)
        self.add_argument("--epoch-ini", type=int, default=0)
        self.add_argument("--epoch-hard", type=int, default=500)
        self.add_argument("--eval-every", type=int, default=2)
        self.add_argument("--save-every", type=int, default=100)
        self.add_argument("--baseline", action="store_true")
        self.add_argument("--freeze", action="store_true",
                          help="freeze everything but the soft gates")
        self.add_argument("--soft-eval", action="store_true")
        self.add_argument("--packed_stem", "--packed-stem",
                          action="store_true",
                          help="feed the stems host-side space-to-depth "
                               "packed inputs (TPU serving fast path; "
                               "bit-equal outputs — resnet.space_to_depth_"
                               "host)")
        self.add_argument("--activation", type=str, default="relu",
                          choices=["relu", "swish", "hswish"])
        self.add_argument("--encoder", type=str, default="resnet34",
                          choices=["resnet18", "resnet34", "resnet50"])
        self.add_argument("--encoder_block", type=str, default="NonBottleneck1D",
                          choices=["BasicBlock", "NonBottleneck1D"])
        self.add_argument("--nr_decoder_blocks", type=int, default=[3], nargs="+")
        self.add_argument("--encoder_depth", type=str, default=None,
                          choices=["resnet18", "resnet34", "resnet50", "None"])
        self.add_argument("--modality", type=str, default="rgbd",
                          choices=["rgbd", "rgb", "depth"])
        self.add_argument("--encoder_decoder_fusion", type=str, default="add",
                          choices=["add", "None"])
        self.add_argument("--context_module", type=str, default="ppm",
                          choices=["ppm", "None", "ppm-1-2-4-8", "appm",
                                   "appm-1-2-4-8"])
        self.add_argument("--channels_decoder", type=int, default=128)
        self.add_argument("--decoder_channels_mode", default="decreasing",
                          choices=["constant", "decreasing"])
        self.add_argument("--fuse_depth_in_rgb_encoder", default="SE-add",
                          choices=["SE-add", "add", "None"])
        self.add_argument("--upsampling", default="learned-3x3-zeropad",
                          choices=["nearest", "bilinear", "learned-3x3",
                                   "learned-3x3-zeropad"])
        # dataset
        self.add_argument("--dataset", default="nyuv2",
                          choices=["sunrgbd", "nyuv2", "cityscapes",
                                   "cityscapes-with-depth", "scenenetrgbd",
                                   "synthetic"])
        self.add_argument("--dataset_dir", default="./datasets/nyuv2")
        self.add_argument("--synthetic_n", default=16, type=int,
                          help="train-split size of --dataset synthetic "
                               "(test split uses half)")
        self.add_argument("--synthetic_mixed_frac", default=0.0, type=float,
                          help="fraction of synthetic samples that need the "
                               "depth modality (input-dependent routing; "
                               "see SyntheticSegDataset)")
        self.add_argument("--raw_depth", action="store_true", default=False)
        self.add_argument("--aug_scale_min", default=1.0, type=float)
        self.add_argument("--aug_scale_max", default=1.4, type=float)
        # TPU execution options (no reference equivalent)
        self.add_argument("--dtype", default="float32",
                          choices=["float32", "bfloat16"],
                          help="compute dtype (params stay float32)")
        self.add_argument("--quant", default="none",
                          choices=["none", "int8"],
                          help="int8 post-training quantization for serving "
                               "(eval/predict; abs-max calibration on the "
                               "first --calib_batches clean batches)")
        self.add_argument("--calib_estimator", "--calib-estimator",
                          default="absmax",
                          choices=["absmax", "percentile"],
                          help="activation-scale estimator for --quant "
                               "int8: 'absmax' (running max) or "
                               "'percentile' (clip rare outliers at "
                               "--calib_percentile; finer resolution on "
                               "the bulk of the distribution)")
        self.add_argument("--calib_percentile", "--calib-percentile",
                          type=float, default=99.9,
                          help="percentile for --calib_estimator "
                               "percentile; one of 99.0/99.9/99.99 "
                               "(the grid recorded during calibration)")
        self.add_argument("--calib_batches", "--calib-batches", type=int,
                          default=8,
                          help="calibration batches for --quant int8")
        self.add_argument("--grad-accum", type=int, default=1,
                          help="accumulate gradients over N batches per step")
        self.add_argument("--mesh-data", type=int, default=0,
                          help="data-parallel mesh size (0 = all devices)")
        self.add_argument("--mesh-model", type=int, default=1,
                          help="model-parallel mesh size")
        # others
        self.add_argument("-j", "--workers", default=8, type=int, metavar="N")
        self.add_argument("--debug", default=False, action="store_true",
                          help="Only one batch in training and validation.")


def decoder_channels(args) -> tuple[int, ...]:
    """build_model.py:27-34: 'decreasing' → [512, 256, 128]."""
    if "decreasing" in args.decoder_channels_mode:
        return (512, 256, 128)
    return (args.channels_decoder,) * 3


def nr_decoder_blocks(args) -> tuple[int, ...]:
    n = args.nr_decoder_blocks
    if isinstance(n, int):
        return (n,) * 3
    if len(n) == 1:
        return tuple(n) * 3
    assert len(n) == 3
    return tuple(n)
