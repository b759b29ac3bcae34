"""The port's prepared-dataset readers, palettes, eval noise and stem
packing against the JAX package: ``NYUv2Dataset`` (refined and raw depth),
``SUNRGBDDataset`` (with ``test_cameras.txt`` and ``filter_camera``),
``CityscapesDataset`` (raw-disparity PNG and refined ``.npy``) and
``SceneNetRGBDDataset`` return the JAX readers' arrays on layouts written
with cv2; ``class_colors`` / ``voc_colormap`` equal the JAX palettes;
``inject_eval_noise`` and ``pack_stem_batch`` equal the JAX functions on
one seed; ``make_dataset`` / ``compute_depth_stats`` agree."""

import argparse

import numpy as np
import pytest

import dynmm_tpu.cli.seg_build as jax_build
import dynmm_tpu.data.nyuv2 as jax_nyu
import dynmm_tpu.data.other_datasets as jax_other
import dynmm_tpu.data.seg_preprocessing as jax_pre
import dynmm_tpu_torch.cli.seg_build as port_build
import dynmm_tpu_torch.data.nyuv2 as port_nyu
import dynmm_tpu_torch.data.other_datasets as port_other
import dynmm_tpu_torch.data.seg_preprocessing as port_pre
from _port_eval_setup import write_prepared

CAMERAS = ["kv1", "xtion", "kv1", "realsense", "kv2"]


def _same_samples(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    assert port_ds.cameras == jax_ds.cameras
    assert port_ds.n_classes_without_void == jax_ds.n_classes_without_void
    assert (port_ds.depth_mean, port_ds.depth_std) == (jax_ds.depth_mean,
                                                       jax_ds.depth_std)
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("depth_mode", ["refined", "raw"])
def test_nyuv2_reader_equals_jax(tmp_path, depth_mode):
    root = write_prepared(tmp_path, 3, h=24, w=32, depth_dir=(
        "depth" if depth_mode == "refined" else "depth_raw"))
    for split in ("train", "test"):
        _same_samples(port_nyu.NYUv2Dataset(str(root), split, depth_mode),
                      jax_nyu.NYUv2Dataset(str(root), split, depth_mode))


def test_sunrgbd_cameras_equal_jax(tmp_path):
    root = write_prepared(tmp_path, 5, h=24, w=32, label_dir="labels_37",
                          n_classes=37, cameras=CAMERAS)
    port = port_other.SUNRGBDDataset(str(root), "test")
    ref = jax_other.SUNRGBDDataset(str(root), "test")
    _same_samples(port, ref)
    for cam in ref.cameras:
        with port.filter_camera(cam), ref.filter_camera(cam):
            assert port.ids == ref.ids == [
                i for i, c in zip(ref._all_ids, CAMERAS) if c == cam]
            if ref.ids:
                _same_samples(port, ref)
    assert port.ids == ref._all_ids  # restored


@pytest.mark.parametrize("depth_mode", ["raw", "refined"])
def test_cityscapes_equals_jax(tmp_path, depth_mode):
    root = write_prepared(tmp_path, 2, h=24, w=32, label_dir="labels_19",
                          n_classes=19, depth_dir="disparity_raw")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        (root / split / "depth_raw").mkdir()
        for name in (root / f"{split}.txt").read_text().split():
            np.save(root / split / "depth_raw" / f"{name}.npy",
                    rng.uniform(0, 80, (24, 32)).astype(np.float16))
    _same_samples(port_other.CityscapesDataset(str(root), "test", depth_mode),
                  jax_other.CityscapesDataset(str(root), "test", depth_mode))


def test_scenenet_equals_jax(tmp_path):
    root = write_prepared(tmp_path, 2, h=24, w=32, label_dir="labels_13",
                          n_classes=13)
    _same_samples(port_other.SceneNetRGBDDataset(str(root), "train"),
                  jax_other.SceneNetRGBDDataset(str(root), "train"))
    assert sorted(port_other.DATASETS) == sorted(jax_other.DATASETS)


@pytest.mark.parametrize("n", [14, 38, 41, 895])
def test_palettes_equal_jax(n):
    np.testing.assert_array_equal(port_nyu.class_colors(n),
                                  jax_nyu.class_colors(n))
    np.testing.assert_array_equal(port_nyu.voc_colormap(n),
                                  jax_nyu.voc_colormap(n))
    assert port_nyu.CLASS_NAMES_40 == jax_nyu.CLASS_NAMES_40


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_inject_eval_noise_equals_jax(mode):
    rng = np.random.default_rng(11)
    image = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    depth = rng.standard_normal((2, 8, 12, 1)).astype(np.float32)
    r_port, r_jax = np.random.default_rng(4), np.random.default_rng(4)
    noisy = 0
    for _ in range(12):  # several batches from one generator (a run)
        got = port_pre.inject_eval_noise(image, depth, mode, 0.5, r_port)
        want = jax_pre.inject_eval_noise(image, depth, mode, 0.5, r_jax)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        noisy += not (got[0] is image and got[1] is depth)
    assert 0 < noisy < 12
    assert r_port.random() == r_jax.random()


def test_pack_stem_batch_equals_jax():
    rng = np.random.default_rng(2)
    batch = {"image": rng.standard_normal((2, 8, 12, 3)).astype(np.float32),
             "depth": rng.standard_normal((2, 8, 12, 1)).astype(np.float32),
             "label": rng.integers(0, 5, (2, 8, 12))}
    got, want = port_pre.pack_stem_batch(batch), jax_pre.pack_stem_batch(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["image"].shape == (2, 4, 6, 12)
    # packed batches pass unchanged
    again = port_pre.pack_stem_batch(got)
    assert again["image"] is got["image"] and again["depth"] is got["depth"]


def _args(root, dataset, **kw):
    ns = dict(dataset=dataset, dataset_dir=str(root), raw_depth=False,
              height=24, width=32, synthetic_n=4, synthetic_mixed_frac=0.0,
              dynamic=True, global_gate=True, modality="rgbd", mesh_data=0,
              mesh_model=1, dtype="float32", quant="none", packed_stem=False,
              pretrained_scenenet="")
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("dataset", ["nyuv2", "sunrgbd", "synthetic"])
def test_make_dataset_and_depth_stats_equal_jax(tmp_path, dataset):
    label_dir = "labels_37" if dataset == "sunrgbd" else "labels_40"
    root = write_prepared(tmp_path, 2, h=24, w=32, label_dir=label_dir)
    args = _args(root, dataset)
    port = port_build.make_dataset(args, "train")
    ref = jax_build.make_dataset(args, "train")
    assert type(port).__name__ == type(ref).__name__
    _same_samples(port, ref)
    for mode in ("refined", "raw"):
        assert port_build.compute_depth_stats(port, mode) == pytest.approx(
            jax_build.compute_depth_stats(ref, mode), rel=1e-12)
