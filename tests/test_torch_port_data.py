"""The port's data pipeline and metrics against the JAX package's.

``SyntheticSegDataset``, ``SegPreprocessor`` (both phases), ``SegLoader``
and ``make_recipe_eval_batch`` must give identical arrays from the same
seeds (the port resizes through its copy of the native library, and
uint8 labels by cv2's nearest rule, which the JAX package takes through
cv2 for them).
``ConfusionMatrix``, ``confusion_update_counts`` and
``compute_class_weights`` must give identical numbers. Tolerance: exact,
except the class weights (float64 arithmetic in the same order: exact too)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from dynmm_tpu.cli import seg_build as jax_build
from dynmm_tpu.data import nyuv2 as jax_nyuv2
from dynmm_tpu.data import seg_preprocessing as jax_pre
from dynmm_tpu.train import metrics as jax_metrics
from dynmm_tpu_torch.cli.seg_build import compute_class_weights
from dynmm_tpu_torch.data import nyuv2
from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
from dynmm_tpu_torch.train.metrics import ConfusionMatrix, confusion_update_counts

H, W = 64, 96


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


def _datasets(split="train", frac=0.5, seed=0):
    kw = dict(n=6, height=H, width=W, seed=seed, split=split,
              mixed_modality_frac=frac)
    return nyuv2.SyntheticSegDataset(**kw), jax_nyuv2.SyntheticSegDataset(**kw)


def test_constants_match():
    assert nyuv2.DEPTH_MEAN == jax_nyuv2.DEPTH_MEAN
    assert nyuv2.DEPTH_STD == jax_nyuv2.DEPTH_STD
    assert nyuv2.N_CLASSES == jax_nyuv2.N_CLASSES
    assert nyuv2.CAMERAS == jax_nyuv2.CAMERAS


@pytest.mark.parametrize("frac", [0.0, 0.5])
def test_synthetic_dataset_identical(frac):
    ours, ref = _datasets(frac=frac)
    assert len(ours) == len(ref)
    for i in range(len(ours)):
        _assert_tree_equal(ours[i], ref[i])
        assert ours.depth_needed(i) == ref.depth_needed(i)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_preprocessor_identical(phase):
    ours, ref = _datasets()
    p_ours = SegPreprocessor(ours.depth_mean, ours.depth_std, H, W, phase=phase)
    p_ref = jax_pre.SegPreprocessor(ref.depth_mean, ref.depth_std, H, W,
                                    phase=phase)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(len(ours)):
        _assert_tree_equal(p_ours(ours[i], r1), p_ref(ref[i], r2))
    # the same number of draws: the generators stay in step
    assert r1.random() == r2.random()


@pytest.mark.parametrize("phase", ["train", "test"])
def test_loader_batches_identical(phase):
    ours, ref = _datasets(split=phase)
    kw = dict(batch_size=2, shuffle=phase == "train",
              drop_last=phase == "train", seed=3)
    l_ours = SegLoader(ours, SegPreprocessor(ours.depth_mean, ours.depth_std,
                                             H, W, phase=phase), **kw)
    l_ref = jax_pre.SegLoader(ref, jax_pre.SegPreprocessor(
        ref.depth_mean, ref.depth_std, H, W, phase=phase), **kw)
    assert len(l_ours) == len(l_ref) == 3
    for _ in range(2):  # two epochs: the shuffle stream continues alike
        batches = list(zip(l_ours, l_ref))
        assert len(batches) == 3
        for a, b in batches:
            _assert_tree_equal(a, b)


def test_uint8_label_resize_matches_jax():
    """uint8 labels at ratios where cv2's nearest rule and the native one
    pick other rows (164 → 20: ``15 · 8.2`` rounds below 123 in double)."""
    from dynmm_tpu_torch.data.seg_preprocessing import _resize

    rng = np.random.default_rng(7)
    for h, w in ((164, 139), (116, 81), (46, 194), (480, 640)):
        label = rng.integers(0, 41, (h, w)).astype(np.uint8)
        for r in (8, 16, 32):
            ours = _resize(label, w // r, h // r, True)
            ref = jax_pre._resize(label, w // r, h // r, True)
            assert ours.dtype == ref.dtype == np.uint8
            np.testing.assert_array_equal(ours, ref)


def test_draw_sample_moves_the_stream_as_an_abandoned_pass():
    """``draw_sample`` leaves the loader where ``next(iter(loader))`` of
    the JAX loader leaves it once its prefetch thread has stopped (the
    sample batch ``train.py`` draws for its init): the same sample, then
    the same batches in the next pass. Six batches, so the thread stops on
    its full queue before the pass ends."""
    ours = nyuv2.SyntheticSegDataset(n=12, height=H, width=W, split="train")
    ref = jax_nyuv2.SyntheticSegDataset(n=12, height=H, width=W,
                                        split="train")
    kw = dict(batch_size=2, shuffle=True, drop_last=True, seed=3)
    l_ours = SegLoader(ours, SegPreprocessor(ours.depth_mean, ours.depth_std,
                                             H, W), **kw)
    l_ref = jax_pre.SegLoader(ref, jax_pre.SegPreprocessor(
        ref.depth_mean, ref.depth_std, H, W), **kw)
    _assert_tree_equal(l_ours.draw_sample(), next(iter(l_ref)))
    state = None
    for _ in range(100):  # until the JAX pass's thread has stopped drawing
        time.sleep(0.1)
        if state == l_ref._rng.bit_generator.state:
            break
        state = l_ref._rng.bit_generator.state
    for a, b in zip(l_ours, l_ref):
        _assert_tree_equal(a, b)


def test_recipe_eval_batch_identical():
    rgb, depth = nyuv2.make_recipe_eval_batch(4, H, W)
    ref_rgb, ref_depth = bench.make_recipe_eval_batch(4, H, W)
    np.testing.assert_array_equal(rgb, ref_rgb)
    np.testing.assert_array_equal(depth, ref_depth)
    assert rgb.shape == (4, H, W, 3) and depth.shape == (4, H, W, 1)


def test_confusion_matrix_and_miou():
    rng = np.random.default_rng(0)
    n = 7
    ours, ref = ConfusionMatrix(n), jax_metrics.ConfusionMatrix(n)
    for _ in range(3):
        label = rng.integers(-1, n + 1, 500)
        pred = rng.integers(0, n, 500)
        ours.update(label, pred)
        ref.update(label, pred)
        counts = confusion_update_counts(torch.from_numpy(label),
                                         torch.from_numpy(pred), n)
        ref_counts = jax_metrics.confusion_update_counts(
            jnp.asarray(label), jnp.asarray(pred), n)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(ours.matrix, ref.matrix)
    assert ours.miou() == ref.miou()
    assert ours.miou(ignore_absent=False) == ref.miou(ignore_absent=False)
    np.testing.assert_array_equal(ours.iou(), ref.iou())


@pytest.mark.parametrize("mode", ["median_frequency", "logarithmic", "linear",
                                  "None"])
def test_class_weights_identical(mode):
    ours, ref = _datasets(frac=0.5)
    got = compute_class_weights(ours, 40, mode)
    want = jax_build.compute_class_weights(ref, 40, mode)
    np.testing.assert_array_equal(got, want)
