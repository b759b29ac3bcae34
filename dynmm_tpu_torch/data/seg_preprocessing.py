"""Preprocessing / augmentation for RGB-D segmentation (a copy of
``dynmm_tpu/data/seg_preprocessing.py``, which the port does not import).

Mirrors the reference transform stack (``FusionDynMM/src/preprocessing.py``):

train: RandomRescale(1.0–1.4, bilinear rgb / nearest depth+label) →
RandomCrop(480×640) → RandomHSV(0.9–1.1, 0.9–1.1, ±25) → RandomFlip →
Normalize(ImageNet rgb stats; depth z-score, raw mode keeps zeros) →
MultiScaleLabel(/8, /16, /32 nearest).

test: Rescale(height,width) → Normalize.

Host-side numpy per sample, with the same sequence of draws from the
caller's ``np.random.Generator`` as the JAX package, so one seed gives the
same crops, flips and HSV jitter. Resizes run through the native library
(``dynmm_tpu_torch/native``) with cv2's semantics; the port has no cv2
fallback. Batching happens in ``SegLoader``. Layout is NHWC throughout.
Also here: eval.py's noise injection (``inject_eval_noise``, the same numpy
draws) and the packed stem's host feed (``pack_stem_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dynmm_tpu_torch import native

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
DOWNSAMPLING_RATES = (8, 16, 32)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized RGB→HSV with h,s ∈ [0,1] and v in the input's scale."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        dn = np.maximum(delta, 1e-12)
        h = np.select(
            [maxc == r, maxc == g],
            [((g - b) / dn) % 6.0, (b - r) / dn + 2.0],
            (r - g) / dn + 4.0,
        )
    h = np.where(delta > 0, h / 6.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of ``_rgb_to_hsv`` (v stays in its own scale)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def _resize(img: np.ndarray, width: int, height: int, nearest: bool) -> np.ndarray:
    """cv2-semantics resize: float32 bilinear or nearest and int32 nearest
    through the native library (source ``floor(dst · src/dst)``); other
    integer maps (uint8 labels) nearest by cv2's own rule, which the JAX
    package takes for them (``cv2.resize``: ``floor(dst · (1 / (dst/src)))``
    in double, one source row or column apart from the native rule where
    ``dst · src/dst`` rounds just below an integer)."""
    if img.dtype == np.float32 or (img.dtype == np.int32 and nearest):
        return native.resize(img, height, width, nearest)
    if nearest and np.issubdtype(img.dtype, np.integer):
        return img[_cv2_nearest(img.shape[0], height)][
            :, _cv2_nearest(img.shape[1], width)]
    raise TypeError(f"no resize for {img.dtype} (nearest={nearest})")


def _cv2_nearest(n_in: int, n_out: int) -> np.ndarray:
    """cv2 ``INTER_NEAREST``'s source index of each output index."""
    scale = 1.0 / (n_out / n_in)
    idx = np.floor(np.arange(n_out) * scale).astype(np.int64)
    return np.minimum(idx, n_in - 1)


@dataclasses.dataclass
class SegPreprocessor:
    """Callable sample transform; ``phase`` 'train' applies augmentation."""

    depth_mean: float
    depth_std: float
    height: Optional[int] = 480
    width: Optional[int] = 640
    phase: str = "train"
    depth_mode: str = "refined"
    scale_range: tuple[float, float] = (1.0, 1.4)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        image = sample["image"].astype(np.float32)
        depth = sample["depth"].astype(np.float32)
        label = sample.get("label")

        if self.phase == "train":
            image, depth, label = self._random_rescale(image, depth, label, rng)
            image, depth, label = self._random_crop(image, depth, label, rng)
            image = self._random_hsv(image, rng)
            image, depth, label = self._random_flip(image, depth, label, rng)
        elif self.height is not None:
            image = _resize(image, self.width, self.height, nearest=False)
            depth = _resize(depth, self.width, self.height, nearest=True)
            if label is not None and "label_orig" not in sample:
                sample = dict(sample)
                sample["label_orig"] = label  # keep original for mIoU eval
            # note: test labels are NOT resized (mIoU computed at orig res)

        out = {
            "image": self._normalize_rgb(image),
            "depth": self._normalize_depth(depth)[..., None],
        }
        if label is not None:
            if self.phase == "train":
                out["label"] = label.astype(np.int32)
                out["label_down"] = {
                    r: _resize(label, label.shape[1] // r, label.shape[0] // r, True).astype(np.int32)
                    for r in DOWNSAMPLING_RATES
                }
            else:
                out["label_orig"] = sample.get("label_orig", label).astype(np.int32)
                # also provide a model-resolution label for valid-loss logging
                out["label"] = _resize(
                    label, out["image"].shape[1], out["image"].shape[0], True
                ).astype(np.int32)
        return out

    # ------------------------------------------------------------- transforms
    def _random_rescale(self, image, depth, label, rng):
        scale = rng.uniform(*self.scale_range)
        th = int(round(scale * image.shape[0]))
        tw = int(round(scale * image.shape[1]))
        return (
            _resize(image, tw, th, False),
            _resize(depth, tw, th, True),
            _resize(label, tw, th, True),
        )

    def _random_crop(self, image, depth, label, rng):
        h, w = image.shape[:2]
        ch, cw = self.height, self.width
        if h <= ch or w <= cw:
            return (
                _resize(image, cw, ch, False),
                _resize(depth, cw, ch, True),
                _resize(label, cw, ch, True),
            )
        i = rng.integers(0, h - ch)
        j = rng.integers(0, w - cw)
        return (
            image[i : i + ch, j : j + cw],
            depth[i : i + ch, j : j + cw],
            label[i : i + ch, j : j + cw],
        )

    def _random_hsv(self, image, rng):
        # scale-free HSV (v = max channel in the input's own scale, 0..255
        # here) — matches the matplotlib behavior the reference relied on
        # (h,s ∈ [0,1], v clipped to [0,255]; preprocessing.py:143-161).
        hsv = _rgb_to_hsv(image)
        h = np.clip(hsv[:, :, 0] * rng.uniform(0.9, 1.1), 0, 1)
        s = np.clip(hsv[:, :, 1] * rng.uniform(0.9, 1.1), 0, 1)
        v = np.clip(hsv[:, :, 2] + rng.uniform(-25, 25), 0, 255)
        return _hsv_to_rgb(np.stack([h, s, v], axis=2)).astype(np.float32)

    def _random_flip(self, image, depth, label, rng):
        if rng.random() > 0.5:
            return (
                np.ascontiguousarray(image[:, ::-1]),
                np.ascontiguousarray(depth[:, ::-1]),
                np.ascontiguousarray(label[:, ::-1]),
            )
        return image, depth, label

    def _normalize_rgb(self, image):
        return ((image / 255.0) - RGB_MEAN) / RGB_STD

    def _normalize_depth(self, depth):
        if self.depth_mode == "raw":
            invalid = depth == 0
            out = (depth - self.depth_mean) / self.depth_std
            out[invalid] = 0.0
            return out
        return (depth - self.depth_mean) / self.depth_std


def inject_eval_noise(image: np.ndarray, depth: np.ndarray, mode: int,
                      noise: float, rng) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-noise robustness injection (eval.py:91-102): with per-batch
    probability 1/3, add noise scaled by ``noise * mean(|x|)``; mode 0 = rgb,
    1 = depth, 2 = either (1/3 rgb, 1/3 depth). ``rng`` is the run's seeded
    ``np.random.Generator``: ``rng.random()`` first, then one
    ``standard_normal`` of the raw NHWC batch's shape, as the JAX package
    draws them."""
    r = rng.random()

    def noisy(x):
        return x + noise * np.abs(x).mean() * rng.standard_normal(
            x.shape).astype(np.float32)

    if mode == 0 and r < 0.33:
        image = noisy(image)
    elif mode == 1 and r < 0.33:
        depth = noisy(depth)
    elif mode == 2:
        if r < 0.33:
            image = noisy(image)
        elif r < 0.66:
            depth = noisy(depth)
    return image, depth


def pack_stem_batch(batch: dict) -> dict:
    """The packed stem's host feed: raw rgb (C=3) and depth (C=1) of a
    stacked batch dict with even H and W become their ``(N, H/2, W/2, 4C)``
    space-to-depth forms (``models/resnet.py::space_to_depth_host``).
    Channel-guarded, so an already-packed batch passes unchanged. Meant as
    a ``SegLoader`` ``post=`` hook, which runs it in the prefetch thread."""
    from dynmm_tpu_torch.models.resnet import space_to_depth_host

    out = dict(batch)
    for key, raw_c in (("image", 3), ("depth", 1)):
        x = batch.get(key)
        if (x is not None and x.ndim == 4 and x.shape[-1] == raw_c
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            out[key] = space_to_depth_host(np.asarray(x))
    return out


class SegLoader:
    """Batched loader over a map-style RGB-D dataset + preprocessor.

    Yields dict batches of stacked NHWC arrays. Training shuffles and drops
    the ragged tail; eval keeps order with batch size 1..n (label_orig may
    vary in size across datasets, so eval batches group same-shape samples —
    NYUv2 is uniform 480×640 so any batch size works).

    ``post`` (optional) transforms each stacked batch dict inside the
    prefetch thread (e.g. ``pack_stem_batch``), overlapping host-side work
    with device compute.
    """

    def __init__(
        self,
        dataset,
        preprocessor: SegPreprocessor,
        batch_size: int = 8,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        post=None,
    ):
        self.dataset = dataset
        self.pre = preprocessor
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.post = post
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idx):
        samples = [self.pre(self.dataset[int(i)], self._rng) for i in idx]
        batch = self._stack(samples)
        return self.post(batch) if self.post is not None else batch

    def _pass(self) -> list:
        """A new pass's batches of sample indices (the shuffle drawn)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        return [order[b * bs : (b + 1) * bs] for b in range(len(self))]

    def draw_sample(self) -> dict:
        """``next(iter(loader))`` without a thread left behind: the first
        batch of a new pass, the loader's stream moved as that abandoned
        pass moves it, which is how ``train.py`` draws the sample batch of
        its init. The pass's prefetch thread makes batches until its queue
        is full (the batch handed over, ``prefetch`` queued, one waiting to
        be queued) or the pass ends; they are made here and dropped."""
        batches = self._pass()
        n = 1 if self.prefetch <= 0 or len(batches) <= 1 else min(
            len(batches), self.prefetch + 2)
        made = [self._make_batch(idx) for idx in batches[:n]]
        return made[0]

    def __iter__(self):
        batches = self._pass()
        if self.prefetch <= 0 or len(batches) <= 1:
            for idx in batches:
                yield self._make_batch(idx)
            return
        # background-thread prefetch keeps the accelerator fed while the
        # native augmentation runs on host (the reference's 32-worker
        # DataLoader pool becomes one OpenMP pass + a pipeline thread)
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for idx in batches:
                    q.put(self._make_batch(idx))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()

    @staticmethod
    def _stack(samples: list[dict]) -> dict:
        out = {
            "image": np.stack([s["image"] for s in samples]).astype(np.float32),
            "depth": np.stack([s["depth"] for s in samples]).astype(np.float32),
        }
        if "label" in samples[0]:
            out["label"] = np.stack([s["label"] for s in samples])
        if "label_down" in samples[0]:
            out["label_down"] = {
                r: np.stack([s["label_down"][r] for s in samples])
                for r in samples[0]["label_down"]
            }
        if "label_orig" in samples[0]:
            out["label_orig"] = np.stack([s["label_orig"] for s in samples])
        return out
