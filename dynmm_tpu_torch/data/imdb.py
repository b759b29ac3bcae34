"""MM-IMDB feature dataset (a copy of ``dynmm_tpu/data/imdb.py``, numpy
only): text word2vec 300-d + image VGG 4096-d, 23 genre multilabels.

Real data: the MultiBench ``multimodal_imdb.hdf5`` layout the reference loads
via ``datasets.imdb.get_data.get_dataloader`` (``imdb_dyn.py:134``): datasets
``features`` (word2vec text), ``vgg_features`` (image), ``genres`` (multi-hot
labels), with the canonical split train [:15552], dev [15552:18160],
test [18160:].

``synthetic_imdb`` generates a structured fake dataset with the same shapes
for tests/benchmarks without the real corpus: labels depend linearly on both
modalities so that (a) fusing modalities genuinely helps and (b) a gate has
signal to route on.
"""

from __future__ import annotations

import numpy as np

from dynmm_tpu_torch.data import hdf5
from dynmm_tpu_torch.data.loader import ArrayLoader

TEXT_DIM, IMAGE_DIM, N_CLASSES = 300, 4096, 23
SPLITS = {"train": (0, 15552), "dev": (15552, 18160), "test": (18160, None)}


def load_imdb_hdf5(path: str, split: str):
    """Read (text, image, labels) arrays for a split from the MultiBench
    hdf5, through the port's own HDF5 reader (``data/hdf5.py``: the card's
    machine has no h5py); a file it cannot read raises."""
    lo, hi = SPLITS[split]
    with hdf5.File(path) as f:
        text = np.asarray(f["features"][lo:hi], dtype=np.float32)
        image = np.asarray(f["vgg_features"][lo:hi], dtype=np.float32)
        labels = np.asarray(f["genres"][lo:hi], dtype=np.float32)
    return text.reshape(len(text), -1), image.reshape(len(image), -1), labels


def imdb_loaders(
    path: str,
    batch_size: int = 128,
    seed: int = 0,
) -> tuple[ArrayLoader, ArrayLoader, ArrayLoader]:
    """(train, valid, test) loaders over the real hdf5 file."""
    out = []
    for split, shuffle in (("train", True), ("dev", False), ("test", False)):
        text, image, labels = load_imdb_hdf5(path, split)
        out.append(
            ArrayLoader(
                [text, image],
                labels,
                batch_size=batch_size,
                shuffle=shuffle,
                drop_last=shuffle,
                pad_tail=not shuffle,
                seed=seed,
            )
        )
    return tuple(out)


def synthetic_imdb(
    n: int = 512,
    seed: int = 0,
    text_dim: int = TEXT_DIM,
    image_dim: int = IMAGE_DIM,
    n_classes: int = N_CLASSES,
):
    """Structured synthetic MM-IMDB-like data: ~half the samples are
    'text-sufficient' (labels fully determined by text), the rest need the
    image modality — giving a routing gate real signal."""
    rng = np.random.default_rng(seed)
    text = rng.standard_normal((n, text_dim)).astype(np.float32)
    image = rng.standard_normal((n, image_dim)).astype(np.float32)
    w_t = rng.standard_normal((text_dim, n_classes)).astype(np.float32) / np.sqrt(text_dim)
    w_i = rng.standard_normal((image_dim, n_classes)).astype(np.float32) / np.sqrt(image_dim)
    needs_image = rng.random(n) < 0.5
    logits = text @ w_t + np.where(needs_image[:, None], image @ w_i, 0.0)
    labels = (logits > 0).astype(np.float32)
    # text feature 0 encodes "needs image" so the gate can learn the split
    text[:, 0] = np.where(needs_image, 3.0, -3.0)
    return text, image, labels


def synthetic_imdb_loaders(
    n_train: int = 256,
    n_valid: int = 128,
    batch_size: int = 64,
    seed: int = 0,
):
    text, image, labels = synthetic_imdb(n_train + 2 * n_valid, seed=seed)
    cuts = [n_train, n_train + n_valid]
    out = []
    for i, (lo, hi) in enumerate(
        [(0, cuts[0]), (cuts[0], cuts[1]), (cuts[1], None)]
    ):
        shuffle = i == 0
        out.append(
            ArrayLoader(
                [text[lo:hi], image[lo:hi]],
                labels[lo:hi],
                batch_size=batch_size,
                shuffle=shuffle,
                drop_last=shuffle,
                pad_tail=not shuffle,
                seed=seed,
            )
        )
    return tuple(out)
