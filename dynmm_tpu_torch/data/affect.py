"""CMU-MOSEI / CMU-MOSI sequence dataset (a copy of
``dynmm_tpu/data/affect.py``, numpy only): visual 35-d, audio 74-d, text
300-d GloVe; scalar sentiment in [-3, 3].

Real data: the MultiBench pickle the reference loads via
``datasets.affect.get_data.get_dataloader`` (``affect_dyn.py:199-201``) —
a dict with 'train'/'valid'/'test' splits each holding 'vision', 'audio',
'text' (N, 50, d) float arrays and 'labels' (N, 1). Sequences are 50-step
zero-padded clips; lengths are recovered from the padding (torch packs them;
here they become explicit mask lengths).

``synthetic_mosei`` generates shape-compatible fake data whose sentiment
depends on text alone for half the samples and on all modalities otherwise.
"""

from __future__ import annotations

import pickle

import numpy as np

from dynmm_tpu_torch.data.loader import ArrayLoader

SEQ_LEN = 50
VISUAL_DIM, AUDIO_DIM, TEXT_DIM = 35, 74, 300


def _lengths_from_padding(x: np.ndarray) -> np.ndarray:
    """Number of non-all-zero timesteps per sample (padding is zeros)."""
    nonzero = np.abs(x).sum(axis=2) > 0
    lengths = nonzero.sum(axis=1).astype(np.int32)
    return np.maximum(lengths, 1)


def load_mosei_pickle(path: str, split: str):
    with open(path, "rb") as f:
        data = pickle.load(f)
    d = data[split]
    vision = np.nan_to_num(np.asarray(d["vision"], dtype=np.float32))
    audio = np.nan_to_num(np.asarray(d["audio"], dtype=np.float32))
    text = np.nan_to_num(np.asarray(d["text"], dtype=np.float32))
    labels = np.asarray(d["labels"], dtype=np.float32).reshape(len(vision), -1)[:, :1]
    return vision, audio, text, labels


def mosei_loaders(path: str, batch_size: int = 32, seed: int = 0):
    out = []
    for split, shuffle in (("train", True), ("valid", False), ("test", False)):
        vision, audio, text, labels = load_mosei_pickle(path, split)
        lengths = [
            _lengths_from_padding(vision),
            _lengths_from_padding(audio),
            _lengths_from_padding(text),
        ]
        out.append(
            ArrayLoader(
                [vision, audio, text],
                labels,
                lengths=lengths,
                batch_size=batch_size,
                shuffle=shuffle,
                drop_last=shuffle,
                pad_tail=not shuffle,
                seed=seed,
            )
        )
    return tuple(out)


def synthetic_mosei(n: int = 256, seq_len: int = SEQ_LEN, seed: int = 0):
    rng = np.random.default_rng(seed)
    vision = rng.standard_normal((n, seq_len, VISUAL_DIM)).astype(np.float32)
    audio = rng.standard_normal((n, seq_len, AUDIO_DIM)).astype(np.float32)
    text = rng.standard_normal((n, seq_len, TEXT_DIM)).astype(np.float32)
    lengths = rng.integers(5, seq_len + 1, size=n).astype(np.int32)
    for arr in (vision, audio, text):
        for i, L in enumerate(lengths):
            arr[i, L:] = 0.0
    needs_all = rng.random(n) < 0.5
    base = text[:, :, :8].mean(axis=(1, 2)) * 10
    extra = (vision[:, :, :4].mean(axis=(1, 2)) + audio[:, :, :4].mean(axis=(1, 2))) * 10
    labels = np.clip(base + np.where(needs_all, extra, 0.0), -3, 3).astype(np.float32)
    text[:, 0, 0] = np.where(needs_all, 3.0, -3.0)
    return [vision, audio, text], labels.reshape(-1, 1), [lengths, lengths, lengths]


def synthetic_mosei_loaders(
    n_train: int = 128, n_valid: int = 64, batch_size: int = 32, seed: int = 0
):
    mods, labels, lengths = synthetic_mosei(n_train + 2 * n_valid, seed=seed)
    cuts = [(0, n_train), (n_train, n_train + n_valid), (n_train + n_valid, None)]
    out = []
    for i, (lo, hi) in enumerate(cuts):
        shuffle = i == 0
        out.append(
            ArrayLoader(
                [m[lo:hi] for m in mods],
                labels[lo:hi],
                lengths=[l[lo:hi] for l in lengths],
                batch_size=batch_size,
                shuffle=shuffle,
                drop_last=shuffle,
                pad_tail=not shuffle,
                seed=seed,
            )
        )
    return tuple(out)
