"""In-memory batch loader for the feature datasets (MM-IMDB, CMU-MOSEI): a
copy of ``dynmm_tpu/data/loader.py`` (numpy only), so batches, shuffle
order (``default_rng(seed)``), padded tails and their ``valid`` masks are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Batch:
    """One batch: list of modality arrays, labels, optional per-modality
    lengths, and a validity mask for padded tail batches."""

    inputs: list[np.ndarray]
    label: np.ndarray
    lengths: Optional[list[np.ndarray]] = None
    valid: Optional[np.ndarray] = None  # (B,) bool; None = all valid

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum()) if self.valid is not None else len(self.label)


class ArrayLoader:
    """Batches over parallel in-memory arrays.

    ``pad_tail`` pads the final partial batch to full size (marked via
    ``Batch.valid``) so every eval step sees one shape;
    ``drop_last`` drops it instead (training default, matching the
    reference's DataLoader(drop_last=True) in prepare_data.py:146-150).
    """

    def __init__(
        self,
        inputs: Sequence[np.ndarray],
        label: np.ndarray,
        lengths: Optional[Sequence[np.ndarray]] = None,
        batch_size: int = 32,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_tail: bool = False,
        seed: int = 0,
    ):
        self.inputs = [np.asarray(x) for x in inputs]
        self.label = np.asarray(label)
        self.lengths = [np.asarray(l) for l in lengths] if lengths else None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_tail = pad_tail
        self._rng = np.random.default_rng(seed)
        self.n = len(self.label)
        if any(len(x) != self.n for x in self.inputs):
            raise ValueError("every modality needs one row per label")

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        n_full = self.n // bs
        for i in range(n_full):
            idx = order[i * bs : (i + 1) * bs]
            yield self._make(idx, None)
        rem = self.n - n_full * bs
        if rem and not self.drop_last:
            idx = order[n_full * bs :]
            if self.pad_tail:
                pad = np.concatenate([idx, np.repeat(idx[-1], bs - rem)])
                valid = np.zeros(bs, bool)
                valid[:rem] = True
                yield self._make(pad, valid)
            else:
                yield self._make(idx, None)

    def _make(self, idx, valid) -> Batch:
        return Batch(
            inputs=[x[idx] for x in self.inputs],
            label=self.label[idx],
            lengths=[l[idx] for l in self.lengths] if self.lengths else None,
            valid=valid,
        )
