"""CSV run logger (a copy of ``dynmm_tpu/utils/logger.py``; reference
``FusionDynMM/src/logger.py:9-22``): dict-writer append logger over a fixed
key schema, one row per epoch."""

from __future__ import annotations

import csv
import os
from typing import Sequence


class CSVLogger:
    def __init__(self, keys: Sequence[str], path: str, append: bool = True):
        self.keys = list(keys)
        self.path = path
        mode = "a" if append else "w"
        write_header = not (append and os.path.exists(path) and os.path.getsize(path) > 0)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, mode, newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self.keys, extrasaction="ignore")
        if write_header:
            self._writer.writeheader()
            self._file.flush()

    def write_logs(self, logs: dict) -> None:
        self._writer.writerow({k: logs.get(k, "") for k in self.keys})
        self._file.flush()

    def close(self) -> None:
        self._file.close()
