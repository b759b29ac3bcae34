"""Gate temperature schedules (a copy of ``dynmm_tpu/core/schedules.py``,
which the port does not import).

Reference: ``FusionDynMM/src/utils.py:194-224`` defines a linear schedule
(``get_temp``) and an exponential one (``ExpDecayTemp``); ``train.py:189`` uses
the exponential schedule with ``--temp``/``--end-temp``/``--epoch-hard``.
"""

from __future__ import annotations

import math


class ExpDecayTemp:
    """Exponential temperature decay: ``t(e) = start_t * b**e`` with
    ``b = exp(ln(end_t / start_t) / time_len)`` so that ``t(time_len) = end_t``.

    Mirrors ``FusionDynMM/src/utils.py:203-214`` including the ``time_len == 0``
    guard (constant temperature).
    """

    def __init__(self, start_t: float, end_t: float, time_len: int):
        self.start_t = start_t
        self.end_t = end_t
        self.time_len = time_len
        if time_len == 0:
            self.b = 1.0
        else:
            self.b = math.exp(math.log(end_t / start_t) / time_len)

    def __call__(self, epoch: int) -> float:
        return self.start_t * self.b**epoch

    # parity alias with the reference API
    get_t = __call__


def linear_temp(
    start_epoch: int, curr_epoch: int, end_epoch: int, start_t: float, end_t: float
) -> float:
    """Piecewise-linear temperature (``FusionDynMM/src/utils.py:194-200``)."""
    if curr_epoch <= start_epoch:
        return start_t
    if curr_epoch >= end_epoch:
        return end_t
    frac = (curr_epoch - start_epoch) / (end_epoch - start_epoch)
    return start_t + frac * (end_t - start_t)
