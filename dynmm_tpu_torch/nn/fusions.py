"""Multimodal fusions (port of ``dynmm_tpu/nn/fusions.py``). ``Concat``,
the late fusion of the modality-level routers, is ported; ``ConcatEarly``,
``LowRankTensorFusion`` and ``MultiplicativeInteractions2Modal`` wait for
the ``_mm`` expert CLIs (ROADMAP A8)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class Concat(nn.Module):
    """Late fusion: flatten each modality's representation and concatenate
    them on the feature axis."""

    def forward(self, modalities: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([m.reshape(m.shape[0], -1) for m in modalities],
                         dim=-1)
