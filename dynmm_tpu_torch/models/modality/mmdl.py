"""Generic multimodal model (port of ``dynmm_tpu/models/modality/mmdl.py``;
the reference's ``training_structures/Supervised_Learning.py::MMDL``):
per-modality encoders → fusion → head. Sequence encoders take an optional
``lengths`` list of (batch,) ints instead of packed sequences.

The encoders are a ``ModuleList`` (``encoders.0``, ...), which flax names
``encoders_0``, ...; ``utils/weights.py`` maps one onto the other.

The fusion is called as the JAX package calls it, ``fusion(outs)``: with
no lengths (a MulT fusion runs unmasked and summarises the last padded
step) and no train flag, so it stays deterministic while the model trains
(``MMDL.train`` keeps it in eval mode; in PyTorch ``model.train()`` would
reach it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn


class EncoderHead(nn.Module):
    """Unimodal encoder + head (the expert branches' training model)."""

    def __init__(self, encoder: nn.Module, head: nn.Module,
                 sequence: bool = False):
        super().__init__()
        self.encoder, self.head, self.sequence = encoder, head, sequence

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.encoder(x, lengths) if self.sequence else self.encoder(x)
        return self.head(h)


class MMDL(nn.Module):
    """``encoders[i](inputs[i])`` → ``fusion(outs)`` → ``head``."""

    def __init__(self, encoders: Sequence[nn.Module], fusion: nn.Module,
                 head: nn.Module, has_padding: bool = False):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)
        self.fusion, self.head = fusion, head
        self.has_padding = has_padding
        self.fusion.eval()

    def train(self, mode: bool = True) -> "MMDL":
        super().train(mode)
        self.fusion.eval()  # the JAX fusion never sees train=True
        return self

    def forward(self, inputs: Sequence[torch.Tensor],
                lengths: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        if self.has_padding:
            outs = [enc(inputs[i], lengths[i] if lengths else None)
                    for i, enc in enumerate(self.encoders)]
        else:
            outs = [enc(inputs[i]) for i, enc in enumerate(self.encoders)]
        fused = self.fusion(outs)
        if isinstance(fused, tuple):
            fused = fused[0]
        out = self.head(fused)
        return out[0] if isinstance(out, (list, tuple)) else out
