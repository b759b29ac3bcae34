"""CMU-MOSEI modality-level DynMM routers (port of
``dynmm_tpu/models/modality/affect.py``; the reference's
``ModalityDynMM/affect/affect_dyn.py``).

``MoseiDynMMNetV2`` (the paper's model): branch 1 is the text expert
(``Transformer(300, 120)`` + ``MLP(120, 64, 1)``), branch 2 the tri-modal
late fusion (``Transformer(35, 60)``, ``(74, 120)``, ``(300, 120)`` +
``Concat`` + ``MLP(300, 128, 1)``). The gate, ``Transformer(409, 10)`` →
``Linear(10, 2)``, reads the early concat of the three streams with the
visual stream's lengths; the text expert reads the text lengths.
``MoseiTriBranchDynMMNet`` has one unimodal expert per modality under a
three-way gate.

Modality order: (visual 35, audio 74, text 300). Sequences are (batch,
time, feat) with explicit ``lengths`` (``nn/sequence.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from dynmm_tpu_torch.core.gates import diff_softmax
from dynmm_tpu_torch.core.routing import compact_two_branch
from dynmm_tpu_torch.models.modality.mmdl import MMDL
from dynmm_tpu_torch.nn.fusions import Concat
from dynmm_tpu_torch.nn.mlp import MLP
from dynmm_tpu_torch.nn.sequence import Transformer

# per-branch M-MACs (thop-derived, affect_dyn.py:126)
MOSEI_FLOPS_M = np.array([135.13226, 320.03205])
VISUAL_DIM, AUDIO_DIM, TEXT_DIM = 35, 74, 300
GATE_IN = VISUAL_DIM + AUDIO_DIM + TEXT_DIM


def _nth(lengths, i: int):
    return lengths[i] if lengths else None


class _GateTransformer(nn.Module):
    """``encoder`` Transformer(409, 10) → ``fc`` Linear(10, branch_num)."""

    def __init__(self, branch_num: int):
        super().__init__()
        self.encoder = Transformer(GATE_IN, 10)
        self.fc = nn.Linear(10, branch_num)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.fc(self.encoder(x, lengths))


class MoseiDynMMNetV2(nn.Module):
    """Two-branch router: text expert vs tri-modal late fusion."""

    def __init__(self, branch_num: int = 2):
        super().__init__()
        self.branch_num = branch_num
        self.text_encoder = Transformer(TEXT_DIM, 120)
        self.text_head = MLP(120, 64, 1)
        self.branch2 = MMDL(
            encoders=[Transformer(VISUAL_DIM, 60), Transformer(AUDIO_DIM, 120),
                      Transformer(TEXT_DIM, 120)],
            fusion=Concat(), head=MLP(300, 128, 1), has_padding=True)
        self.gate = _GateTransformer(branch_num)

    def gate_weights(self, inputs: Sequence[torch.Tensor], lengths=None,
                     temp: float = 1.0, hard: bool = False) -> torch.Tensor:
        x = torch.cat(list(inputs), dim=2)  # (B, T, 409)
        return diff_softmax(self.gate(x, _nth(lengths, 0)), tau=temp,
                            hard=hard)

    def _text(self, ops) -> torch.Tensor:
        inputs, lengths = ops
        return self.text_head(self.text_encoder(inputs[2], _nth(lengths, 2)))

    def _fusion(self, ops) -> torch.Tensor:
        return self.branch2(*ops)

    def forward(self, inputs: Sequence[torch.Tensor], lengths=None,
                temp: float = 1.0, hard: bool = False, infer_mode: int = 0):
        """inputs = (visual (B, T, 35), audio (B, T, 74), text (B, T, 300));
        returns ``(pred (B, 1), resource, weight)``. ``infer_mode`` k > 0
        returns branch k's prediction alone; −1 mixes both branches with
        uniform weights (the reference's ablation)."""
        weight = self.gate_weights(inputs, lengths, temp=temp, hard=hard)
        preds = [self._text((inputs, lengths)),
                 self._fusion((inputs, lengths))]
        if infer_mode > 0:
            return preds[infer_mode - 1], weight.new_zeros(()), weight
        if infer_mode == -1:
            weight = torch.ones_like(weight) / self.branch_num
        out = weight[:, 0:1] * preds[0] + weight[:, 1:2] * preds[1]
        return out, weight[:, 1].mean(), weight

    def forward_routed_compact(self, inputs: Sequence[torch.Tensor],
                               lengths=None, temp: float = 1.0,
                               caps: Optional[Sequence[int]] = None,
                               force_k=None):
        """Hard-routed batch with bucket compaction: the tri-modal branch
        on the gate-sorted prefix, the text expert on the suffix
        (``core/routing.py::compact_two_branch``). ``force_k`` (B,)
        overrides the gate's choices. Returns ``(pred, weight)``; each row
        equals dense hard eval."""
        weight = self.gate_weights(inputs, lengths, temp=temp, hard=True)
        k = (weight.argmax(-1) if force_k is None
             else torch.as_tensor(force_k, device=weight.device))
        ops = (tuple(inputs), tuple(lengths) if lengths is not None else None)
        out = compact_two_branch(k, ops, self._text, self._fusion, caps=caps)
        return out, weight

    def forward_switch(self, inputs: Sequence[torch.Tensor], lengths=None,
                       temp: float = 1.0):
        """Hard-routed batch-1 inference: the gate's choice is read on the
        host and only that branch runs. Returns ``(pred, weight)``."""
        weight = self.gate_weights(inputs, lengths, temp=temp, hard=True)
        path = self._text if int(weight[0].argmax()) == 0 else self._fusion
        return path((inputs, lengths)), weight


class MoseiTriBranchDynMMNet(nn.Module):
    """Three-branch variant: a ``Transformer(d, 120)`` + ``MLP(120, 64, 1)``
    expert per modality, soft-combined by a three-way gate."""

    MODALITIES = ("visual", "audio", "text")

    def __init__(self, branch_num: int = 3):
        super().__init__()
        self.branch_num = branch_num
        for name, dim in zip(self.MODALITIES, (VISUAL_DIM, AUDIO_DIM, TEXT_DIM)):
            setattr(self, f"encoder_{name}", Transformer(dim, 120))
            setattr(self, f"head_{name}", MLP(120, 64, 1))
        self.gate = _GateTransformer(branch_num)

    def forward(self, inputs: Sequence[torch.Tensor], lengths=None,
                temp: float = 1.0, hard: bool = False, infer_mode: int = 0):
        x = torch.cat(list(inputs), dim=2)
        weight = diff_softmax(self.gate(x, _nth(lengths, 0)), tau=temp,
                              hard=hard)
        preds = [getattr(self, f"head_{m}")(getattr(self, f"encoder_{m}")(
                     inputs[i], _nth(lengths, i)))
                 for i, m in enumerate(self.MODALITIES)]
        if infer_mode > 0:
            return preds[infer_mode - 1], weight.new_zeros(()), weight
        if infer_mode == -1:
            weight = torch.ones_like(weight) / self.branch_num
        out = sum(weight[:, i:i + 1] * preds[i] for i in range(3))
        return out, weight[:, 2].mean(), weight
