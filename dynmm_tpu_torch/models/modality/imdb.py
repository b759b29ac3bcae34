"""MM-IMDB modality-level DynMM router (port of
``dynmm_tpu/models/modality/imdb.py``; the reference's
``ModalityDynMM/multimedia/imdb_dyn.py:29-114``).

Branch 1 is the text expert (``MLP(300, 512, 512)`` + ``MLP(512, 512,
23)``), branch 3 the image+text late fusion ``MMDL([MaxOut_MLP(512, 512,
300, linear_layer=False), MaxOut_MLP(512, 1024, 4096, 512, False)], Concat,
Linear(1024, 23))``; the gate ``MLP(4396, 128, 2)`` reads both feature
vectors. The image-only branch 2 is off the routing path (the reference
dropped it for poor accuracy): its parameters exist, load and save, and
only ``forward_branch(…, 2)`` runs it.

``forward`` returns ``(logits, resource, weight)`` with resource =
``weight[:, 1].mean()``, the expensive-branch share that the λ-weighted
loss regularizes. Train/eval is the module's mode (``model.train()``);
the MaxOut_MLPs' BNs and dropout follow it.
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
from dynmm_tpu_torch.nn.mlp import MLP, LinearHead, MaxOut_MLP

# per-branch M-MACs (thop-derived, imdb_dyn.py:66)
IMDB_FLOPS_M = np.array([1.25261, 10.86908])
NUM_CLASSES = 23
TEXT_DIM, IMAGE_DIM = 300, 4096


class IMDBDynMMNet(nn.Module):
    """Two-branch router over precomputed features (text 300-d, image
    4096-d)."""

    def __init__(self, branch_num: int = 2, num_classes: int = NUM_CLASSES,
                 dropout_rate: float = 0.3, text_dim: int = TEXT_DIM,
                 image_dim: int = IMAGE_DIM):
        super().__init__()
        self.branch_num, self.num_classes = branch_num, num_classes
        self.text_encoder = MLP(text_dim, 512, 512)
        self.text_head = MLP(512, 512, num_classes)
        self.image_encoder = MLP(image_dim, 1024, 512)
        self.image_head = MLP(512, 512, num_classes)
        self.branch3 = MMDL(
            encoders=[
                MaxOut_MLP(512, 512, text_dim, linear_layer=False,
                           dropout_rate=dropout_rate),
                MaxOut_MLP(512, 1024, image_dim, 512, linear_layer=False,
                           dropout_rate=dropout_rate),
            ],
            fusion=Concat(),
            head=LinearHead(1024, num_classes),
        )
        self.gate = MLP(text_dim + image_dim, 128, branch_num)

    def gate_weights(self, inputs: Sequence[torch.Tensor], temp: float = 1.0,
                     hard: bool = True) -> torch.Tensor:
        x = torch.cat([i.reshape(i.shape[0], -1) for i in inputs], dim=1)
        return diff_softmax(self.gate(x), tau=temp, hard=hard)

    def _text(self, inputs) -> torch.Tensor:
        return self.text_head(self.text_encoder(inputs[0]))

    def forward(self, inputs: Sequence[torch.Tensor], temp: float = 1.0,
                hard: bool = True, infer_mode: int = 0):
        """inputs = (text (B, 300), image (B, 4096)); returns
        ``(logits, resource, weight)``. ``infer_mode`` k > 0 returns branch
        k's logits alone (routed branches 1 = text, 2 = fusion)."""
        weight = self.gate_weights(inputs, temp=temp, hard=hard)
        preds = [self._text(inputs), self.branch3(inputs)]
        if infer_mode > 0:
            return preds[infer_mode - 1], weight.new_zeros(()), weight
        out = weight[:, 0:1] * preds[0] + weight[:, 1:2] * preds[1]
        return out, weight[:, 1].mean(), weight

    def forward_branch(self, inputs: Sequence[torch.Tensor],
                       path: int) -> torch.Tensor:
        """One branch (the reference's ``forward_separate_branch``): 1 =
        text, 2 = image, else the late fusion."""
        if path == 1:
            return self._text(inputs)
        if path == 2:
            return self.image_head(self.image_encoder(inputs[1]))
        return self.branch3(inputs)

    def forward_routed_compact(self, inputs: Sequence[torch.Tensor],
                               temp: float = 1.0,
                               caps: Optional[Sequence[int]] = None,
                               force_k=None):
        """Hard-routed batch with bucket compaction
        (``core/routing.py::compact_two_branch``): the fusion branch runs on
        the gate-sorted prefix, the text expert on the suffix. ``force_k``
        (B,) overrides the gate's branch choices. Returns
        ``(logits, weight)``; each row equals dense hard eval."""
        weight = self.gate_weights(inputs, temp=temp, hard=True)
        k = (weight.argmax(-1) if force_k is None
             else torch.as_tensor(force_k, device=weight.device))
        out = compact_two_branch(k, tuple(inputs), self._text, self.branch3,
                                 caps=caps)
        return out, weight

    def forward_switch(self, inputs: Sequence[torch.Tensor],
                       temp: float = 1.0):
        """Hard-routed batch-1 inference: the gate's choice is read on the
        host and only that branch runs. Returns ``(logits, weight)``."""
        weight = self.gate_weights(inputs, temp=temp, hard=True)
        if int(weight[0].argmax()) == 0:
            return self._text(inputs), weight
        return self.branch3(inputs), weight
