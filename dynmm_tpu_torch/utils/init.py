"""``--he_init`` (port of ``dynmm_tpu/utils/init.py::apply_he_init``; the
reference's ``build_model.py:152-178``).

Kaiming-normal (fan-out, relu) re-draw of conv kernels, except the SE
blocks (sigmoid-terminated), the learned upsamples, output layers
(``out_channels == n_classes``) and kernels with one input channel and more
than 8 outputs (the JAX rule for depthwise convs, which also leaves the
depth stem's 1-channel conv as it is); BN and biases stay. The draws come
from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.utils.weights import torch_to_flax_key


def _skipped_subtree(name: str) -> bool:
    parts = torch_to_flax_key(name).split(".")[:-1]
    return any(p.startswith("se_") or p.startswith("upsample") for p in parts)


@torch.no_grad()
def apply_he_init(model: nn.Module, generator: torch.Generator,
                  n_classes: int) -> None:
    """Re-draw the model's conv kernels in place (see the module
    docstring), then rebuild its packed weight copies."""
    for name, p in model.named_parameters():
        if not name.endswith(".weight") or p.dim() != 4 or _skipped_subtree(name):
            continue
        c_out, c_in, kh, kw = p.shape
        if c_out == n_classes or (c_in == 1 and c_out > 8):
            continue
        std = math.sqrt(2.0 / (kh * kw * c_out))
        draw = torch.randn(p.shape, generator=generator,
                           device=generator.device, dtype=p.dtype)
        p.copy_(draw * std)
    pack_weights(model)
