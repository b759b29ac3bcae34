"""PyTorch / CUDA port of ``dynmm_tpu`` for one NVIDIA H100 (Hopper).

The JAX package ``dynmm_tpu`` stays the reference; this package mirrors its
layout (``core/``, ``nn/``, ``kernels/``, ``models/``, ``utils/``) so each
module's counterpart is found under the same path. It imports ``torch`` and
numpy only, never JAX or anything of ``dynmm_tpu``.

Public layout follows the JAX package (NHWC at every public function);
activations are held internally as NCHW tensors in ``torch.channels_last``
memory, so ``x.permute(0, 2, 3, 1)`` hands each hand-written kernel
contiguous NHWC memory without a copy.

Entry points take ``device=None``, which means CUDA; without a card they
raise and ask for ``device="cpu"`` (see ``utils.device.resolve_device``).
"""

from dynmm_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
