"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. See ``_build`` for how the CUDA sources are built and counted."""

from dynmm_tpu_torch.kernels._build import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
