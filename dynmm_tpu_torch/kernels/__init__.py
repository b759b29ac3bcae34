"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. See ``_build`` for how the CUDA sources are built and counted, and
``ops`` for the ``torch.library`` ops that ``torch.export`` traces."""

from dynmm_tpu_torch.kernels._build import LAUNCHES, build_all, reset_launches
from dynmm_tpu_torch.kernels import ops  # noqa: F401 (registers dynmm::*)

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
