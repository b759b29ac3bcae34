"""Modality-level DynMM: sample-wise expert-branch routing (port of
``dynmm_tpu/models/modality``).

* ``mmdl``   — encoders + fusion + head multimodal model
* ``imdb``   — MM-IMDB text vs. image+text late-fusion router
* ``affect`` — CMU-MOSEI text vs. tri-modal transformer router

``build_router`` is the entry point that places a router on a device;
``init_model`` does the same for any modality-level model (the expert
CLIs' encoders, fusions and heads).
"""

import torch

from dynmm_tpu_torch.models.modality.affect import (MOSEI_FLOPS_M,
                                                    MoseiDynMMNetV2,
                                                    MoseiTriBranchDynMMNet)
from dynmm_tpu_torch.models.modality.imdb import IMDB_FLOPS_M, IMDBDynMMNet
from dynmm_tpu_torch.models.modality.mmdl import MMDL, EncoderHead
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.init import flax_default_init

ROUTERS = {"imdb": IMDBDynMMNet, "mosei": MoseiDynMMNetV2,
           "tribranch": MoseiTriBranchDynMMNet}


def init_model(model: torch.nn.Module, seed: int = 0, device=None):
    """``model`` with flax's default initialisation drawn from ``seed``, in
    eval mode on ``device`` (``None``: the card, which raises without one;
    ``"cpu"`` for the CPU)."""
    device = resolve_device(device)
    flax_default_init(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def build_router(name: str, seed: int = 0, device=None, **kwargs):
    """Router ``name`` (``imdb``, ``mosei``, ``tribranch``), as
    ``init_model`` places it."""
    return init_model(ROUTERS[name](**kwargs), seed, device)


__all__ = ["build_router", "init_model", "ROUTERS", "MMDL", "EncoderHead", "IMDBDynMMNet",
           "IMDB_FLOPS_M", "MoseiDynMMNetV2", "MoseiTriBranchDynMMNet",
           "MOSEI_FLOPS_M"]
