"""Model-call adapters for ``SupervisedTrainer`` (port of
``dynmm_tpu/train/adapters.py``): ``call(batch, train) -> (out, loss2,
weight)``, with the model in train or eval mode as ``train`` says. Each
adapter keeps its model as ``call.model``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _kwargs(model_kwargs: dict, lengths) -> dict:
    kwargs = dict(model_kwargs)
    if lengths is not None:
        kwargs["lengths"] = lengths
    return kwargs


def dynmm_adapter(model: torch.nn.Module, **model_kwargs) -> Callable:
    """DynMM routers returning ``(out, resource, weight)``: IMDBDynMMNet,
    MoseiDynMMNetV2, MoseiTriBranchDynMMNet."""

    def call(batch: dict, train: bool):
        model.train(train)
        return model(batch["inputs"], **_kwargs(model_kwargs,
                                                batch.get("lengths")))

    call.model = model
    return call


def mmdl_adapter(model: torch.nn.Module, **model_kwargs) -> Callable:
    """Expert models (MMDL, encoder + head) returning logits only."""

    def call(batch: dict, train: bool):
        model.train(train)
        out = model(batch["inputs"], **_kwargs(model_kwargs,
                                               batch.get("lengths")))
        return out, out.new_zeros(()), None

    call.model = model
    return call


def unimodal_adapter(model: torch.nn.Module, modality_index: int,
                     **model_kwargs) -> Callable:
    """A single-modality encoder + head on one input stream (the
    reference's ``training_structures.unimodal``)."""

    def call(batch: dict, train: bool):
        model.train(train)
        lengths = batch.get("lengths")
        out = model(batch["inputs"][modality_index], **_kwargs(
            model_kwargs, None if lengths is None else lengths[modality_index]))
        return out, out.new_zeros(()), None

    call.model = model
    return call
