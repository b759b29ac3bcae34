"""Rank functions of the mesh tests (``tests/test_torch_port_mesh.py``):
each runs in a process that ``parallel/launch.py::run_ranks`` spawns, on
gloo with CPU tensors. This module imports torch, numpy and the port only
(no JAX): every spawned rank imports it."""

import numpy as np
import torch

from dynmm_tpu_torch.core.resource import GateStats
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.parallel.mesh import canonical_name, make_mesh
from dynmm_tpu_torch.parallel.routing import make_sharded_routed_forward
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.train.seg_losses import StreamingValidLoss
from dynmm_tpu_torch.utils.checkpoint import save_ckpt_every_epoch
from dynmm_tpu_torch.utils.weights import load_flax_variables


class Loader(list):
    """Batches that ``SegTrainer.validate`` reads as a loader (one camera,
    split "test")."""

    dataset = None


def port_model(model_kw: dict, variables: dict,
               dtype=torch.float64) -> SkipGateESANet:
    model = SkipGateESANet(ESANetConfig(**model_kw))
    load_flax_variables(model, variables)
    return model.to(dtype)


def train_and_validate(model_kw, variables, train_batches, valid_batches, cw,
                       train_kw, lr, temp, mesh_shape=None, min_out=None,
                       ckpt_dir=None, dtype=torch.float64) -> dict:
    """One epoch over ``train_batches`` with parameters in ``dtype`` (on a
    mesh of ``mesh_shape`` = (D, M), or in one process for None), the state tree
    after it (written as the rolling checkpoint under ``ckpt_dir``), then
    ``validate`` in float32 over ``valid_batches`` (none for None). Returns
    what rank 0 (or the process) saw, and this rank's parameter and
    momentum shapes."""
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape,
                                                     device="cpu")
    model = port_model(model_kw, variables, dtype)
    trainer = SegTrainer(model, SegTrainConfig(epochs=1, **train_kw), cw,
                         device="cpu", mesh=mesh, min_out=min_out)
    state = trainer.init_state()
    state, logs = trainer.train_one_epoch(state, train_batches, 0, lr, temp)
    tree = state.tree()
    if ckpt_dir is not None and (mesh is None or mesh.rank == 0):
        save_ckpt_every_epoch(ckpt_dir, tree, 0, 0.0, 0)
    opt = state.optimizer.opt
    local = {canonical_name(n): tuple(p.shape)
             for n, p in model.named_parameters()}
    moments = {n: tuple(opt.state[p]["momentum_buffer"].shape)
               for n, p in state.optimizer.named.items() if p in opt.state}
    cms, gates, miou, vlogs = {}, GateStats(), None, None
    if valid_batches is not None:
        model.float()
        miou, vlogs = trainer.validate(
            state, Loader(valid_batches), valid_loss=StreamingValidLoss(
                torch.as_tensor(cw)), collect_weights=gates, out_cms=cms)
    first = mesh is None or mesh.rank == 0
    return {"logs": logs, "tree": tree if first else None, "local": local,
            "moments": moments, "miou": miou, "vlogs": vlogs, "cms": cms,
            "gates": gates.weights,
            "rank": None if mesh is None else mesh.rank}


def mesh_runs(runs: list) -> list:
    """``train_and_validate(**kw)`` for each ``kw`` of ``runs``, in turn, on
    the same world (each run makes its own mesh)."""
    return [train_and_validate(**kw) for kw in runs]


class PathsGate:
    """Gate override that decides from the sample alone: a sample whose
    pooled stem maps are flat (a blank image) takes path 0, no depth
    stage; every other sample path 4, all of them."""

    def __init__(self, model):
        model.gate_weights = self

    def __call__(self, rgb, depth, temp=1.0, hard=False, baseline=False):
        spread = rgb.flatten(2).std(dim=-1).amax(dim=-1)
        paths = torch.where(spread < 1e-6, 0, 4)
        return torch.nn.functional.one_hot(paths, 5).to(rgb.dtype)


def routed(model_kw, variables, rgb, depth, n_data, methods) -> list:
    """Each (method, kwargs) of ``methods`` as a sharded routed forward
    over ``n_data`` ranks on the global batch: its gathered output and the
    depth stages this rank ran."""
    mesh = make_mesh(n_data, 1, device="cpu")
    model = port_model(model_kw, variables, torch.float32).eval()
    PathsGate(model)
    stages = []
    for i in (1, 2, 3, 4):
        getattr(model.encoder_depth, f"layer{i}").register_forward_hook(
            lambda *a, i=i: stages.append(i))
    out = []
    for method, kwargs in methods:
        fn = make_sharded_routed_forward(model, mesh, method, **kwargs)
        stages.clear()
        logits = fn(torch.from_numpy(rgb), torch.from_numpy(depth))
        out.append({"out": logits.numpy(), "stages": list(stages)})
    return out
