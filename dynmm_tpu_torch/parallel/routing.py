"""Distributed routed inference: device-local adaptive skipping (port of
``dynmm_tpu/parallel/routing.py``).

The batch splits over the mesh's 'data' axis and each rank runs the
batch-adaptive routed forward (``forward_switch_batched``, or the
per-sample compacted ``forward_routed_compact``) on its own rows: each rank
takes its own gate decisions and its own ``k_max``, so a rank whose rows
are all easy skips its depth stages while a neighbour with hard samples runs
deep, with no collective on the routing decision. The only collective is
the gather of the outputs over 'data'.

This beats global-batch routing (one ``k_max`` across all ranks: one hard
sample anywhere forfeits everyone's skips) the way per-sample bucket
compaction beats batch-max within one device.

Usage (every rank of the mesh):

    mesh = make_mesh(n_data=2)
    fn = make_sharded_routed_forward(model, mesh)
    logits = fn(rgb, depth)   # the global batch; batch % n_data == 0
"""

from __future__ import annotations

import torch

from dynmm_tpu_torch.parallel.mesh import Mesh, _map, replicate


def make_sharded_routed_forward(model, mesh: Mesh, method_name: str =
                                "forward_switch_batched", **method_kwargs):
    """``fn(rgb, depth)`` over the global batch: this rank's rows through
    ``model.<method_name>(rows, **method_kwargs)`` on the mesh's device,
    then every output gathered over 'data'. The mesh has no 'model' axis
    (the kernels read whole weights, as in JAX, where the routing mesh is
    data-only); the model's weights are rank 0's (broadcast here, once)."""
    if mesh.n_model != 1:
        raise ValueError("sharded routing takes a data-only mesh "
                         f"(this one is {mesh.shape})")
    replicate(model, mesh)
    method = getattr(model, method_name)

    def run(rgb, depth):
        rows = mesh.rows(rgb.shape[0])
        with torch.inference_mode():
            out = method(torch.as_tensor(rgb[rows]).to(mesh.device),
                         torch.as_tensor(depth[rows]).to(mesh.device),
                         **method_kwargs)
            return _map(mesh.gather_rows, out)

    return run
