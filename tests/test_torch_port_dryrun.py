"""``dynmm_tpu_torch.dryrun.dryrun_multichip`` (the twin of
``__graft_entry__.py::dryrun_multichip``) on 4 CPU ranks over gloo: the
flagship's 2×2 mesh train step, the routed-compact eval under the mesh and
both sharded routed forwards run, and it prints JAX's OK line (the same
fields in the same format: the mesh, the global batch, the loss, the three
output shapes, the feed). The zero images of JAX's dry run leave every BN
of the first step a constant map, so its loss depends on the order of
fp32 sums; ``tests/test_torch_port_mesh.py`` holds the mesh step to the
one-process step. Without ``device`` (and through the command) it runs on
the card: with none it raises before it starts a rank."""

import re

import numpy as np
import pytest
import torch

from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu_torch import dryrun

# __graft_entry__.py's f-string, with the feed this port names
OK = re.compile(
    r"dryrun_multichip OK: mesh=\{'data': 2, 'model': 2\} batch=2 "
    r"loss=(?P<loss>[\d.]+) routed_eval=\(2, 64, 64, 40\) "
    r"shard_map_batchmax=\(4, 64, 64, 40\) "
    r"shard_map_compact=\(4, 64, 64, 40\) feed=make_global_batch")


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    line = dryrun.dryrun_multichip(4, device="cpu", timeout=120)
    assert capsys.readouterr().out.strip() == line
    m = OK.fullmatch(line)
    assert m, line
    assert np.isfinite(float(m["loss"]))


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["4"])
