"""The port's FLOP counting and latency harness against the JAX package's:
``utils/flops.py``, ``utils/profiling.py`` and the two count_flop CLIs.

* ``cli.imdb_count_flop`` / ``cli.affect_count_flop`` print the lines of
  ``examples/multimedia/count_flop.py`` / ``examples/affect/count_flop.py``
  (run in process): the same labels, ``params`` equal, and every branch's
  and the gate's MACs at most JAX's and at least 0.97× JAX's
  (``utils/flops.py`` counts products plus the elementwise ops of its
  ``ELEMENTWISE`` rule, each at a lower bound of XLA's count). MOSEI's
  branches are counted apart.
* ``count_flops`` of a linear layer, a relu and a conv: their products at
  2 FLOPs a multiply-add, the bias add and the relu at 1 an element.
* ``PhaseTimer`` as ``tests/test_aux_subsystems.py`` checks the JAX one;
  ``test_time`` on a stub (one warm-up pass, then one pass a repetition,
  each over every batch); ``trace`` writes a Chrome JSON trace.
* ``forward_routed_compact`` (what ``--measure --routed`` times) equals
  the dense hard eval for both routers, with and without caps.
"""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _port_modality_setup import inputs as modality_inputs
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu_torch.cli import affect_count_flop, imdb_count_flop
from dynmm_tpu_torch.models.modality import build_router
from dynmm_tpu_torch.utils import flops, profiling

REPO = Path(__file__).resolve().parents[1]
LINE = re.compile(r"^(branch .*|gate|params): ([0-9.]+) M( MACs)?$")


def _example(rel: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{Path(rel).parent.name}_count_flop", REPO / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(text: str) -> dict:
    out = {}
    for ln in text.splitlines():
        m = LINE.match(ln)
        if m:
            out[m.group(1)] = (float(m.group(2)), ln)
    return out


@pytest.mark.parametrize("name,cli,example", [
    ("imdb", imdb_count_flop, "examples/multimedia/count_flop.py"),
    ("affect", affect_count_flop, "examples/affect/count_flop.py")])
def test_count_flop_matches_jax(capsys, name, cli, example):
    _example(example).main()
    want = _lines(capsys.readouterr().out)
    cli.main(["--device", "cpu"])
    text = capsys.readouterr().out
    got = _lines(text)
    print(text)
    assert list(got) == list(want) and len(got) == (5 if name == "imdb" else 4)
    for key, (value, line) in got.items():
        ref, ref_line = want[key]
        # the JAX script's format, number for number
        assert re.sub(r"[0-9.]+", "N", line) == re.sub(r"[0-9.]+", "N",
                                                        ref_line)
        if key == "params":
            assert value == ref
        else:
            assert 0.97 * ref <= value <= ref, (key, value, ref)
    if name == "affect":  # one branch at a time, not both twice
        a, b = (got[k][0] for k in list(got)[:2])
        assert a < 0.5 * b


def test_count_flops_counts_products_and_elementwise():
    lin = torch.nn.Linear(30, 20)
    mlp = torch.nn.Sequential(lin, torch.nn.ReLU())
    assert flops.count_flops(mlp, torch.zeros(4, 30)) == (
        2 * 4 * 30 * 20 + 4 * 20 + 4 * 20)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
    assert flops.count_macs(conv, torch.zeros(2, 3, 5, 5)) == (
        2 * 5 * 5 * 8 * 3 * 9)
    bn = torch.nn.BatchNorm1d(20)
    assert flops.count_params(torch.nn.Sequential(lin, bn)) == (
        30 * 20 + 20 + 2 * 20)  # BN statistics are buffers


def test_phase_timer_accumulates():
    t = profiling.PhaseTimer()
    with t.phase("forward"):
        pass
    with t.phase("forward"):
        pass
    logs = t.as_logs()
    assert "time_forward" in logs and logs["time_forward"] >= 0
    assert list(t.as_logs("t_")) == ["t_forward"]


def test_time_passes_over_every_batch():
    seen = []

    def to_device(b):
        return torch.full((2,), float(b))

    def apply(b):
        seen.append(int(b[0]))
        return b * 2

    mean, std = profiling.test_time(apply, [1, 2, 3], to_device,
                                    repetitions=4)
    assert seen == [1, 2, 3] * 5  # warm-up + 4 passes
    assert mean >= 0 and std >= 0
    assert np.isfinite([mean, std]).all()


def test_trace_writes_chrome_json(tmp_path):
    with profiling.trace(str(tmp_path)) as where:
        torch.ones(8) @ torch.ones(8)
    assert where == str(tmp_path)
    (path,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(path.read_text())


@pytest.mark.parametrize("kind", ["imdb", "mosei"])
@pytest.mark.parametrize("caps", [None, (0,), (2, 7)])
def test_routed_compact_equals_dense_hard(kind, caps):
    """Each capacity ladder (the default, padding every bucket to B, an
    uneven one) gives the dense hard eval's rows."""
    model = build_router(kind, seed=3, device="cpu")
    xs, ls = modality_inputs(kind)
    args = ([torch.from_numpy(x) for x in xs],)
    if ls is not None:
        args += ([torch.from_numpy(l) for l in ls],)
    with torch.no_grad():
        ref, _, ref_w = model(*args, hard=True)
        out, w = model.forward_routed_compact(*args, caps=caps)
    assert 0 < int(ref_w.argmax(-1).sum()) < 8  # both branches run
    np.testing.assert_array_equal(w.numpy(), ref_w.numpy())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
