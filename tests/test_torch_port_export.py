"""The port's serving artifacts (``utils/serve_export.py``, ``torch.export``)
on the CPU: the kernels as ``dynmm::`` ops, and each B=4 form of the served
forward exported, saved, loaded and replayed (``_port_export_setup``: the
small NBt1D SkipGateESANet with the recipe gate, on seeded weights that
both packages load).

* each op against ``torch.library.opcheck`` (schema, fake implementation,
  no aliasing), fp32 and, where the kernel has one, bf16; its CPU
  implementation the plain version;
* each form's replay against the port's eager forward on the same inputs:
  logits and gate weights with error 0 (the replay runs the same aten ops,
  and the ops' CPU implementations are the plain versions the eager CPU
  forward calls), its graph holding the ``dynmm::`` ops of the kernel
  sites the eager forward reaches (a routed graph in its ``torch.cond``
  branches);
* each replay against the JAX package's replay of its own artifact on the
  same weights (``dynmm_tpu/utils/serve_export.py``): the hard dense
  forward, which every routed form, the packed stem and the strict
  schedule that covers the batch equal up to rounding; the H/4 logits for
  ``low_res``; the int8 net on the same scales. fp32 within 1e-4 of max
  |JAX logits| with identical gate weights (``test_torch_port_model.py``'s
  bound), bf16 within 5e-2 of max |JAX fp32 logits|
  (``test_torch_port_bf16.py``), int8 within 5e-2 relative L2 with
  identical gate weights (``test_torch_port_quant.py``). One JAX artifact
  holds the three JAX forwards (one compile).

The B=1 switch forms, the MM-IMDB router and the predict CLI's export are
in ``test_torch_port_export_switch.py``.
"""

import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from _port_eval_setup import REPO
from _port_export_setup import (B, BF16_TOL, INT8_L2_TOL, NO_NBT1D, SITES,
                                check_replay, close_to_jax, conds, jax_refs,
                                make_nets, roundtrip)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu_torch.kernels import nbt1d, ops, se, stem_fuse, upsample
from dynmm_tpu_torch.serve import ServingForward, capacity_schedule
from dynmm_tpu_torch.utils.serve_export import (Aval, export_serving_fn,
                                                load_serving_fn,
                                                save_serving_artifact)


# ------------------------------------------------------------------ ops
def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _op_samples(dtype):
    """(name, args) of each op at small shapes, maps of ``dtype``."""
    g = _g()
    rn = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    maps = lambda *s: rn(*s).to(dtype)
    b, h, w, c, cr = 2, 5, 6, 16, 4
    mlp = (rn(c, cr, scale=0.3), rn(cr, scale=0.1), rn(cr, c, scale=0.3),
           rn(c, scale=0.1))
    samples = [
        ("channel_sums", (maps(b, h, w, c), maps(b, h, w, c))),
        ("stem_fuse_pool", (maps(b, h, w, c), maps(b, h, w, c),
                            maps(b, c), maps(b, c))),
        ("se_fuse_mixed", (maps(b, h, w, c), maps(b, h, w, c),
                           torch.tensor([0.0, 1.0]), *mlp, *mlp)),
        ("fused_se", (maps(b, h * w, c), *mlp)),
        ("learned_upsample", (maps(b, h, w, c), maps(3, 3, c), maps(c))),
    ]
    if dtype == torch.float32:  # the NBt1D kernels have no bf16 form
        pair = (rn(3, c, c, scale=0.2), rn(c), rn(3, c, c, scale=0.2), rn(c),
                rn(c), rn(c))
        x = rn(b, h, w, c)
        samples += [("nbt1d_pair", (x, *pair, None)),
                    ("nbt1d_pair", (x, *pair, rn(b, h, w, c))),
                    ("nbt1d_fused", (x, *pair, *pair, 0))]
    return samples


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ops_pass_opcheck(dtype):
    samples = _op_samples(dtype)
    names = {n for n, _ in samples}
    assert names == set(ops.OPS) - ({"nbt1d_pair", "nbt1d_fused"}
                                    if dtype == torch.bfloat16 else set())
    for name, args in samples:
        result = torch.library.opcheck(ops.CUSTOM_OPS[name], args)
        assert all(v == "SUCCESS" for v in result.values()), (name, result)


def test_op_cpu_implementations_are_the_plain_versions():
    """Each op on CPU tensors gives its plain version's values, contiguous
    as the launches write them."""
    plain = {"channel_sums": lambda *a: torch.stack(
                 se.channel_sums_plain(*a)),
             "stem_fuse_pool": stem_fuse.stem_fuse_pool_plain,
             "se_fuse_mixed": se.se_fuse_mixed_plain,
             "fused_se": se.se_reference,
             "learned_upsample": upsample.learned_upsample_plain,
             "nbt1d_pair": nbt1d.nbt1d_pair_plain,
             "nbt1d_fused": lambda x, *a: nbt1d.nbt1d_fused_plain(x, *a[:-1])}
    for name, args in _op_samples(torch.float32):
        got = getattr(torch.ops.dynmm, name)(*args)
        want = plain[name](*args)
        for o, r in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert o.is_contiguous()
            torch.testing.assert_close(o, r, rtol=0, atol=0)


# ------------------------------------------------------------ artifacts
@pytest.fixture(scope="module")
def nets():
    nets = make_nets()
    nets["jax"] = jax_refs(nets)
    return nets


FORMS = {  # name: (net, serve mode, options, feed, kernel sites, conds)
    "dense": ("fp32", "dense", {}, "inputs", SITES, False),
    "batchmax": ("fp32", "batchmax", {}, "inputs", SITES, True),
    "compact": ("fp32", "compact", {}, "inputs", SITES, True),
    "low_res": ("fp32", "dense", {"low_res": True}, "inputs", SITES, False),
    "packed": ("fp32", "dense", {}, "packed", SITES, False),
    "bf16": ("bf16", "dense", {}, "inputs", NO_NBT1D, False),
    "int8": ("int8", "dense", {}, "inputs", NO_NBT1D, False),
}


def _int8_gemm(node) -> bool:
    """An int8 conv's GEMM in an exported graph (``nn/quant.py::int_mm``):
    ``aten._int_mm`` on the card, a float64 ``aten.mm`` on the CPU."""
    if str(node.target) == "aten._int_mm.default":
        return True
    val = node.meta.get("val")
    return (str(node.target) == "aten.mm.default"
            and getattr(val, "dtype", None) == torch.float64)


@pytest.mark.parametrize("form", list(FORMS))
def test_artifact_equals_eager_and_jax(nets, tmp_path, form):
    net, mode, kw, feed, sites, has_conds = FORMS[form]
    module = ServingForward(nets[net], mode, **kw)
    inputs = tuple(map(torch.from_numpy, nets[feed]))
    fn = roundtrip(tmp_path, module, *inputs)
    assert fn.in_avals == tuple(Aval(tuple(x.shape), torch.float32)
                                for x in inputs)
    got = check_replay(fn, module, inputs, sites)
    assert (conds(fn.program) > 0) == has_conds
    assert len(set(got[1].argmax(-1).tolist())) > 1  # a mix of paths
    if form == "int8":
        ref = nets["jax"]["int8"]
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
        out = got[0].numpy()
        assert (np.linalg.norm(out - ref[0]) / np.linalg.norm(ref[0])
                < INT8_L2_TOL)
        n_convs = sum(1 for m in nets["int8"].modules()
                      if getattr(m, "quant", None) == "int8")
        assert sum(1 for n in fn.program.graph.nodes
                   if _int8_gemm(n)) == n_convs
    elif form == "bf16":
        assert got[0].dtype == torch.bfloat16
        close_to_jax(got, nets["jax"]["dense"], rel=BF16_TOL)
    else:
        close_to_jax(got, nets["jax"]["low_res" if form == "low_res"
                                      else "dense"])


def test_compact_strict_artifact(nets, tmp_path):
    """``compact`` on the strict schedule of ``capacity_schedule`` at
    capacity factor 1.0 on the batch's own ratios: single rungs that cover
    it, so no cond at all, and the dense result."""
    model = nets["fp32"]
    inputs = tuple(map(torch.from_numpy, nets["inputs"]))
    caps = capacity_schedule(model, [inputs], B, capacity_factor=1.0)
    assert all(len(rungs) == 1 for rungs in caps)
    module = ServingForward(model, "compact", caps=caps, strict_caps=True)
    fn = roundtrip(tmp_path, module, *inputs)
    got = check_replay(fn, module, inputs, SITES)
    assert conds(fn.program) == 0
    close_to_jax(got, nets["jax"]["dense"])


def test_unknown_platform_and_switch_host_raise(nets):
    inputs = tuple(torch.from_numpy(a[:1]) for a in nets["inputs"])
    with pytest.raises(ValueError, match="platforms must be among"):
        export_serving_fn(ServingForward(nets["fp32"], "dense"), *inputs,
                          platforms=("tpu",))
    with pytest.raises(ValueError, match="export mode 'switch' instead"):
        ServingForward(nets["fp32"], "switch_host")


class _Upsample(torch.nn.Module):
    def __init__(self, c: int = 4):
        super().__init__()
        g = _g(3)
        self.register_buffer("taps", torch.randn(3, 3, c, generator=g))
        self.register_buffer("bias", torch.randn(c, generator=g))

    def forward(self, x):
        return upsample.learned_upsample(x, self.taps, self.bias)


def test_artifact_needs_the_registered_ops(tmp_path):
    """A program that calls a ``dynmm::`` op replays after the import of
    ``dynmm_tpu_torch.kernels`` and fails at load in a process without
    it."""
    x = torch.randn(1, 3, 5, 4, generator=_g(4))
    path = tmp_path / "a.pt2"
    module = _Upsample()
    save_serving_artifact(str(path), export_serving_fn(module, x))
    with torch.no_grad():
        torch.testing.assert_close(load_serving_fn(str(path))(x), module(x),
                                   rtol=0, atol=0)
    with zipfile.ZipFile(path) as z:
        (tmp_path / "cpu.pt2").write_bytes(z.read("cpu.pt2"))
    code = "import sys, torch; torch.export.load(sys.argv[1]); print('loaded')"
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cpu.pt2")],
                       env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "loaded" not in r.stdout
    assert "dynmm" in r.stderr
