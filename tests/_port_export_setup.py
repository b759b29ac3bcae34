"""Shared set-up of the port's serving-artifact tests
(``test_torch_port_export*.py``): the small NBt1D SkipGateESANet of the CLI
tests (``_port_eval_setup``: 64×96, decoder (32, 32, 32), SE-add fusion,
learned upsampling, the recipe gate merged, so the recipe batch takes a
mix of paths) in fp32, bf16 and int8 on one set of seeded weights, the JAX
package's replay of its own artifact of the same nets, and the round trip
and checks of a port artifact."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import torch

from _port_eval_setup import SMALL, H, W, jax_model, random_variables
from _port_variants_setup import load_exported
from dynmm_tpu.utils import serve_export as jax_export
from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
from dynmm_tpu_torch.data.seg_preprocessing import pack_stem_batch
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.utils.quantize import quantize_int8
from dynmm_tpu_torch.utils.serve_export import (export_program,
                                                export_serving_fn,
                                                load_serving_fn,
                                                save_serving_artifact)
from dynmm_tpu_torch.utils.weights import flax_variables

B = 4
CLASSES = 40
FP32_TOL = 1e-4  # of max |JAX logits|
BF16_TOL = 5e-2  # of max |JAX fp32 logits|
INT8_L2_TOL = 5e-2  # relative L2
# the kernel sites of the small net: all six of the global-gate net; the
# bf16 and int8 nets' NBt1D blocks run their unfused convs
SITES = {"channel_sums", "stem_fuse_pool", "se_fuse_mixed",
         "learned_upsample", "nbt1d_fused", "nbt1d_pair"}
NO_NBT1D = SITES - {"nbt1d_fused", "nbt1d_pair"}


def make_nets(int8: bool = True) -> dict:
    """The JAX variables; the port's fp32 and bf16 nets on them and (with
    ``int8``) the int8 net, calibrated on the batch and packed as
    ``cli.predict --quant int8`` does, its scales carried to JAX; the
    recipe batch (B=4, half of it depth-needed) raw and packed."""
    variables = random_variables(n_classes=CLASSES, seed=0)
    rgb, depth = make_recipe_eval_batch(B, H, W)
    nets = {"variables": variables, "inputs": (rgb, depth)}
    kinds = {"fp32": {}, "bf16": {"dtype": torch.bfloat16}}
    if int8:
        kinds["int8"] = {"quant": "int8"}
    for name, kw in kinds.items():
        model = SkipGateESANet(ESANetConfig(num_classes=CLASSES, **kw,
                                            **SMALL))
        nets[name] = load_exported(model, variables).to(
            memory_format=torch.channels_last).eval()
    if int8:
        quantize_int8(nets["int8"], [(torch.from_numpy(rgb),
                                      torch.from_numpy(depth))], hard=True)
        nets["int8_variables"] = flax_variables(nets["int8"])
    packed = pack_stem_batch({"image": rgb, "depth": depth})
    nets["packed"] = (packed["image"], packed["depth"])
    return nets


def jax_refs(nets: dict, forms=("dense", "low_res", "int8")) -> dict:
    """(logits, weight) of the JAX package's hard dense forward on the
    recipe batch, fp32 (``dense``), at ``low_res`` and int8 on the port's
    scales, from ONE JAX artifact of the ``forms`` asked
    (``export_serving_fn`` → save → ``load_serving_fn``): one export and
    one compile."""
    fp32 = jax_model(CLASSES)
    int8 = jax_model(CLASSES, quant="int8")

    def apply(v, r, d):
        v32, v8 = v
        out = {}
        for form in forms:
            model, vv = (int8, v8) if form == "int8" else (fp32, v32)
            out[form] = model.apply(vv, r, d, train=False, hard=True,
                                    return_weight=True,
                                    low_res=form == "low_res")
        return out

    variables = ({k: nets["variables"][k] for k in ("params", "batch_stats")},
                 nets.get("int8_variables", {}))
    payload = jax_export.export_serving_fn(
        apply, variables, *(np.shape(a) for a in nets["inputs"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.stablehlo")
        jax_export.save_serving_artifact(path, payload)
        out = jax_export.load_serving_fn(path)(*map(jnp.asarray,
                                                    nets["inputs"]))
    return {k: tuple(np.asarray(o, np.float32) for o in v)
            for k, v in out.items()}


def roundtrip(tmp_path, module, *inputs):
    """Export → save → ``load_serving_fn`` of ``module`` at ``inputs``."""
    path = tmp_path / "artifact.pt2"
    save_serving_artifact(str(path), export_serving_fn(module, *inputs))
    return load_serving_fn(str(path))


def in_memory(module, *inputs):
    """The program an artifact of ``module`` at ``inputs`` would hold
    (``export_program``), replayed as ``load_serving_fn`` replays it, with
    no save and load: ``fn.program`` as in ``roundtrip``."""
    program = export_program(module, *inputs)
    replay = program.module()

    def fn(*args):
        with torch.no_grad():
            return replay(*args)

    fn.program = program
    return fn


def graph_ops(program) -> set:
    """The ``dynmm::`` ops in the program's graph and its subgraphs."""
    return {str(n.target).split(".")[1]
            for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if str(n.target).startswith("dynmm.")}


def conds(program) -> int:
    """The ``torch.cond``s of the program's top-level graph."""
    return sum(1 for n in program.graph.nodes if "cond" in str(n.target))


def check_replay(fn, module, inputs, sites):
    """The replay against eager on ``inputs`` (error 0) and the graph's
    ops; returns the replay's outputs."""
    with torch.no_grad():
        want = module(*inputs)
    got = fn(*inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert graph_ops(fn.program) == sites
    return got


def close_to_jax(got, ref, rel=FP32_TOL):
    """Gate weights identical, logits within ``rel`` of max |JAX|."""
    (out, w), (ref_out, ref_w) = got, ref
    np.testing.assert_array_equal(w.numpy(), ref_w)
    scale = np.abs(ref_out).max()
    assert scale > 0.1
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=0,
                               atol=rel * scale)
