"""Serialized serving artifacts through ``torch.export`` (port of
``dynmm_tpu/utils/serve_export.py``).

An artifact is one file: the chosen serving forward traced at a fixed
input shape with the weights it reads (parameters, packed and folded
copies, int8 scales) baked in. ``load_serving_fn`` replays it with no
model code and no checkpoint; the port's kernels run in it as the
``dynmm::`` ops of
``kernels/ops.py`` (the card's launches, or the plain versions on the CPU),
and the routed forwards' host reads as ``torch.cond``s
(``models/skip_gate.py``).

The file is a zip archive: ``manifest.json`` (the input shapes and dtypes,
the platforms) and one ``torch.export.save`` program a platform,
``<platform>.pt2``. A program of the port is traced on its own device
(device constants, such as a zero depth map's, are baked into it), so an
artifact for ``("cuda", "cpu")`` holds two programs, the CPU one traced on
a CPU copy of the module; the CPU program runs the ops' CPU
implementations, the plain versions.

    payload = export_serving_fn(ServingForward(model, "compact"), rgb, depth)
    save_serving_artifact("serve.pt2", payload)
    fn = load_serving_fn("serve.pt2")     # any process, after the import
    logits, weight = fn(rgb, depth)
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Callable, NamedTuple, Sequence

import torch
from torch.export import ExportedProgram
from torch.export.graph_signature import ExportGraphSignature, InputKind

import dynmm_tpu_torch.kernels  # noqa: F401 (registers the dynmm:: ops)

PLATFORMS = ("cuda", "cpu")


class Aval(NamedTuple):
    """One input of an artifact, as JAX's ``in_avals``."""
    shape: tuple
    dtype: torch.dtype


def export_serving_fn(module_fn: torch.nn.Module,
                      *example_inputs: torch.Tensor,
                      platforms: Sequence[str] | None = None) -> bytes:
    """The artifact bytes of ``module_fn`` (an ``nn.Module`` whose
    ``forward(*inputs)`` is the serving forward: ``(rgb, depth)`` for the
    segmentation stack, ``(text, image)`` or ``(vision, audio, text)`` for
    the routers), traced at the shapes and dtypes of ``example_inputs``
    under ``torch.no_grad``. ``platforms``: names in ``PLATFORMS`` (default:
    the device of the inputs); a platform other than the inputs' traces a
    copy of the module and of the inputs moved there. A failed export
    raises."""
    here = example_inputs[0].device.type
    platforms = tuple(platforms or (here,))
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{platforms}")
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps({
            "platforms": list(platforms),
            "inputs": [{"shape": list(x.shape),
                        "dtype": str(x.dtype).removeprefix("torch.")}
                       for x in example_inputs]}))
        for p in platforms:
            module, inputs = module_fn, example_inputs
            if p != here:
                module = copy.deepcopy(module_fn).to(p)
                inputs = tuple(x.to(p) for x in example_inputs)
            buf = io.BytesIO()
            torch.export.save(export_program(module, *inputs), buf)
            z.writestr(f"{p}.pt2", buf.getvalue())
    return out.getvalue()


def export_program(module_fn: torch.nn.Module,
                   *example_inputs: torch.Tensor) -> ExportedProgram:
    """The ``ExportedProgram`` of one platform of an artifact:
    ``module_fn`` traced under ``torch.no_grad`` at ``example_inputs``, on
    their device, holding only the weights its graph reads."""
    with torch.no_grad():
        return _read_weights_only(
            torch.export.export(module_fn, tuple(example_inputs)))


def _read_weights_only(program: ExportedProgram) -> ExportedProgram:
    """``program`` without the parameters, buffers and constants its graph
    never reads: an eval forward reads the kernels' packed and folded
    copies, not the training weights they came from (a third of the
    flagship's bytes)."""
    gm = program.graph_module
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    specs = []
    state_dict, constants = dict(program.state_dict), dict(program.constants)
    for spec, node in zip(program.graph_signature.input_specs, placeholders):
        if spec.kind == InputKind.USER_INPUT or node.users:
            specs.append(spec)
            continue
        gm.graph.erase_node(node)
        state_dict.pop(spec.target, None)
        constants.pop(spec.target, None)
    gm.recompile()
    return ExportedProgram(
        root=gm, graph=gm.graph,
        graph_signature=ExportGraphSignature(
            specs, program.graph_signature.output_specs),
        state_dict=state_dict, range_constraints=program.range_constraints,
        module_call_graph=program.module_call_graph,
        example_inputs=program.example_inputs, constants=constants,
        verifiers=[program.verifier])


def save_serving_artifact(path: str, payload: bytes) -> None:
    with open(path, "wb") as f:
        f.write(payload)


def load_serving_fn(path: str, device=None) -> Callable:
    """``fn(*inputs)`` replaying the artifact at ``path`` on ``device``
    (default: the card where the artifact has a CUDA program and a card is
    present, else its first platform). ``fn.in_avals``: the inputs'
    shapes and dtypes; ``fn.platforms``: the artifact's; ``fn.program``:
    the ``ExportedProgram``. A platform the artifact lacks, or an op that
    is not registered, raises."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        platforms = manifest["platforms"]
        if device is None:
            device = ("cuda" if "cuda" in platforms
                      and torch.cuda.is_available() else platforms[0])
        device = torch.device(device)
        if device.type not in platforms:
            raise ValueError(f"{path} holds programs for {platforms}, not "
                             f"{device.type}")
        program = torch.export.load(io.BytesIO(z.read(f"{device.type}.pt2")))
    module = program.module()

    def fn(*inputs):
        with torch.no_grad():
            return module(*inputs)

    fn.in_avals = tuple(Aval(tuple(i["shape"]), getattr(torch, i["dtype"]))
                        for i in manifest["inputs"])
    fn.platforms = tuple(platforms)
    fn.program = program
    return fn
