"""Per-branch MAC counting for the CMU-MOSEI DynMM router (the twin of
``examples/affect/count_flop.py``; the reference's
``ModalityDynMM/affect/count_flop.py``), with ``--device``:

    python -m dynmm_tpu_torch.cli.affect_count_flop [--device cpu]

Counts ``MoseiDynMMNetV2``'s two branches and its gate on one 50-step zero
clip per modality (visual 35, audio 74, text 300; lengths 50) with
``utils/flops.py`` and prints the JAX script's lines. Each branch is
counted alone (``_text``, ``_fusion``): ``forward(infer_mode=k)`` computes
both branches before it picks one, where XLA drops the dead one. The count
is ``utils/flops.py``'s: products plus the elementwise ops of its
``ELEMENTWISE`` rule, at most XLA's figure and within 2.4 % of it (the
gate; the branches within 0.1 %). The router's FLOP
table (``MOSEI_FLOPS_M``) stays the reference's thop numbers. It runs on
the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import torch

from dynmm_tpu_torch.cli.imdb_count_flop import parse_args
from dynmm_tpu_torch.models.modality import build_router
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.flops import count_macs, count_params

T = 50


def main(argv=None) -> None:
    device = resolve_device(parse_args(argv).device)
    model = build_router("mosei", device=device)
    mods = [torch.zeros((1, T, d), device=device) for d in (35, 74, 300)]
    lengths = [torch.full((1,), T, dtype=torch.int32, device=device)] * 3
    for fn, name in ((model._text, "text transformer"),
                     (model._fusion, "tri-modal late fusion")):
        macs = count_macs(fn, (mods, lengths))
        print(f"branch {name}: {macs / 1e6:.5f} M MACs")
    gate = count_macs(model.gate_weights, mods, lengths)
    print(f"gate: {gate / 1e6:.5f} M MACs")
    print(f"params: {count_params(model) / 1e6:.3f} M")


if __name__ == "__main__":
    main()
