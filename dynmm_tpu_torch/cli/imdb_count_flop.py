"""Per-branch MAC counting for the MM-IMDB DynMM router (the twin of
``examples/multimedia/count_flop.py``; the reference's
``ModalityDynMM/multimedia/count_flop.py``), with ``--device``:

    python -m dynmm_tpu_torch.cli.imdb_count_flop [--device cpu]

Counts each branch's forward (``forward_branch`` 1 text, 2 image, 3 late
fusion) and the gate on one zero sample (text (1, 300), image (1, 4096))
with ``utils/flops.py`` and prints the JAX script's lines. The count is
``utils/flops.py``'s: products plus the elementwise ops of its
``ELEMENTWISE`` rule, at most XLA's figure (text, image and gate equal;
the late fusion 0.14 % below). The router's FLOP table
(``IMDB_FLOPS_M``) stays the reference's thop numbers. It runs on the card;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import torch

from dynmm_tpu_torch.models.modality import build_router
from dynmm_tpu_torch.utils.device import resolve_device
from dynmm_tpu_torch.utils.flops import count_macs, count_params


def parse_args(argv=None):
    ap = argparse.ArgumentParser("imdb_count_flop")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the card (cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    device = resolve_device(parse_args(argv).device)
    model = build_router("imdb", device=device)
    inputs = [torch.zeros((1, 300), device=device),
              torch.zeros((1, 4096), device=device)]
    for path, name in ((1, "text"), (2, "image"), (3, "late-fusion")):
        macs = count_macs(model.forward_branch, inputs, path)
        print(f"branch {name}: {macs / 1e6:.5f} M MACs")
    print(f"gate: {count_macs(model.gate_weights, inputs) / 1e6:.5f} M MACs")
    print(f"params: {count_params(model) / 1e6:.3f} M")


if __name__ == "__main__":
    main()
