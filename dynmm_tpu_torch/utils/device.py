"""The port's device rule: entry points run on the card unless asked not to."""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (the card may be set below its maximum power, and then runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls on the
    current stream (CUDA events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, replays: int = 3) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph (after a warm-up call) and its replays timed with CUDA events. The
    host's cost of issuing a call, which ``time_ms`` measures instead where
    a call's device work is shorter, is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Without a card that raises instead of silently
    running on the CPU; pass ``device="cpu"`` to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU (its kernels then take their plain PyTorch "
                "versions)")
        return torch.device("cuda")
    return torch.device(device)
