"""Start the ranks of a world on this machine, and stop every one of them.

``run_ranks(fn, world, args)`` spawns ``world`` processes, joins them in one
``torch.distributed`` world (``tcp://127.0.0.1:<free port>``: nothing outside
this machine), runs ``fn(*args)`` on each and returns each rank's result in
rank order. ``fn`` is a module-level function (the spawned processes import
it). A rank that raises fails the call with its traceback; a rank that dies,
or a world still running after ``timeout`` seconds, fails it too; every
process is stopped before ``run_ranks`` returns or raises, and each rank's
collectives time out after ``timeout`` seconds, so no rank waits on a dead
one for ever. ``timeout=None`` (a training run) sets no limit on the world;
its collectives still time out after ``COLLECTIVE_S``.

On the card, rank r runs on ``cuda:{r % device_count}``; the backend is
NCCL where every rank has a card of its own and gloo where ranks share one
(NCCL refuses two ranks on one device) or run on the CPU
(``default_backend``). A CPU rank runs one intra-op thread: ranks share
the machine's cores with each other and with any other work on it.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import queue as queue_module
import socket
import time
import traceback

import torch
import torch.distributed as dist

from dynmm_tpu_torch.utils.device import resolve_device

COLLECTIVE_S = 1800.0  # a collective's limit in a world without one


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: torch.device, world: int) -> str:
    """NCCL where each rank has a card of its own, else gloo."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, address: str, device,
              timeout: float = 600.0) -> torch.device:
    """Join this process to the world as ``rank``; returns its device."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dist.init_process_group(
        default_backend(device, world), init_method=address,
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return device


def _rank_entry(fn, rank, world, address, device, timeout, inbox,
                results) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    try:
        args = pickle.loads(inbox.get(timeout=timeout))
        init_rank(rank, world, address, device, timeout)
        # plain pickle bytes: a tensor copied, not shared with a process
        # that may exit before it is read
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # noqa: BLE001 (reported; the parent raises it)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), device=None,
              timeout: float | None = 120.0) -> list:
    """``fn(*args)`` on each of ``world`` new ranks (on ``device``: None
    is the card, "cpu" the CPU); their results in rank order."""
    device = str(resolve_device(device).type)
    limit = COLLECTIVE_S if timeout is None else timeout
    ctx = multiprocessing.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, daemon=True, args=(
        fn, rank, world, address, device, limit, inbox, results))
        for rank in range(world)]
    for p in procs:
        p.start()
    payload = pickle.dumps(args)
    for _ in procs:  # through a queue: a process starts without waiting
        inbox.put(payload)  # for the last to read its arguments
    done: dict = {}
    deadline = (math.inf if timeout is None
                else time.monotonic() + timeout)
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world)) - set(done))
                raise RuntimeError(f"ranks {missing} of {world} still running "
                                   f"after {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_module.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died (exit code "
                        f"{procs[dead[0]].exitcode})") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            done[rank] = pickle.loads(value)
        for p in procs:
            p.join(min(max(deadline - time.monotonic(), 1.0), limit))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(world)]
