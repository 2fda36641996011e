"""Start the ranks of a multi-process run (no JAX counterpart: JAX drives
every device from one process, torch.distributed runs a process a rank).

``run(fn, world_size, args)`` spawns ``world_size`` processes with
``torch.multiprocessing.start_processes(start_method="spawn")``; rank i
makes its ``sharded.Mesh`` through a ``file://`` rendezvous in a fresh
temporary directory (so concurrent runs never share a port), calls
``fn(mesh, *args)`` and hands the result back.  ``fn`` must be a function
of this package, importable by name: a child imports nothing else of the
caller's.  The run is bounded: a collective that hangs fails after the
group's timeout, and the whole run after ``timeout_s``; a rank's
exception is raised again in the parent.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve
from .sharded import DEFAULT_TIMEOUT_S, make_mesh


def _rank_main(rank, fn, args, world_size, device, backend, init_method,
               out_dir, timeout_s):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh = make_mesh(world_size, device, backend, rank=rank,
                     init_method=init_method, timeout_s=timeout_s)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, args=(), *, device=None, backend=None,
        timeout_s: float = 300.0) -> list:
    """``fn(mesh, *args)`` on ``world_size`` ranks; returns each rank's
    result in rank order.  ``device`` is the card when None
    (device.resolve); ``backend`` as ``sharded.make_mesh`` takes it.  On a
    card the kernels are built here, once, before any rank starts."""
    device = resolve(device)
    if device.type == "cuda":
        from ..ops.kernels import build

        build.load()
    with tempfile.TemporaryDirectory(prefix="pst_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, tuple(args), world_size, str(device), backend,
                  init_method, tmp, DEFAULT_TIMEOUT_S),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            # join raises a rank's exception (and ends the other ranks)
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks still running after "
                        f"{timeout_s:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
