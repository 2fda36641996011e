"""What the probes share: CUDA-event timing, the card's name and power
limit, and the least time an H100 could take for a given work."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; an FMA counts two
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep spins SM clock cycles (1.98 GHz)
MAX_SPIN_S = 1.0


class Timing(NamedTuple):
    """A probe's timings at its main shape."""
    ms: float                    # the kernel, ms per call
    plain_ms: float              # its plain PyTorch twin on the same inputs
    library_ms: Optional[float]  # one PyTorch call computing the same, if any
    bytes: int                   # each input read once, each output written once
    ops: int                     # arithmetic operations these inputs need
    lines: List[Tuple[str, str]]  # every timing of the probe, labelled


def bound_terms(n_bytes: float, n_ops: float) -> Tuple[float, float]:
    """ms to move ``n_bytes`` through device memory, and ms to do ``n_ops``
    operations at the float32 rate, on the H100."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least ms the H100 could take for that work, the larger of the two
    terms, and which sets it ("bytes" or "operations")."""
    by_bytes, by_ops = bound_terms(n_bytes, n_ops)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_ms(fn: Callable, *args, reps: int = 20) -> float:
    """CUDA-event ms per call of ``fn(*args)`` over ``reps`` calls, after
    one warm-up call.

    The calls are queued behind a spin kernel that outlasts the host's
    enqueueing of all of them, so the events time the device running them
    back to back: a call of a few microseconds is not timed as the host's
    Python and launch overhead.  A call that waits on the device itself (a
    readback) cannot be queued ahead and is timed with its host work."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin_s = min(2 * reps * host_s + 1e-3, MAX_SPIN_S)
    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe times the card: pass a CUDA device")
    return device


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
