"""What the probes share: CUDA-event timing (warm, and cold past the L2),
the card's name and power limit, and the least time an H100 could take
for a given work."""

from __future__ import annotations

import collections
import subprocess
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

# NVIDIA's data sheet, H100 SXM at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; an FMA counts two
SPIN_CYCLES_PER_S = 2.0e9  # torch.cuda._sleep spins SM clock cycles (1.98 GHz)
MAX_SPIN_S = 1.0
L2_BYTES = 50 * 2**20  # the H100's L2 cache


class Timing(NamedTuple):
    """A probe's timings at its main shape."""
    ms: float                    # the kernel, ms per call
    plain_ms: float              # its plain PyTorch twin on the same inputs
    library_ms: Optional[float]  # one PyTorch call computing the same, if any
    bytes: int                   # each input read once, each output written once
    ops: int                     # arithmetic operations these inputs need
    lines: List[Tuple[str, str]]  # every timing of the probe, labelled
    extra: Optional[dict] = None  # more keys for the probe's kernel line


def bound_terms(n_bytes: float, n_ops: float) -> Tuple[float, float]:
    """ms to move ``n_bytes`` through device memory, and ms to do ``n_ops``
    operations at the float32 rate, on the H100."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least ms the H100 could take for that work, the larger of the two
    terms, and which sets it ("bytes" or "operations")."""
    by_bytes, by_ops = bound_terms(n_bytes, n_ops)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _queued_ms(call: Callable[[int], object], reps: int) -> float:
    """CUDA-event ms per call of ``call(i)``, i = 0 .. reps - 1, queued
    behind a spin kernel that outlasts the host's enqueueing of all of
    them, so the events time the device running them back to back: a call
    of a few microseconds is not timed as the host's Python and launch
    overhead.  A call that waits on the device itself (a readback) cannot
    be queued ahead and is timed with its host work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin_s = min(2 * reps * host_s + 1e-3, MAX_SPIN_S)
    torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(reps):
        call(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_ms(fn: Callable, *args, reps: int = 20) -> float:
    """ms per call of ``fn(*args)`` over ``reps`` calls on the same
    arguments, after one warm-up call (``_queued_ms``).  Warm: inputs and
    outputs that fit the L2 stay there from one call to the next."""
    fn(*args)
    return _queued_ms(lambda i: fn(*args), reps)


def rotation_sets(bytes_per_call: int, l2_bytes: int = L2_BYTES) -> int:
    """How many argument sets a cold timing rotates through: the least
    power of two whose working set, sets x ``bytes_per_call`` (the inputs
    read and the outputs written by one call), exceeds twice the L2."""
    if bytes_per_call <= 0:
        raise ValueError("bytes_per_call must be positive")
    sets = 1
    while sets * bytes_per_call <= 2 * l2_bytes:
        sets *= 2
    return sets


def time_ms_cold(fn: Callable, arg_sets: Sequence[tuple],
                 rounds: int = 3) -> float:
    """ms per call of ``fn`` over ``rounds`` turns through ``arg_sets``
    (``_queued_ms``), after one warm-up turn.  Each call's result is held
    until its set comes round again, so the outputs rotate with the inputs
    and a call finds neither in the L2 when the sets hold more than twice
    it (``rotation_sets``): cold, as a caller that moves on finds them."""
    held = collections.deque(maxlen=len(arg_sets))
    for args in arg_sets:
        held.append(fn(*args))
    n = len(arg_sets)
    return _queued_ms(lambda i: held.append(fn(*arg_sets[i % n])),
                      rounds * n)


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
