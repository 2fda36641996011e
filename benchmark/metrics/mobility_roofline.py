"""The mobility phase's kernels against their roofline, in %: the
phases' least time on the H100 (``bound.phase_bound_s``: operations of
the pushes at 67 TFLOP/s or 48 B a live row in and out at 3.35 TB/s,
whichever is larger) over the device time of every operation that starts
inside the ``bench.mobility`` spans (profiler)."""

import bound


def read(r):
    if r.trace is None or not r.phases:
        return None
    device_s = r.trace.device_s_in("bench.mobility")
    if device_s <= 0:
        return None
    block2 = r.cell.config["rng_mode"] == "block2"
    rounds = r.cell.config["rng_rounds"]
    least = sum(bound.phase_bound_s(p, n_in, n_out, rounds, block2)
                for p, n_in, n_out in r.phases)
    return least / device_s * 100.0
