"""The program's own spans in a traced window: the ``pst.*`` annotations
that ``particle_simulation_tpu_torch.utils.profiling.span`` records while
the profiler runs (``pst.setup``, ``pst.field``, ``pst.mobility`` and
their parts), read from a ``devtrace.Trace``'s main-thread host events on
the kernels' clock.  A program without them (an older checkout) gives no
spans, and every reader built on this module then returns None.

Run as a script, it makes one traced run of a cell, as ``run.py --trace
1`` does, and prints the result line and then one ``spans`` line: for
each span name its count, mean length, and the device and idle time inside
it, and the window's device and idle time by the innermost span (and, for
idle time, the host event at the middle of each gap)::

    python3 benchmark/progtrace.py --workload <cell> --seed <n> \\
        --seconds <s>
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from devtrace import NAME_CHARS

PREFIX = "pst."
Interval = Tuple[float, float]


def intervals(trace, name: str) -> List[Interval]:
    """The spans named ``name`` that start inside the window, (start, end)
    in microseconds, in order."""
    lo, hi = trace.window
    return sorted((s, e) for s, e, n in trace.host
                  if n == name and lo <= s <= hi)


def count(trace, name: str) -> int:
    return len(intervals(trace, name))


def device_s_in(trace, name: str) -> float:
    """Seconds of the device operations that start inside a span
    ``name`` (spans of one name never nest)."""
    spans = intervals(trace, name)
    starts = [s for s, _ in spans]
    total = 0.0
    for _, s, e in trace.device:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            total += e - s
    return total * 1e-6


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """Microseconds in which an interval of ``a`` and one of ``b`` overlap,
    each list sorted and free of overlaps within itself."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s_in(trace, name: str) -> float:
    """Seconds of the window's device-idle gaps that overlap a span
    ``name``."""
    return _overlap(trace.gaps(), intervals(trace, name)) * 1e-6


def per_span_ms(trace, name: str, seconds) -> Optional[float]:
    """``seconds(trace, name)`` over the number of spans ``name``, in ms;
    None without a trace or without such a span."""
    if trace is None:
        return None
    n = count(trace, name)
    return seconds(trace, name) / n * 1e3 if n else None


def segments(trace) -> List[Tuple[float, float, str]]:
    """The window cut into (start, end, name) pieces by the innermost
    ``pst.*`` span over each; time under no span has no piece."""
    spans = sorted(((s, e, n) for s, e, n in trace.host
                    if n.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []

    def close(until: float, now: float) -> float:
        """Pop the spans that end by ``until``, each one's piece from
        ``now`` to its end; the time reached."""
        while stack and stack[-1][1] <= until:
            _, e, n = stack.pop()
            if e > now:
                out.append((now, e, n))
            now = max(now, e)
        return now

    now = 0.0
    for s, e, n in spans:
        now = close(s, now)
        if stack and s > now:
            out.append((now, s, stack[-1][2]))
        stack.append((s, e, n))
        now = s
    close(float("inf"), now)
    return out


def breakdown(trace, k: int = 30) -> Dict[str, object]:
    """What the spans hold in the window: per span name its count, mean
    length, and the device and idle time inside it (``*_ms`` a span,
    inclusive of the spans inside it); device and idle seconds by the
    innermost span (``none`` outside every span); idle seconds by the
    innermost span and the deepest host event at each gap's middle, the
    ``k`` largest."""
    names = sorted({n for _, _, n in trace.host if n.startswith(PREFIX)})
    spans = {}
    for n in names:
        iv = intervals(trace, n)
        if iv:
            spans[n] = {
                "count": len(iv),
                "span_ms": sum(e - s for s, e in iv) / len(iv) * 1e-3,
                "device_ms": device_s_in(trace, n) / len(iv) * 1e3,
                "idle_ms": idle_s_in(trace, n) / len(iv) * 1e3}
    seg = segments(trace)
    starts = [s for s, _, _ in seg]

    def at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return seg[i][2] if i >= 0 and t < seg[i][1] else "none"

    device = collections.Counter()
    lo, hi = trace.window
    for _, s, e in trace.device:
        if lo <= s <= hi:
            device[at(s)] += (e - s) * 1e-6
    idle = collections.Counter()
    gaps = trace.gaps()
    for g0, g1 in gaps:
        inside = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(seg) and seg[i][0] < g1:
            part = min(g1, seg[i][1]) - max(g0, seg[i][0])
            if part > 0:
                idle[seg[i][2]] += part * 1e-6
                inside += part
            i += 1
        if g1 - g0 > inside:
            idle["none"] += (g1 - g0 - inside) * 1e-6
    return {"spans": spans,
            "device_s_by_innermost": dict(device.most_common()),
            "idle_s_by_innermost": dict(idle.most_common()),
            "idle_s_by_host_event": _idle_by_host_event(trace, gaps, at, k)}


def _idle_by_host_event(trace, gaps, at, k: int) -> List[list]:
    """Idle seconds by ``<innermost span>/<deepest host event>`` at each
    gap's middle: [label, seconds], the largest first."""
    by = collections.Counter()
    host = [h for h in trace.host if not h[2].startswith(PREFIX)
            and not h[2].startswith("bench.")]
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = at(mid)
        if stack:
            label += "/" + stack[-1][2][:NAME_CHARS]
        by[label] += (g1 - g0) * 1e-6
    return [[n, v] for n, v in by.most_common(k)]


def main(argv=None) -> int:
    import json
    import sys
    import time

    t_start = time.perf_counter()
    import run
    import harness

    args = run.parse(argv)
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    kept = []
    read_trace = harness._read_trace

    def keep(prof):
        kept.append(read_trace(prof))
        return kept[-1]

    harness._read_trace = keep
    result = harness.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              t_start)
    print(json.dumps(result))
    if kept:
        print(json.dumps({"spans": breakdown(kept[0])}))
    sys.stdout.flush()
    return 0 if kept else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
