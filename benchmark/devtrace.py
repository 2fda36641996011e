"""The profiler's view of a traced window: device operations, the host's
annotations and operations, and what follows from them (busy and idle
time, which kernels ran inside which span, the breakdown).

The trace is ``torch.profiler``'s Chrome export, on one clock for host
and device events (microseconds).  The benchmark's own spans are
``record_function`` annotations named ``bench.*``; the whole window is
``bench.window``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
NAME_CHARS = 96


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]               # us, on the trace's clock
    device: List[Tuple[str, float, float]]    # (name, start, end) us
    spans: Dict[str, List[Tuple[float, float]]]  # bench.* annotations
    host: List[Tuple[float, float, str]]      # main thread (start, end, name)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window, in order."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's intervals in which no device operation ran."""
        edges, t = [], self.window[0]
        for s, e in self.busy():
            if s > t:
                edges.append((t, s))
            t = e
        if self.window[1] > t:
            edges.append((t, self.window[1]))
        return edges

    def device_s_in(self, span: str) -> float:
        """Seconds of the device operations that start inside the
        annotations named ``span``."""
        spans = sorted(self.spans.get(span, []))
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.device:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= spans[i][1]:
                total += e - s
        return total * 1e-6

    def top_device_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time in the window, by
        name: [name, seconds]."""
        lo, hi = self.window
        by = collections.Counter()
        for name, s, e in self.device:
            if lo <= s <= hi:
                by[name[:NAME_CHARS]] += (e - s) * 1e-6
        return [[n, v] for n, v in by.most_common(k)]

    def top_idle(self, k: int = 10) -> List[list]:
        """Idle device time by what the host was doing at the middle of
        each gap: the innermost ``bench.*`` span and the deepest host event
        there.  [label, seconds], the largest first."""
        by = collections.Counter()
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) / 2)
        host = self.host
        stack: List[Tuple[float, float, str]] = []
        i = 0
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            spans = [h[2] for h in stack if h[2].startswith("bench.")
                     and h[2] != WINDOW]
            label = spans[-1] if spans else "bench.window"
            if stack and stack[-1][2] != label and stack[-1][2] != WINDOW:
                label += "/" + stack[-1][2][:NAME_CHARS]
            by[label] += (g1 - g0) * 1e-6
        return [[n, v] for n, v in by.most_common(k)]


def read(path: str) -> Trace:
    """Parse a Chrome trace written by ``export_chrome_trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = next(e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name") == WINDOW)
    main = (window.get("pid"), window.get("tid"))
    device, host = [], []
    spans: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((e.get("name", ""), ts, ts + dur))
        elif cat in HOST_CATS and (e.get("pid"), e.get("tid")) == main:
            host.append((ts, ts + dur, e.get("name", "")))
            if cat == "user_annotation" and e["name"].startswith("bench."):
                spans[e["name"]].append((ts, ts + dur))
    host.sort(key=lambda h: (h[0], -h[1]))
    ts = float(window["ts"])
    return Trace((ts, ts + float(window["dur"])), device, dict(spans), host)
