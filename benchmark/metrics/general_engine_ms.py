"""The engines' general instantiation in ms a Poisson step: the device
time of the window's ``worklog_phase`` and ``staged_phase`` kernels whose
last template argument, GENERAL, is true, over the number of the
program's ``pst.mobility.general`` spans (one a launch of the general
instantiation; profiler).  None where the program records no such span."""

import re

import progtrace

GENERAL = re.compile(r"\b(worklog_phase|staged_phase)<[^<>]*,\s*true>")


def read(r):
    if r.trace is None:
        return None
    n = progtrace.count(r.trace, "pst.mobility.general")
    if not n:
        return None
    lo, hi = r.trace.window
    device_s = sum(e - s for name, s, e in r.trace.device
                   if lo <= s <= hi and GENERAL.search(name)) * 1e-6
    return device_s / n * 1e3
