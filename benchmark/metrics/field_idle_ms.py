"""The device's idle time in the field phase (``ops.step.grid_phase``), in
ms a Poisson step: the window's gaps with no kernel, copy or set running
that overlap the program's ``pst.field`` spans, over the number of those
spans (profiler)."""

import progtrace


def read(r):
    return progtrace.per_span_ms(r.trace, "pst.field", progtrace.idle_s_in)
