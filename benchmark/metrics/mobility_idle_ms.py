"""The device's idle time in the mobility step
(``ops.step.mobility_step``: the engine's buffers, launch, readback), in
ms a Poisson step: the window's gaps with no kernel, copy or set running
that overlap the program's ``pst.mobility`` spans, over the number of
those spans (profiler)."""

import progtrace


def read(r):
    return progtrace.per_span_ms(r.trace, "pst.mobility",
                                 progtrace.idle_s_in)
