"""The field phase (``ops.step.grid_phase``) in device ms a Poisson step:
the device time of the operations that start inside the program's
``pst.field`` spans, over the number of those spans (profiler)."""

import progtrace


def read(r):
    return progtrace.per_span_ms(r.trace, "pst.field", progtrace.device_s_in)
