"""``state.setup_particles`` in ms an episode: the device time of the
operations that start inside the program's ``pst.setup`` spans, over the
number of those spans (profiler)."""

import progtrace


def read(r):
    return progtrace.per_span_ms(r.trace, "pst.setup", progtrace.device_s_in)
