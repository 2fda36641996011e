"""Values the field phase read back to the host, a Poisson step: the
change of ``ops.grid.field_counts.readbacks`` over the window."""


def read(r):
    steps = len(r.spans.get("field", ()))
    if not steps or "field.readbacks" not in r.counters:
        return None
    return r.counters["field.readbacks"] / steps
