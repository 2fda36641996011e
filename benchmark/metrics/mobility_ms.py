"""The mobility phase with its compaction (``ops.step.mobility_step``) in
ms a Poisson step: host clock from a synchronise to a synchronise around
each call: the window's total over its steps, divided by the steps."""


def read(r):
    spans = r.spans.get("mobility")
    return sum(spans) / len(spans) * 1e3 if spans else None
