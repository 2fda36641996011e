"""Profiling / tracing (counterpart of
``particle_simulation_tpu/utils/profiling.py``).

Reference equivalents (SURVEY.md §5.1): the nsys wrapper (`report:1`) and
CUDA events around the sim loop (src/pic.cu:374-376, 570-572).  Here: a
``torch.profiler`` trace exported for chrome://tracing or Perfetto, and
the program's own spans in it.

An operator traces a run with::

    from particle_simulation_tpu_torch import runtime
    from particle_simulation_tpu_torch.utils import profiling

    with profiling.trace("out/trace"):
        runtime.run_pic(config)

which writes one Chrome trace (open it in Perfetto) holding the card's
kernels and copies and, on the same clock, the program's layers as
``user_annotation`` spans named ``pst.*``: ``pst.run`` around the call,
``pst.setup`` and its draws, then per Poisson step ``pst.step`` with the
field phase (``pst.field`` and its window, deposit, stencil, gather, store
and two readbacks), the mobility phase (``pst.mobility``: on the card its
buffers, launch and readback, and inside the launch ``pst.mobility.general``
where the engines' general instantiation runs) and ``pst.sync``.  A span nests inside the
one that encloses it in time; the trace's idle gaps fall inside the span
that held the host.  Any ``torch.profiler`` session records the spans, not
only this one's.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# what ``span`` gives while no profiler records: one shared no-op
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its body as the span ``name`` in the
    trace of a recording ``torch.profiler`` session (a
    ``record_function``), and does nothing otherwise: the cost of one
    check of the profiler's own flag.  It synchronises nothing and
    allocates nothing on the device."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def span_if(cond: bool, name: str):
    """``span(name)`` where ``cond`` holds, else the shared no-op: a span
    that only some calls record, at the cost of one branch in the others."""
    return span(name) if cond else _OFF


@contextlib.contextmanager
def trace(log_dir: str = "out/trace"):
    """Profile the body (the CPU, and the card when there is one) and write
    a Chrome trace into ``log_dir``: ``with profiling.trace(): run_pic(cfg)``.
    Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
