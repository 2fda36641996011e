"""Faults planted in the program under test, each of which the comparison
must reject (``control.py`` reads them on the card, the tests on the CPU).

* ``unchanged``: the mobility phase returns its state as it came, with
  counters that claim every lane moved and nothing spawned or died;
* ``half``: the mobility phase advances only the first half of the rows
  and hands the rest on untouched;
* ``altered``: one bit of one particle's velocity flips in the final
  state, where ``runtime.run_pic`` produces it.

There is no exchange between chips to leave out: every cell takes one.
Each fault is a context manager that patches the port's module attributes
and restores them on exit; build the program inside it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    from particle_simulation_tpu_torch.ops import step

    def mobility_step(state, poisson_index, table, config, phase=None):
        pushes = state.n * config.poisson_timestep
        return state, {"n": state.n, "added": 0, "removed": 0,
                       "overflow": False, "pushes_lo": pushes % (1 << 30),
                       "pushes_hi": pushes >> 30}

    return _patched(step, "mobility_step", mobility_step)


def half():
    from particle_simulation_tpu_torch.ops import step

    real = step.mobility_step

    def mobility_step(state, poisson_index, table, config, phase=None):
        n = state.n_clamped
        k = n // 2
        out, m = real(state._replace(n=k), poisson_index, table, config,
                      phase)
        rest = slice(k, n)
        dst = slice(out.n, out.n + n - k)
        for new, old in zip(out[:6], state[:6]):
            new[dst] = old[rest]
        m = dict(m, n=out.n + n - k)
        return out._replace(n=out.n + n - k), m

    return _patched(step, "mobility_step", mobility_step)


def altered():
    from particle_simulation_tpu_torch import runtime

    real = runtime.run_pic

    def run_pic(*args, **kw):
        run = real(*args, **kw)
        if run.state.n:
            bits = run.state.vel[:1, :1].view(torch.int32)
            bits ^= 1
        return run

    return _patched(runtime, "run_pic", run_pic)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
