"""Card checks of the outputs a fused engine keeps between its phases
(``ops/kernels/engine.py`` ``KeptOutputs``), shared by the two engines'
card test files: a phase on a kept output gives, in every row of the
capacity and bit for bit, what a phase on a fresh output gives, and
``out_reuses`` counts the launches that took one cleared to less than the
capacity.  Imports no JAX."""

import torch

from particle_simulation_tpu_torch import SimConfig
from particle_simulation_tpu_torch.cross_section import (
    bundled_paths, load_table,
)
from particle_simulation_tpu_torch.ops.kernels import engine
from particle_simulation_tpu_torch.ops.step import grid_phase
from particle_simulation_tpu_torch.runtime import run_pic
from particle_simulation_tpu_torch.schedulers import _one_step
from particle_simulation_tpu_torch.state import setup_particles

MAGNETIZED_ARGON = dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
                        collision_model="isotropic", boundary="periodic",
                        init_vth=2.0e6)
# the knobs that launch each instantiation
INSTANTIATIONS = {"reference": {}, "general": MAGNETIZED_ARGON,
                  "open": dict(spawn_depth=6)}
# the phase's population against the kept output's mark
POPULATIONS = ("shrink", "grow", "overflow", "zero")
POISON = 0x5A5A5A5A


def config(churn: dict, instantiation: str, **knobs) -> SimConfig:
    cfg = SimConfig(**dict(churn, **knobs), **INSTANTIATIONS[instantiation])
    assert engine.compiled(cfg) == (instantiation != "open")
    assert (engine.model_bits(cfg) != 0) == (instantiation == "general")
    return cfg


def same_bits(a, b) -> bool:
    return a.n == b.n and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a[:6], b[:6]))


def fresh(phase, st, step, table, cfg):
    """The phase on fresh buffers, as a phase that keeps nothing runs."""
    blocks = (0 if engine.compiled(cfg)
              else engine.open_blocks(phase.engine.name, cfg, st.device))
    return phase.run(st, phase.buffers(st, cfg, blocks), step, table, cfg,
                     cfg.poisson_timestep)


def all_dead(st):
    """``st`` with every created row DEAD: a phase of it keeps no row."""
    return st._replace(status=torch.where(
        torch.arange(st.capacity, device=st.device) < st.n_clamped,
        torch.full_like(st.status, -2), st.status))


def check_poisoned_output(phase, mobility, cfg, population, dev):
    """A kept output with poison words in every row below its mark and
    zeros past it: the phase clears what its population leaves of the
    poison and equals the fresh path; one launch counts in
    ``out_reuses``.  The mark lies past the new population (``shrink``),
    below it (``grow``), below an overflowing one (``overflow``) or past
    an empty one (``zero``)."""
    table = load_table(bundled_paths()[1], dev)
    st = grid_phase(setup_particles(cfg, device=dev), cfg)
    if population == "zero":
        st = all_dead(st)
    ref, ref_info = fresh(phase, st, 0, table, cfg)
    c = st.capacity
    mark = {"shrink": min(ref.n + 1000, c - 1), "grow": ref.n // 2,
            "overflow": c // 2, "zero": c // 3}[population]
    assert {"shrink": ref.n < mark, "grow": 0 < mark < ref.n,
            "overflow": ref_info["overflow"], "zero": ref.n == 0}[population]
    out = engine.empty_state(c, dev)
    for t in out[:6]:
        t.zero_()
        t.view(torch.int32)[:mark] = POISON
    kept = engine.KeptOutputs()
    kept.outs.append(engine.Kept(out, mark, engine.versions(out)))
    phase.kept[(dev, torch.cuda.current_stream(dev).cuda_stream)] = kept
    reuses = phase.out_reuses
    got, info = mobility(st, 0, table, cfg, cfg.poisson_timestep)
    assert phase.out_reuses - reuses == 1
    assert info == ref_info
    assert same_bits(got, ref)


def check_held_states(phase, cfg, dev):
    """``run_pic`` with an ``on_step`` that keeps every state: each phase
    takes a fresh output (none counts in ``out_reuses``), no held state
    changes, and each equals the fresh path's state after that step."""
    cfg = cfg.replace(poisson_steps=4, verbose=1)
    table = load_table(bundled_paths()[1], dev)
    phase.kept.clear()
    held = []
    reuses = phase.out_reuses
    run_pic(cfg, table=table, print_header=False, device=dev,
            on_step=lambda t, s: held.append(
                (s, [x.clone() for x in s[:6]])))
    assert phase.out_reuses == reuses
    assert len(held) == cfg.poisson_steps + 1
    st = setup_particles(cfg, device=dev)
    for i, (state, copy) in enumerate(held):
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(state[:6], copy)), i
        assert same_bits(state, st), i
        if i < cfg.poisson_steps:
            st, _ = fresh(phase, grid_phase(st, cfg), i, table, cfg)


def check_in_place_step(phase, mobility, cfg, dev):
    """A naive step that writes an engine's output in place, its children
    appended past the population, then two more phases: the second of them
    takes that output back and clears it to the capacity (its version
    counters moved), so with every row of its input DEAD it gives zeros in
    every row.  Each phase equals the fresh path; none counts in
    ``out_reuses``."""
    table = load_table(bundled_paths()[1], dev)

    def phases(launch):
        snaps = []
        st = grid_phase(setup_particles(cfg, device=dev), cfg)
        st, _ = launch(st, 0)
        n = st.n
        st, _, _ = _one_step(st, 1, 1, table, cfg, False)
        assert st.n > n  # the naive step appended children
        for i, inp in ((1, None), (2, all_dead)):
            st = grid_phase(st, cfg)
            st, info = launch(inp(st) if inp else st, i)
            snaps.append((st.n, [x.clone() for x in st[:6]], info))
        return snaps

    phase.kept.clear()
    reuses = phase.out_reuses
    got = phases(lambda st, i: mobility(st, i, table, cfg,
                                        cfg.poisson_timestep))
    assert phase.out_reuses == reuses
    want = phases(lambda st, i: fresh(phase, st, i, table, cfg))
    assert got[-1][0] == 0
    for (n, xs, info), (m, ys, ref) in zip(got, want):
        assert n == m and info == ref
        assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(xs, ys))
