"""The port's ``runtime.run_pic`` against the JAX package's, at the size of
tests/test_schedulers.py (150 electrons, capacity 20,000, T=6, grid 32³,
the constant 50/50 table): the final population, the per-step counters and
the sorted particle array (tolerance: exact), the printed lines with the
time masked, the ``on_step`` cadence and the states it is given, the
overflow and "Hit 0" messages, ``first_poisson_index``, and one long
phase (T=200) of the canonical sweep's physics.

JAX ``naive`` is the reference (JAX ``dynamic`` in interpret mode costs a
minute); each of the port's four schedulers is held against it.
"""

import contextlib
import dataclasses
import functools
import io
import re

import numpy as np
import pytest

import particle_simulation_tpu as J
from particle_simulation_tpu import runtime as jrt
from particle_simulation_tpu.cross_section import N_STEPS, bundled_paths, write_table
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.runtime import (
    FUNCTION_NAMES, RunData, multiset_with_ids, run_pic, sorted_particle_array,
)

CFG = SimConfig(
    init_n=150, capacity=20_000, poisson_steps=3, poisson_timestep=6,
    grid_size=(32, 32, 32), cross_section_path=bundled_paths()[1],
    scheduler="naive",
)
SCHEDULERS = ("naive", "sync", "dynamic", "dynamic_old")
TIME = re.compile(r"(time of program: )[0-9.]+( ms)")


def jax_config(cfg: SimConfig) -> J.SimConfig:
    return J.SimConfig(**dataclasses.asdict(cfg))


def masked(text: str) -> list:
    """Printed lines with the times of the end lines masked."""
    return TIME.sub(r"\1<t>\2", text).splitlines()


def printed(fn, *args, **kw):
    """(fn's result, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def counters(run) -> list:
    return [(m.step, m.n, m.added, m.removed, bool(m.overflow), int(m.pushes))
            for m in run.steps]


def j_ids(state) -> np.ndarray:
    """A JAX state's multiset with ids, through interop."""
    arrays = {f: np.asarray(getattr(state, f)) for f in interop.FIELDS}
    return multiset_with_ids(interop.state_from_numpy(arrays, "cpu"))


@functools.lru_cache(maxsize=None)
def jax_run(cfg: SimConfig, print_header: bool = False):
    """JAX run_pic: (run, its stdout)."""
    return printed(jrt.run_pic, jax_config(cfg), print_header=print_header)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_run_pic_matches_jax(scheduler):
    ref, _ = jax_run(CFG)
    assert ref.total_added > 0  # the MCC fired
    run = run_pic(CFG.replace(scheduler=scheduler), print_header=False,
                  device="cpu")
    assert run.final_n == ref.final_n
    assert (run.total_added, run.total_removed) == (ref.total_added,
                                                    ref.total_removed)
    assert counters(run) == counters(ref)
    np.testing.assert_array_equal(sorted_particle_array(run.state),
                                  jrt.sorted_particle_array(ref.state))
    np.testing.assert_array_equal(multiset_with_ids(run.state),
                                  j_ids(ref.state))
    assert run.device_time_ms == pytest.approx(
        sum(m.wall_s for m in run.steps) * 1e3)


def test_long_phases_match_jax():
    """The canonical sweep's physics at a long phase (T=200, the sine
    table, rng_mode perstep, as benchmarks.sweep_configs pins it), cut to
    2000 electrons: the same run as the JAX package's, so the H100's
    departure from the TPU's final n at T >= 200 (chip_smoke.py 8c) is
    not the port's arithmetic against XLA's."""
    cfg = SimConfig(init_n=2000, capacity=20_000, poisson_steps=3,
                    poisson_timestep=200, grid_size=(64, 64, 64),
                    rng_mode="perstep", scheduler="naive")
    ref, _ = jax_run(cfg)
    assert ref.total_added > 100
    run = run_pic(cfg.replace(scheduler="dynamic"), print_header=False,
                  device="cpu")
    assert counters(run) == counters(ref)
    np.testing.assert_array_equal(multiset_with_ids(run.state),
                                  j_ids(ref.state))


def test_printed_lines_match_jax():
    (run, out) = printed(run_pic, CFG, device="cpu")
    _, ref_out = jax_run(CFG, print_header=True)
    assert masked(out) == masked(ref_out)
    assert out.splitlines()[0] == "PIC with"
    assert "Device time of program" in out


def test_overflow_message_matches_jax():
    cfg = SimConfig(init_n=400, capacity=500, poisson_steps=1,
                    poisson_timestep=6, grid_size=(16, 16, 16),
                    cross_section_path=bundled_paths()[1])
    run, out = printed(run_pic, cfg, print_header=False, device="cpu")
    ref, ref_out = jax_run(cfg)
    assert any(m.overflow for m in run.steps)
    assert "OVERFLOW FROM ADDING PARTICLES" in out
    assert masked(out) == masked(ref_out)
    assert counters(run) == counters(ref)


def test_hit_zero_matches_jax(tmp_path):
    path = str(tmp_path / "killer.txt")
    write_table(path, np.tile(np.float32([0.0, 100.0]), (N_STEPS, 1)))
    cfg = CFG.replace(poisson_steps=5, cross_section_path=path)
    run, out = printed(run_pic, cfg, device="cpu")
    ref, ref_out = jax_run(cfg, print_header=True)
    assert run.final_n == 0 and len(run.steps) == 1
    assert "Hit 0" in out
    assert masked(out) == masked(ref_out)


@pytest.mark.parametrize("verbose,steps", [(2, 4), (2, 5), (1, 2), (5, 2),
                                           (0, 2)])
def test_on_step_cadence_matches_jax(verbose, steps):
    """Every ``verbose`` steps, and the end-of-run call only when
    ``poisson_steps % verbose == 0`` (src/pic.cu:561); each call gets the
    state of that step."""
    cfg = CFG.replace(verbose=verbose, poisson_steps=steps)
    seen, ref_seen = [], []
    run_pic(cfg, on_step=lambda t, s: seen.append((t, s.n)),
            print_header=False, device="cpu")
    jrt.run_pic(jax_config(cfg), on_step=lambda t, s: ref_seen.append(
        (t, int(s.n))), print_header=False)
    assert seen == ref_seen
    expected = {(2, 4): [0, 2, 4], (2, 5): [0, 2, 4], (1, 2): [0, 1, 2],
                (5, 2): [0], (0, 2): []}[(verbose, steps)]
    assert [t for t, _ in seen] == expected


def test_first_poisson_index_continues_the_run():
    """Two steps, then two more from that state at Poisson index 2, equal
    four steps in one run (every draw is keyed by the absolute index)."""
    full = run_pic(CFG.replace(poisson_steps=4), print_header=False,
                   device="cpu")
    head = run_pic(CFG.replace(poisson_steps=2), print_header=False,
                   device="cpu")
    tail = run_pic(CFG.replace(poisson_steps=2), print_header=False,
                   initial_state=head.state, first_poisson_index=2,
                   auto_bucket=True)
    assert [m.n for m in head.steps + tail.steps] == [m.n for m in full.steps]
    np.testing.assert_array_equal(multiset_with_ids(tail.state),
                                  multiset_with_ids(full.state))


def test_function_names_match_jax():
    for scheduler, name in FUNCTION_NAMES.items():
        ref = jrt.RunData(config=J.SimConfig(scheduler=scheduler), final_n=0,
                          total_added=0, total_removed=0, device_time_ms=0.0,
                          state=None, steps=[])
        run = RunData(config=CFG.replace(scheduler=scheduler), final_n=0,
                      total_added=0, total_removed=0, device_time_ms=0.0,
                      state=None, steps=[])
        assert run.function == ref.function == name


def test_table_positional_and_initial_state_keep_their_device():
    from particle_simulation_tpu_torch.cross_section import load_table
    from particle_simulation_tpu_torch.state import setup_particles

    table = load_table(CFG.cross_section_path, "cpu")
    st = setup_particles(CFG, device="cpu")
    run = run_pic(CFG.replace(poisson_steps=1), table, None, False, st)
    assert run.state.device.type == "cpu"
