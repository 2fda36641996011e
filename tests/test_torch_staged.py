"""The staged engine (scheduler ``dynamic_old``, ops/kernels/push_mcc.py) on
the CPU against the JAX package's: its status encodings, one sweep pass
against ``_sweep_pass`` (the Pallas kernel in interpret mode, as the JAX
package runs it on the CPU), whole Poisson steps against JAX
``dynamic_old`` and JAX ``naive``, and the staged reclaim against
``_staged_reclaim_jit``; then what the kernel's design rests on: the
self-compacting protocol, the running DEAD count, the scratch sizes and
the wrapper's checks.  Tolerance: exact (bit patterns, ids, counters).
Kernel-vs-plain on the card: tests/test_torch_staged_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.cross_section import load_table as j_load
from particle_simulation_tpu.ops.pallas import push_mcc as jpm
from particle_simulation_tpu.ops.step import grid_phase as j_grid
from particle_simulation_tpu.ops.step import poisson_step as j_step
from particle_simulation_tpu.runtime import sorted_particle_array as j_sorted
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.constants import STATUS_DEAD, STATUS_EMPTY
from particle_simulation_tpu_torch.cross_section import load_table
from particle_simulation_tpu_torch.ops.kernels import build
from particle_simulation_tpu_torch.ops.kernels import push_mcc as tpm
from particle_simulation_tpu_torch.ops.step import grid_phase, poisson_step
from particle_simulation_tpu_torch.runtime import (
    multiset_with_ids, sorted_particle_array,
)
from particle_simulation_tpu_torch.schedulers import pushes_info
from particle_simulation_tpu_torch.state import setup_particles

from test_torch_step import (
    KEYS, SIZES, TABLES, _assert_same, _jax_run, _port_run,
)

SMALL = SIZES["small"]


def _j_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in interop.FIELDS}


def test_finished_and_suspended_encodings_match():
    stamps = np.arange(-1, 32766, dtype=np.int32)
    fin = np.asarray(jpm._encode_finished(stamps))
    t_stamps = torch.from_numpy(stamps)
    t_fin = tpm._encode_finished(t_stamps)
    np.testing.assert_array_equal(t_fin.numpy(), fin)
    assert tpm._is_finished(t_fin).all() and np.asarray(jpm._is_finished(fin)).all()
    np.testing.assert_array_equal(tpm._decode_finished(t_fin).numpy(), stamps)
    assert not tpm._is_unfinished(t_fin).any()
    for resume in (1, 2, 101, 32766):
        sus = np.asarray(jpm._encode_suspended(resume, stamps))
        t_sus = tpm._encode_suspended(resume, t_stamps)
        np.testing.assert_array_equal(t_sus.numpy(), sus)
        assert tpm._is_suspended(t_sus).all() and not tpm._is_finished(t_sus).any()
        np.testing.assert_array_equal(tpm._suspended_stamp(t_sus).numpy(), stamps)
        assert (tpm._suspended_resume(t_sus) == resume).all()
    assert tpm._FIN_BASE == jpm._FIN_BASE
    assert f"-DPST_FIN_BASE={tpm._FIN_BASE}" in build.nvcc_flags()


@pytest.mark.parametrize("depth", [1, 2])
def test_one_pass_matches_jax_sweep_pass(depth):
    """Three passes, each from the same fields: every field of the rows
    below n (dead rows included: both leave a lane as the step that killed
    it moved it), the valid staged children in depth-major then slot order,
    and the push count."""
    jcfg = J.SimConfig(**SMALL, scheduler="dynamic_old", spawn_depth=depth)
    jt = j_load(bundled_paths()[1])
    js = jax.jit(j_grid, static_argnames="config")(J.setup_particles(jcfg),
                                                   config=jcfg)
    _, c, window, padded = jpm._staged_layout(js, jcfg)
    fields, jn = jpm._state_to_fields(js, padded), js.n
    scalars = jnp.asarray([0, SMALL["poisson_timestep"]], jnp.int32)

    cfg = SimConfig(**SMALL, scheduler="dynamic_old", spawn_depth=depth)
    stack = tpm.state_to_stack(interop.state_from_numpy(_j_numpy(js), "cpu"))
    table = load_table(bundled_paths()[1], "cpu")
    n = int(jn)
    for p in range(3):
        new_fields, children, pushes = jpm._sweep_pass(
            fields, jt, scalars, jcfg, padded)
        flat = np.stack([np.asarray(f).reshape(-1).view(np.int32)
                         for f in new_fields])
        valid = (np.asarray(children[9]) > 0).reshape(-1)
        staged = np.stack([np.asarray(f).reshape(-1).view(np.int32)[valid]
                           for f in children])
        n_old = n
        tot = tpm.staged_pass_plain(stack, n, table, cfg, 0,
                                    SMALL["poisson_timestep"])
        n = tot.n
        np.testing.assert_array_equal(stack[:, :n_old].numpy(),
                                      flat[:, :n_old], err_msg=f"pass {p}")
        np.testing.assert_array_equal(stack[:, n_old:n].numpy(), staged,
                                      err_msg=f"pass {p} children")
        assert tot.children == tot.appended == staged.shape[1] > 0
        assert tot.pushes == int(pushes[0]) + (int(pushes[1]) << 30)
        assert tot.reclaimed == 0
        fields, jn = jpm._append_staged(new_fields, jn, children, c, window)
        assert int(jn) == n


@pytest.mark.parametrize("depth", [2, 1])
@pytest.mark.parametrize("table", ["const", "sine"])
def test_dynamic_old_matches_jax_dynamic_old(table, depth):
    """Two Poisson steps against JAX ``dynamic_old`` itself (the Pallas
    engine in interpret mode, a few seconds a case)."""
    jcfg = J.SimConfig(**SMALL, scheduler="dynamic_old", spawn_depth=depth)
    jt = j_load(bundled_paths()[TABLES[table]])
    js = J.setup_particles(jcfg)
    cfg = SimConfig(**SMALL, scheduler="dynamic_old", spawn_depth=depth)
    t = load_table(bundled_paths()[TABLES[table]], "cpu")
    ts = setup_particles(cfg, device="cpu")
    for s in range(2):
        js, jm = j_step(js, jnp.uint32(s), jt, jcfg)
        ts, tm = poisson_step(ts, s, t, cfg)
        for k in tm:
            assert int(jm[k]) == int(tm[k]), (s, k)
        np.testing.assert_array_equal(j_sorted(js), sorted_particle_array(ts))
        np.testing.assert_array_equal(
            multiset_with_ids(interop.state_from_numpy(_j_numpy(js), "cpu")),
            multiset_with_ids(ts),
        )


@pytest.mark.parametrize("depth", [2, 1])
def test_dynamic_old_matches_jax_naive(depth):
    cfg = SimConfig(**SIZES["mid"], scheduler="dynamic_old", spawn_depth=depth)
    ref = _jax_run("mid", "const")
    assert sum(m["added"] for m, _, _ in ref) > 0
    _assert_same(_port_run(cfg, "const"), ref)


def test_dynamic_old_reclaims_where_naive_overflows():
    """At capacity 16,384 the staged host loop reclaims dead rows before an
    append that would not fit, never overflows, and equals the unclamped
    naive run at 65,536."""
    cfg = SimConfig(**dict(SIZES["mid"], capacity=16384),
                    scheduler="dynamic_old")
    reclaimed = []

    def phase(*args):
        state, info = tpm.mobility_phase_dynamic(*args)
        reclaimed.append(info["reclaimed"])
        return state, info

    phase.self_compacting = tpm.mobility_phase_dynamic.self_compacting
    t = load_table(bundled_paths()[1], "cpu")
    state = setup_particles(cfg, device="cpu")
    port = []
    for s in range(3):
        state, m = poisson_step(state, s, t, cfg, phase=phase)
        port.append(({k: int(m[k]) for k in KEYS}, sorted_particle_array(state),
                     multiset_with_ids(state)))
    assert sum(reclaimed) > 0
    assert not any(m["overflow"] for m, _, _ in port)
    _assert_same(port, _jax_run("mid", "const"))


def test_staged_reclaim_keeps_encodings():
    """DEAD and EMPTY rows below n go; unfinished (-1, stamps), suspended
    and finished statuses stay verbatim and in order, as in JAX
    ``_staged_reclaim_jit``.  ``population.reclaim`` would drop the
    suspended and finished rows."""
    statuses = [-1, STATUS_DEAD, 7, STATUS_EMPTY, tpm._encode_suspended(3, 2),
                tpm._encode_finished(-1), STATUS_DEAD, 3,
                tpm._encode_finished(5), -1]
    c, n = 256, len(statuses)
    rng = np.random.default_rng(0)
    rows = rng.integers(-2**31, 2**31, size=(12, c), dtype=np.int64)
    rows = rows.astype(np.int32)
    rows[9] = STATUS_EMPTY
    rows[9, :n] = statuses
    rows[:, n:] = 0
    stack = torch.from_numpy(rows.copy())
    n_new, reclaimed = tpm.staged_reclaim(stack, n)
    keep = [i for i, s in enumerate(statuses)
            if s not in (STATUS_DEAD, STATUS_EMPTY)]
    assert (n_new, reclaimed) == (len(keep), n - len(keep))
    np.testing.assert_array_equal(stack[:, :n_new].numpy(), rows[:, keep])
    assert not stack[:, n_new:].any()

    jcfg = J.SimConfig(capacity=c)
    fields = tuple(
        jnp.asarray(rows[i].view(np.float32) if i < 9 else
                    rows[i].view(np.uint32) if i >= 10 else rows[i]
                    ).reshape(c // 128, 128)
        for i in range(12)
    )
    out, jn, jr = jpm._staged_reclaim_jit(
        fields, jnp.int32(n), config=jcfg, capacity=c, window=c,
        padded_capacity=c)
    assert (int(jn), int(jr)) == (n_new, reclaimed)
    np.testing.assert_array_equal(
        np.stack([np.asarray(f).reshape(-1).view(np.int32) for f in out]),
        stack.numpy())


def test_cpu_state_takes_the_plain_version():
    cfg = SimConfig(**SMALL, scheduler="dynamic_old")
    t = load_table(bundled_paths()[1], "cpu")
    st = grid_phase(setup_particles(cfg, device="cpu"), cfg)
    before = tpm.staged_phase.launches
    a, ai = tpm.mobility_phase_dynamic(st, 0, t, cfg, 6)
    b, bi = tpm.mobility_phase_dynamic_plain(st, 0, t, cfg, 6)
    assert tpm.staged_phase.launches == before
    assert ai == bi and a.n == b.n and ai["added"] > 0
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
    assert tpm.mobility_phase_dynamic.self_compacting
    assert tpm.mobility_phase_dynamic_plain.self_compacting
    with pytest.raises(ValueError, match="no staged engine"):
        tpm.mobility_phase_dynamic(setup_particles(cfg, device="meta"), 0,
                                   None, cfg, 6)


def test_stamp_domain_is_checked():
    cfg = SimConfig(**SMALL, scheduler="dynamic_old")
    st = grid_phase(setup_particles(cfg, device="cpu"), cfg)
    with pytest.raises(ValueError, match="stamp domain"):
        tpm.mobility_phase_dynamic(st, 0, load_table(device="cpu"), cfg,
                                   32766)


CHURN_RECLAIM = dict(SIZES["mid"], capacity=16384)


def test_plain_phase_is_compact_of_the_fixed_point():
    """The self-compacting plain phase equals ``population.compact`` of the
    host fixed point's decoded output, bit for bit, and ``poisson_step``
    gives the same metrics (added and removed with the reclaimed rows
    folded in) through either protocol.  Capacity 16,384: reclaims."""
    cfg = SimConfig(**CHURN_RECLAIM, scheduler="dynamic_old")
    t = load_table(bundled_paths()[1], "cpu")
    reclaimed = []

    def uncompacted(*args):
        st, c = tpm.staged_fixed_point(*args)
        reclaimed.append(c["reclaimed"])
        return st, {"reclaimed": c["reclaimed"], **pushes_info(c["pushes"])}

    a = b = setup_particles(cfg, device="cpu")
    for s in range(2):
        a, am = poisson_step(a, s, t, cfg, phase=uncompacted)
        b, bm = poisson_step(b, s, t, cfg,
                             phase=tpm.mobility_phase_dynamic_plain)
        assert am == bm, s
        assert a.n == b.n
        assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6])), s
    assert sum(reclaimed) > 0


def test_running_dead_count_equals_recount():
    """The kernel tests its reclaim rule on a running DEAD count: the
    input's, plus each pass's new deaths, 0 after a reclaim.  Over the
    plain passes of a phase with reclaims it equals the recount of DEAD
    rows below min(n, C) after every pass."""
    cfg = SimConfig(**CHURN_RECLAIM, scheduler="dynamic_old")
    t = load_table(bundled_paths()[1], "cpu")
    st = grid_phase(setup_particles(cfg, device="cpu"), cfg)
    stack, n = tpm.state_to_stack(st), st.n

    def recount():
        return int((stack[9, :min(n, cfg.capacity)] == STATUS_DEAD).sum())

    dead, reclaims, passes = recount(), 0, 0
    while True:
        tot = tpm.staged_pass_plain(stack, n, t, cfg, 0, cfg.poisson_timestep)
        n, passes = tot.n, passes + 1
        dead = 0 if tot.reclaimed else dead + tot.died
        reclaims += tot.reclaimed > 0
        assert dead == recount(), passes
        if not (tot.suspended or tot.appended):
            break
    assert reclaims > 0 and passes > 2


@pytest.mark.parametrize("capacity,depth", [
    (2_000_000, 2),  # the main path
    (4096, 1),
    (1000, 4),
    (384, 3),
])
def test_staged_scratch_shapes(capacity, depth):
    """Two record stacks, two sets of staging regions of C children a
    depth, two work lists, three rotating look-back regions (a ticket, a
    counter, then a word per stream and sweep tile: one stream a depth and
    one for the suspended lanes) and the eight result words."""
    tiles = -(-capacity // tpm.STAGED_TILE)
    assert (tiles - 1) * tpm.STAGED_TILE < capacity <= tiles * tpm.STAGED_TILE
    cfg = SimConfig(spawn_depth=depth)
    assert tpm.staged_scratch_shapes(cfg, capacity) == {
        "stacks": ((2, 12, capacity), torch.int32),
        "stage": ((2, depth, 12, capacity), torch.int32),
        "list": ((2, capacity), torch.int32),
        "lookback": ((3, 2 + (depth + 1) * tiles), torch.int64),
        "result": ((8,), torch.int64),
    }
    flags = build.nvcc_flags()
    for name, value in (("TILE", tpm.STAGED_TILE), ("ITEMS", tpm.SCAN_ITEMS),
                        ("REGIONS", tpm.STAGED_REGIONS),
                        ("HEADER", tpm.REGION_HEADER),
                        ("RESULT_WORDS", len(tpm.STAGED_RESULT))):
        assert f"-DPST_STAGED_{name}={value}" in flags
