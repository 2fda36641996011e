"""The port's multi-process path (``parallel/sharded.py``, ``parallel/
launch.py``) on gloo ranks on the CPU: the invariants of
tests/test_sharded.py, ported, and the CLI's ``mesh=N``.

Each world size is one spawn of ranks that runs every scenario
(``sharded.run_scenarios``) and hands back the global history, the live
rows gathered to rank 0 and what each rank saw.  Tolerance: exact.
"""

import contextlib
import io

import numpy as np
import pytest

from particle_simulation_tpu_torch.cross_section import bundled_paths
from particle_simulation_tpu_torch import SimConfig, cli
from particle_simulation_tpu_torch.constants import STATUS_ALIVE, STATUS_EMPTY
from particle_simulation_tpu_torch.ops.step import poisson_loop
from particle_simulation_tpu_torch.parallel import launch, sharded
from particle_simulation_tpu_torch.runtime import run_pic
from particle_simulation_tpu_torch.state import setup_particles

CONST = bundled_paths()[1]
# tests/test_sharded.py's CFG: per rank
CFG = SimConfig(init_n=64, capacity=4096, poisson_steps=2, poisson_timestep=5,
                grid_size=(32, 32, 32), cross_section_path=CONST)
# a global workload of 64 electrons, split over the ranks
GLOBAL = CFG.replace(init_n=64, capacity=4096)
# the 62-cell spawn cube fits a 64^3 window inside a 128^3 grid: the slab
# path runs, with halo planes at both ends of inner slabs
SLAB = SimConfig(init_n=64, capacity=2048, poisson_steps=2,
                 poisson_timestep=5, grid_size=(128, 128, 128),
                 cross_section_path=CONST, bbox_subgrid=64, grid_mode="slab")
# the window too small for the cube: the slab mode falls back
FALLBACK = SimConfig(init_n=64, capacity=2048, poisson_steps=1,
                     poisson_timestep=4, grid_size=(64, 64, 64),
                     cross_section_path=CONST, bbox_subgrid=8,
                     grid_mode="slab")
# tests/test_sharded.py's overflow case: a tiny per-rank capacity
OVERFLOW = CFG.replace(poisson_steps=8, capacity=24, init_n=16)
# a global workload of 4 electrons that dies at step 2 of 6
DIES = CFG.replace(init_n=4, poisson_steps=6, seed=2)
WORLD_SIZES = (1, 2, 4)


def scenarios(d: int) -> dict:
    split = GLOBAL.replace(init_n=GLOBAL.init_n // d,
                           capacity=GLOBAL.capacity // d)
    out = {
        "cfg": {"config": CFG},
        "cfg_again": {"config": CFG},
        "global_naive": {"config": split},
        "global_dynamic": {"config": split.replace(scheduler="dynamic")},
        "global_dynamic_old": {
            "config": split.replace(scheduler="dynamic_old")},
        "slab": {"config": SLAB},
        "slab_replicated": {"config": SLAB.replace(grid_mode="replicated")},
        "slab_dynamic": {"config": SLAB.replace(scheduler="dynamic")},
        "fallback": {"config": FALLBACK},
        "fallback_replicated": {
            "config": FALLBACK.replace(grid_mode="replicated")},
        "overflow": {"config": OVERFLOW},
        "dies": {"config": DIES.replace(init_n=DIES.init_n // d,
                                        capacity=DIES.capacity // d)},
    }
    if d > 1:
        out["empty_ranks"] = {"config": CFG, "empty_ranks": list(range(1, d))}
    return out


@pytest.fixture(scope="module")
def runs():
    """{d: {scenario: (rank 0's result, every rank's result)}}."""
    out = {}
    for d in WORLD_SIZES:
        scs = scenarios(d)
        res = launch.run(sharded.run_scenarios, d, args=(list(scs.values()),),
                         device="cpu", timeout_s=240)
        out[d] = {name: (res[0][i], [r[i] for r in res])
                  for i, name in enumerate(scs)}
    return out


def live_rows(arrays) -> np.ndarray:
    """Live rows (numpy, the JAX SimState's types) as sorted int32 rows of
    every field, ids included."""
    rows = np.concatenate(
        [arrays["pos"].view(np.int32), arrays["vel"].view(np.int32),
         arrays["acc"].view(np.int32), arrays["status"][:, None],
         arrays["id_hi"].view(np.int32)[:, None],
         arrays["id_lo"].view(np.int32)[:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_ranks_import_no_jax(runs):
    for d in WORLD_SIZES:
        for _, ranks in runs[d].values():
            for r in ranks:
                assert r["foreign_modules"] == [], (d, r["foreign_modules"])
                assert r["backend"] == "gloo" and r["device"] == "cpu"


@pytest.mark.parametrize("d", [2, 4])
def test_setup_sharded_layout(d):
    """Rank i seeds init_n live slots keyed by the global particle indices
    [i * init_n, (i + 1) * init_n)."""
    ids = []
    for i in range(d):
        mesh = sharded.Mesh(None, i, d, "cpu", "gloo")
        st = sharded.setup_sharded(CFG, mesh)
        assert st.n == CFG.init_n and st.capacity == CFG.capacity
        assert (st.status[:CFG.init_n] == STATUS_ALIVE).all()
        assert (st.status[CFG.init_n:] == STATUS_EMPTY).all()
        ref = setup_particles(CFG.replace(init_n=d * CFG.init_n,
                                          capacity=d * CFG.init_n),
                              device="cpu")
        sl = slice(i * CFG.init_n, (i + 1) * CFG.init_n)
        for name in ("pos", "id_hi", "id_lo"):
            np.testing.assert_array_equal(
                getattr(st, name)[:CFG.init_n].numpy(),
                getattr(ref, name)[sl].numpy())
        ids.append(st.id_lo[:CFG.init_n].numpy())
    assert len(np.unique(np.concatenate(ids))) == d * CFG.init_n


def test_sharded_run_deterministic(runs):
    for d in WORLD_SIZES:
        a, b = runs[d]["cfg"][0], runs[d]["cfg_again"][0]
        assert a["history"] == b["history"]
        assert a["history"][0]["n"] > 0
        np.testing.assert_array_equal(live_rows(a["live"]),
                                      live_rows(b["live"]))


def test_sharded_matches_independent_shards(runs):
    """With the constant table each rank's population follows its own
    genealogy: the global n of each step is the sum of d independent
    single-process runs seeded at the ranks' offsets, and the ids are
    their union."""
    d = 4
    total = np.zeros(CFG.poisson_steps, np.int64)
    ids = []
    for i in range(d):
        st = setup_particles(CFG, slot_offset=i * CFG.init_n, device="cpu")
        st, m = poisson_loop(st, _table(), CFG, CFG.poisson_steps)
        total += np.asarray(m["n"])
        ids.append(st.id_lo[:st.n].numpy())
    got = runs[d]["cfg"][0]
    assert [h["n"] for h in got["history"]] == total.tolist()
    np.testing.assert_array_equal(
        np.sort(got["live"]["id_lo"].view(np.int32)),
        np.sort(np.concatenate(ids)))


def test_charge_counts_every_rank(runs):
    """The live rows gathered from the ranks are the global n."""
    for d in WORLD_SIZES:
        got = runs[d]["cfg"][0]
        assert len(got["live"]["status"]) == got["history"][-1]["n"]
        assert got["final_n"] == got["history"][-1]["n"]
        per_rank = sum(r["n_local"] for r in runs[d]["cfg"][1])
        assert per_rank == got["final_n"]


@pytest.mark.parametrize("scheduler", ["naive", "dynamic", "dynamic_old"])
def test_shard_count_invariance(runs, scheduler):
    """One global workload (64 electrons, capacity 4096) split over 1, 2
    and 4 ranks gives the same sorted multiset with ids and the same
    history, equal to the single-process run_pic on the global config."""
    single = run_pic(GLOBAL.replace(scheduler=scheduler), device="cpu",
                     print_header=False)
    want_hist = [{"n": s.n, "added": s.added, "removed": s.removed,
                  "overflow": int(s.overflow), "pushes": int(s.pushes)}
                 for s in single.steps]
    st = single.state
    want_rows = live_rows({
        "pos": st.pos[:st.n].numpy(), "vel": st.vel[:st.n].numpy(),
        "acc": st.acc[:st.n].numpy(), "status": st.status[:st.n].numpy(),
        "id_hi": st.id_hi[:st.n].numpy(), "id_lo": st.id_lo[:st.n].numpy()})
    assert want_hist[-1]["n"] > 64  # the constant table grows it
    for d in WORLD_SIZES:
        got = runs[d][f"global_{scheduler}"][0]
        assert got["history"] == want_hist, d
        np.testing.assert_array_equal(live_rows(got["live"]), want_rows,
                                      err_msg=f"d={d}")


def test_dead_population_ends_the_run(runs):
    """Once the global population is 0 the run ends, after that step, as
    the single-process run_pic does (every rank stops together)."""
    single = run_pic(DIES, device="cpu", print_header=False)
    want = [(s.n, s.added, s.removed, int(s.pushes)) for s in single.steps]
    assert want[-1][0] == 0 and len(want) < DIES.poisson_steps
    for d in WORLD_SIZES:
        got = runs[d]["dies"][0]
        assert [(h["n"], h["added"], h["removed"], h["pushes"])
                for h in got["history"]] == want, d
        assert got["final_n"] == 0 and len(got["live"]["status"]) == 0


def test_sharded_overflow_accepted(runs):
    """At a tiny per-rank capacity the children beyond it are dropped and
    counted; the run goes on."""
    for d in WORLD_SIZES:
        hist = runs[d]["overflow"][0]["history"]
        first = next(i for i, h in enumerate(hist) if h["overflow"])
        assert any(h["pushes"] > 0 for h in hist[first + 1:]), d


def test_slab_equals_replicated(runs):
    """The slab path (taken at every step) gives the replicated path's
    bits, under naive and dynamic."""
    for d in WORLD_SIZES:
        slab = runs[d]["slab"][0]
        rep = runs[d]["slab_replicated"][0]
        dyn = runs[d]["slab_dynamic"][0]
        for r in runs[d]["slab"][1]:
            assert r["field_paths"]["slab"] == SLAB.poisson_steps, d
        assert rep["field_paths"]["full"] == SLAB.poisson_steps
        assert slab["history"] == rep["history"] == dyn["history"]
        want = live_rows(rep["live"])
        np.testing.assert_array_equal(live_rows(slab["live"]), want)
        np.testing.assert_array_equal(live_rows(dyn["live"]), want)
        comm = slab["comm"]
        S, steps = SLAB.bbox_subgrid, SLAB.poisson_steps
        assert comm["reduce_scatter"][1] == steps * S ** 3 * 4
        assert comm["halo"][1] == steps * 2 * S * S * 4
        assert comm["all_gather"][1] == steps * S ** 3 * 12
        assert "charge" not in comm


def test_slab_fallback_equals_replicated(runs):
    for d in WORLD_SIZES:
        fb, rep = runs[d]["fallback"][0], runs[d]["fallback_replicated"][0]
        assert fb["field_paths"]["window_fallback"] == FALLBACK.poisson_steps
        assert fb["field_paths"]["slab"] == 0
        assert fb["history"] == rep["history"]
        np.testing.assert_array_equal(live_rows(fb["live"]),
                                      live_rows(rep["live"]))


def test_empty_ranks_join_every_step(runs):
    """Ranks that start with no particle still join every collective: the
    run equals the one-rank run of rank 0's particles."""
    one = runs[1]["cfg"][0]
    for d in (2, 4):
        got = runs[d]["empty_ranks"][0]
        assert [r["n_local"] for r in runs[d]["empty_ranks"][1][1:]] == \
            [0] * (d - 1)
        assert got["history"] == one["history"]
        np.testing.assert_array_equal(live_rows(got["live"]),
                                      live_rows(one["live"]))


@pytest.mark.parametrize("bad", [
    dict(bbox_subgrid=12),                       # 12 % 8 != 0
    dict(bbox_subgrid=0),                        # no subgrid
    dict(bbox_subgrid=64, field_model="fft"),    # the neighbour model only
])
def test_slab_rejects_bad_config(bad):
    mesh = sharded.Mesh(None, 0, 8, "cpu", "gloo")
    with pytest.raises(ValueError):
        sharded.sharded_poisson_step(mesh, CFG.replace(grid_mode="slab",
                                                       **bad))


def test_make_mesh_rejects_nccl_on_cpu():
    with pytest.raises(ValueError):
        sharded.make_mesh(1, "cpu", "nccl")


def test_launch_raises_a_rank_error():
    """A rank's exception is raised again in the parent."""
    bad = {"config": CFG.replace(grid_mode="slab", bbox_subgrid=0)}
    with pytest.raises(Exception, match="grid_mode='slab'"):
        launch.run(sharded.run_scenarios, 2, args=([bad],), device="cpu",
                   timeout_s=120)


def _table():
    from particle_simulation_tpu_torch.cross_section import load_table

    return load_table(CONST, "cpu")


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


def test_cli_mesh_equals_single_process():
    argv = ["30", "0", "64", "2", "256", "4096", "0", "5", "grid=32",
            f"cs={CONST}", "platform=cpu"]
    rc2, sharded_lines = _cli(argv + ["mesh=2"])
    rc0, single_lines = _cli(argv + ["mesh=0"])
    assert rc2 == rc0 == 0
    assert sharded_lines[0] == ("PIC sharded over 2 devices: per-shard "
                                "init_n=32 capacity=2048")
    closing = [line for line in single_lines
               if line.startswith(("Final amount", "Particles "))]
    assert len(closing) == 3
    assert sharded_lines[1:4] == closing
    assert sharded_lines[4].startswith("CPU time of program: ")


def test_cli_mesh_above_card_count_exits():
    """On the card each rank needs one: more ranks than cards exit with
    the count and the CPU's way to run them."""
    with pytest.raises(SystemExit, match="platform=cpu"):
        cli.main(["30", "0", "64", "2", "256", "4096", "0", "5", "grid=32",
                  "mesh=64"])
