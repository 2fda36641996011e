"""The port's sharded run (gloo ranks on the CPU) against the JAX
package's ``run_pic_sharded`` on ``make_mesh(d)`` (conftest's virtual CPU
devices), for d = 1, 2 and 4, on tests/test_sharded.py's configurations:
the sorted live rows with ids and the per-step history, exact.

JAX ``naive`` is the reference (its ``dynamic`` runs the Pallas kernel in
interpret mode, a minute a mesh size: that comparison is marked slow); the
port's ``naive`` and ``dynamic`` are held against it, as the parity
contract holds every scheduler to the same multiset.  The replicated
field, the slab field (taken) and its fallback are covered; JAX's own slab
test at ``bbox_subgrid=40`` on 64³ falls back too, since the 62-cell
spawn cube does not fit a 40-cell window, so the slab path itself is held
at 64 on 128³.
"""

import dataclasses

import numpy as np
import pytest

import particle_simulation_tpu as J
from particle_simulation_tpu.parallel import sharded as jsharded
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.cross_section import bundled_paths
from particle_simulation_tpu_torch.parallel import launch, sharded

CONST = bundled_paths()[1]
CFG = SimConfig(init_n=64, capacity=4096, poisson_steps=2, poisson_timestep=5,
                grid_size=(32, 32, 32), cross_section_path=CONST)
CASES = {
    # tests/test_sharded.py:18-25
    "replicated": CFG,
    # tests/test_sharded.py:207-221 (the window does not fit: fallback)
    "slab40": SimConfig(init_n=64, capacity=2048, poisson_steps=2,
                        poisson_timestep=5, grid_size=(64, 64, 64),
                        cross_section_path=CONST, bbox_subgrid=40,
                        grid_mode="slab"),
    # the slab path taken at every step
    "slab64": SimConfig(init_n=64, capacity=2048, poisson_steps=2,
                        poisson_timestep=5, grid_size=(128, 128, 128),
                        cross_section_path=CONST, bbox_subgrid=64,
                        grid_mode="slab"),
    # tests/test_sharded.py:224-238
    "fallback8": SimConfig(init_n=64, capacity=2048, poisson_steps=1,
                           poisson_timestep=4, grid_size=(64, 64, 64),
                           cross_section_path=CONST, bbox_subgrid=8,
                           grid_mode="slab"),
}
WORLD_SIZES = (1, 2, 4)
SCHEDULERS = ("naive", "dynamic")


def jax_config(cfg: SimConfig) -> J.SimConfig:
    return J.SimConfig(**dataclasses.asdict(cfg))


def rows_of(arrays) -> np.ndarray:
    """Live rows as sorted int32 rows of every field, ids included."""
    st = np.asarray(arrays["status"])
    live = (st == -1) | (st > 0)
    rows = np.concatenate(
        [np.asarray(arrays["pos"])[live].view(np.int32),
         np.asarray(arrays["vel"])[live].view(np.int32),
         np.asarray(arrays["acc"])[live].view(np.int32),
         st[live][:, None],
         np.asarray(arrays["id_hi"])[live].view(np.int32)[:, None],
         np.asarray(arrays["id_lo"])[live].view(np.int32)[:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def jax_run(cfg: SimConfig, d: int):
    state, hist = jsharded.run_pic_sharded(jax_config(cfg),
                                           jsharded.make_mesh(d))
    return rows_of({f: np.asarray(getattr(state, f))
                    for f in ("pos", "vel", "acc", "status", "id_hi",
                              "id_lo")}), hist


@pytest.fixture(scope="module")
def port():
    """{(d, case, scheduler): rank 0's result}, one spawn a world size."""
    out = {}
    for d in WORLD_SIZES:
        keys = [(case, s) for case in CASES for s in SCHEDULERS]
        scs = [{"config": CASES[c].replace(scheduler=s)} for c, s in keys]
        res = launch.run(sharded.run_scenarios, d, args=(scs,), device="cpu",
                         timeout_s=240)
        for i, (c, s) in enumerate(keys):
            out[(d, c, s)] = res[0][i]
    return out


@pytest.mark.parametrize("d", WORLD_SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_equals_jax(port, case, d):
    want_rows, want_hist = jax_run(CASES[case], d)
    assert want_hist[-1]["n"] > 0
    for s in SCHEDULERS:
        got = port[(d, case, s)]
        assert got["history"] == want_hist, (s, got["history"], want_hist)
        np.testing.assert_array_equal(rows_of(got["live"]), want_rows,
                                      err_msg=f"{s} d={d}")
    paths = port[(d, case, "naive")]["field_paths"]
    steps = CASES[case].poisson_steps
    if case == "slab64":
        assert paths["slab"] == steps
    elif case != "replicated":
        assert paths["window_fallback"] == steps


@pytest.mark.parametrize("d", [2, 4])
def test_shard_split_of_jax_setup(d):
    """interop.shard_from_numpy splits JAX's setup_sharded into each
    rank's state, equal bit for bit to the port's setup_sharded."""
    st = jsharded.setup_sharded(jax_config(CFG), jsharded.make_mesh(d))
    arrays = {f: np.asarray(getattr(st, f)) for f in interop.FIELDS}
    for i in range(d):
        got = interop.shard_from_numpy(arrays, i, d, device="cpu")
        mesh = sharded.Mesh(None, i, d, "cpu", "gloo")
        want = sharded.setup_sharded(CFG, mesh)
        assert got.n == want.n == CFG.init_n
        for f in interop.FIELDS[:-1]:
            assert np.array_equal(getattr(got, f).numpy(),
                                  getattr(want, f).numpy()), (i, f)
    with pytest.raises(ValueError):
        interop.shard_from_numpy(arrays, 0, d + 1, device="cpu")


@pytest.mark.slow
@pytest.mark.parametrize("d", WORLD_SIZES)
def test_sharded_dynamic_equals_jax_dynamic(d):
    """JAX's ``dynamic`` (the Pallas work-log kernel in interpret mode, per
    shard) against the port's ``dynamic``: about a minute a mesh size."""
    cfg = CFG.replace(scheduler="dynamic")
    want_rows, want_hist = jax_run(cfg, d)
    res = launch.run(sharded.run_scenarios, d, args=([{"config": cfg}],),
                     device="cpu", timeout_s=240)
    assert res[0][0]["history"] == want_hist
    np.testing.assert_array_equal(rows_of(res[0][0]["live"]), want_rows)
