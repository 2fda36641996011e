"""Port parity: the plain twins of the three probe kernels
(ops/kernels/compact.py, sublane_gather.py, lookup_bench.py) against the
TPU kernels they replace, on the CPU.  Each TPU kernel runs through
``pallas_call`` in interpret mode with its script's BlockSpecs, the script
loaded by path.  Tolerance: exact (int32 equality; float32 bit for bit).

The CPU wrappers take the twins and launch nothing; bad shapes, types and
devices raise."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from particle_simulation_tpu_torch.ops.kernels import (
    compact, lookup_bench, sublane_gather,
)
from particle_simulation_tpu_torch.probes import (
    common, experiment_sublane_gather, experiment_worklog, microbench_lookup,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 128


def _load_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


# ---- experiment_worklog: row compaction ----

def _script_lanes(seed, rows):
    """The script's input: a value in [1, 1000) with probability 0.3."""
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, L)) < 0.3).astype(np.int32)
            * rng.integers(1, 1000, (rows, L)).astype(np.int32))


def _compact_tpu(x):
    script = _load_script("experiment_worklog")
    s = script.S
    num_tiles = x.shape[0] // s
    out, ptr = pl.pallas_call(
        script.kernel,
        grid=(num_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=(pl.BlockSpec(memory_space=pl.ANY),
                   pl.BlockSpec(memory_space=pltpu.SMEM)),
        out_shape=(jax.ShapeDtypeStruct(x.shape, jnp.int32),
                   jax.ShapeDtypeStruct((1, 1), jnp.int32)),
        scratch_shapes=[pltpu.VMEM((s, L), jnp.int32),
                        pltpu.SMEM((1,), jnp.int32),
                        pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out), int(np.asarray(ptr)[0, 0])


@pytest.mark.parametrize("case", ["seed0", "seed1", "empty_tile"])
def test_row_compact_plain_matches_pallas_kernel(case):
    """The script's 4 x (8, 128) input at seed 0, a second seed, and a tile
    with no positive element (zeros and negatives only)."""
    x = _script_lanes(1 if case == "seed1" else 0, 32)
    if case == "empty_tile":
        x[8:16] = -np.abs(_script_lanes(2, 8))
    want_out, want_ptr = _compact_tpu(x)
    out, ptr = compact.row_compact_plain(torch.from_numpy(x))
    assert int(ptr) == want_ptr
    np.testing.assert_array_equal(out.numpy()[:want_ptr], want_out[:want_ptr])
    assert (out.numpy()[want_ptr:] == 0).all()
    if case == "empty_tile":
        assert want_ptr == 24


# ---- experiment_sublane_gather ----

def _gather_tpu(x, idx, variant):
    script = _load_script("experiment_sublane_gather")
    return np.asarray(pl.pallas_call(
        functools.partial(script.kernel, variant),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(idx)))


def _gather_inputs(s):
    rng = np.random.default_rng(s)
    return (rng.standard_normal((s, L)).astype(np.float32),
            rng.integers(0, s, (s, L)).astype(np.int32))


@pytest.mark.parametrize("variant", ["sublane", "both"])
@pytest.mark.parametrize("s", [8, 32, 128])
def test_sublane_gather_plain_matches_pallas_kernel(s, variant):
    x, idx = _gather_inputs(s)
    want = _gather_tpu(x, idx, variant)
    got = sublane_gather.sublane_gather_plain(torch.from_numpy(x),
                                              torch.from_numpy(idx), variant)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("s", [8, 32, 128])
def test_sublane_gather_wrapper_at_b1_matches_pallas_kernel(s):
    """B = 1 through the CPU wrapper: the twin, no launch."""
    x, idx = _gather_inputs(s)
    before = sublane_gather.sublane_gather.launches
    for variant in ("sublane", "both"):
        got = sublane_gather.sublane_gather(
            torch.from_numpy(x), torch.from_numpy(idx[None]), variant)
        assert got.shape == (1, s, L)
        np.testing.assert_array_equal(_bits(got[0].numpy()),
                                      _bits(_gather_tpu(x, idx, variant)))
    assert sublane_gather.sublane_gather.launches == before


# ---- microbench_lookup ----

def _lookup_tpu(x, split2d, remove2d, mode, tiles):
    script = _load_script("microbench_lookup")
    s, n = script.S, script.N_CHUNKS
    return np.asarray(pl.pallas_call(
        functools.partial(script.kernel, mode),
        grid=(tiles,),
        in_specs=[
            pl.BlockSpec((s, L), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((n, L), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((n, L), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((s, L), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((tiles * s, L), jnp.float32),
        scratch_shapes=[pltpu.VMEM((n * s, L), jnp.float32),
                        pltpu.VMEM((n * s, L), jnp.float32)],
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(split2d), jnp.asarray(remove2d)))


@pytest.mark.parametrize("mode", ["a", "b", "c", "d", "e"])
def test_lookup_bench_plain_matches_pallas_kernel(mode):
    """Modes a-d are the "global" function, e the "none" floor; 2 tiles."""
    tiles = 2
    rng = np.random.default_rng(5)
    x = rng.integers(0, 7 * L, (tiles * L, L)).astype(np.int32)
    split2d = rng.random((79, L), dtype=np.float32)
    remove2d = rng.random((79, L), dtype=np.float32)
    want = _lookup_tpu(x, split2d, remove2d, mode, tiles)
    variant = "none" if mode == "e" else "global"
    got = lookup_bench.lookup_bench_plain(
        *map(torch.from_numpy, (x, split2d, remove2d)), variant)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert (want != 0).all() if mode != "e" else (want == 0).all()


@pytest.mark.parametrize("lanes", ["random", "int32_max", "int32_min"])
def test_lookup_bench_incremental_plain_matches_pallas_kernel(lanes):
    """The banked kernel's index rule (r += 38 modulo 896; the formula for
    lanes whose x + 38t wraps int32) against the TPU kernel (mode a) and
    the formula's twin, bitwise; 2 tiles.  Near INT32_MAX every lane
    wraps within its T steps, near INT32_MIN none does."""
    tiles = 2
    rng = np.random.default_rng(6)
    x = rng.integers(0, 7 * L, (tiles * L, L)).astype(np.int64)
    if lanes == "int32_max":
        x = 2**31 - 1 - x
    elif lanes == "int32_min":
        x = -2**31 + x
    x = x.astype(np.int32)
    split2d = rng.random((79, L), dtype=np.float32)
    remove2d = rng.random((79, L), dtype=np.float32)
    want = _lookup_tpu(x, split2d, remove2d, "a", tiles)
    args = tuple(map(torch.from_numpy, (x, split2d, remove2d)))
    got = lookup_bench.lookup_bench_incremental_plain(*args)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(lookup_bench.lookup_bench_plain(*args, "banked").numpy()))
    wraps = x.astype(np.int64) + lookup_bench.STEP * (lookup_bench.T_STEPS - 1)
    assert (wraps > 2**31 - 1).all() == (lanes == "int32_max")


# ---- the CPU wrappers ----

def test_cpu_wrappers_take_the_plain_twins():
    counters = (compact.row_compact, sublane_gather.sublane_gather,
                lookup_bench.lookup_bench)
    before = [f.launches for f in counters]
    x = experiment_worklog.make_lanes(70, seed=3, device="cpu")
    x[5] = -x[5]
    out, ptr = compact.row_compact(x)
    want_out, want_ptr = compact.row_compact_plain(x)
    assert torch.equal(out, want_out) and int(ptr) == int(want_ptr) == 69
    inp = experiment_sublane_gather.make_inputs(device="cpu")
    xs, idx = inp[(32, 1)]
    for variant in ("sublane", "both"):
        assert torch.equal(sublane_gather.sublane_gather(xs, idx, variant),
                           sublane_gather.sublane_gather_plain(xs, idx, variant))
    lk = microbench_lookup.make_inputs(tiles=1, device="cpu")
    for variant in ("banked", "paired", "global", "shared"):
        assert torch.equal(lookup_bench.lookup_bench(*lk, variant),
                           lookup_bench.lookup_bench_plain(*lk, "global"))
    assert not lookup_bench.lookup_bench(*lk, "none").any()
    assert [f.launches for f in counters] == before


def test_plain_twins_wrap_and_floor_as_int32():
    """Negative lanes and lanes near the int32 limits: the floor modulo and
    the wrapping sums keep every read inside the table."""
    x = torch.tensor([[-1, -897, 2**31 - 1, -2**31] * 32], dtype=torch.int32)
    tab = torch.arange(79 * L, dtype=torch.float32).reshape(79, L)
    got = lookup_bench.lookup_bench_plain(x, tab, tab)
    want = []
    for v in x[0].tolist():
        acc = np.float32(0)
        for t in range(lookup_bench.T_STEPS):
            s = (v + t + 37 * t + 2**31) % 2**32 - 2**31  # int32 wrap
            idx = s % 896 + 128
            acc = np.float32(np.float32(acc + idx) + np.float32(idx))
        want.append(acc)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want, np.float32))


def test_lookup_bench_incremental_plain_on_lanes_that_wrap_mid_run():
    """Lanes that wrap at every step t of the run, and their neighbours:
    the stepped index parts from the formula after the wrap (2^32 mod 896
    = 256), so these lanes must take the formula."""
    step = lookup_bench.STEP
    first = 2**31 - 1 - step * np.arange(lookup_bench.T_STEPS + 2)
    x = np.concatenate([first, first + 1, first - 1])
    x = np.resize(x, (4, L)).astype(np.int64).astype(np.int32)
    g = torch.Generator().manual_seed(11)
    tabs = torch.rand((2, 79, L), generator=g)
    xt = torch.from_numpy(x)
    got = lookup_bench.lookup_bench_incremental_plain(xt, *tabs)
    want = lookup_bench.lookup_bench_plain(xt, *tabs)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("variant", ["banked", "paired", "none"])
def test_cpu_lookup_wrapper_takes_the_plain_twin(variant):
    """On a CPU tensor every variant, banked too, is the plain twin: no
    launch, no kernel built."""
    lk = microbench_lookup.make_inputs(tiles=1, seed=8, device="cpu")
    before = lookup_bench.lookup_bench.launches
    got = lookup_bench.lookup_bench(*lk, variant)
    assert torch.equal(got, lookup_bench.lookup_bench_plain(*lk, variant))
    assert lookup_bench.lookup_bench.launches == before


@pytest.mark.parametrize("variant", ["texture", "Banked", "banked2"])
def test_lookup_wrapper_rejects_unknown_variants(variant):
    lk = microbench_lookup.make_inputs(tiles=1, device="cpu")
    for fn in (lookup_bench.lookup_bench, lookup_bench.lookup_bench_plain,
               lookup_bench.lookup_bench_incremental_plain):
        with pytest.raises(ValueError, match="variant"):
            fn(*lk, variant)


@pytest.mark.parametrize("bytes_per_call, sets", [
    (16 * 2**20, 8),        # row_compact at (16384, 128): 8 MiB in, 8 out
    (7_864_320, 16),        # the lookup probe's lanes in and out
    (100 * 2**20, 2),       # exactly twice the L2: one more set
    (101 * 2**20, 1),       # past twice the L2 alone
    (1, 2**27),
])
def test_rotation_sets_exceed_twice_the_l2(bytes_per_call, sets):
    """The cold timing's set count: the least power of two whose working
    set exceeds twice the 50 MiB L2."""
    got = common.rotation_sets(bytes_per_call)
    assert got == sets
    assert got * bytes_per_call > 2 * common.L2_BYTES
    assert got == 1 or (got // 2) * bytes_per_call <= 2 * common.L2_BYTES


def test_rotation_sets_rejects_no_bytes():
    with pytest.raises(ValueError):
        common.rotation_sets(0)


def test_row_compact_lookback_state_is_cached_and_grown():
    """One zeroed buffer per (device, stream), kept while calls fit it and
    grown (at least doubled) when a call needs more words: a call that
    fits fills nothing."""
    key = (torch.device("cpu"), 12345)
    compact._STATE.pop((None, 12345), None)
    assert compact.state_words(16384) == 130 and compact.state_words(129) == 4
    a = compact._lookback_state(*key, compact.state_words(16384))
    assert a.numel() == 130 and not a.any()
    assert compact._lookback_state(*key, 4) is a
    b = compact._lookback_state(*key, 200)
    assert b is not a and b.numel() == 260 and not b.any()
    assert compact._lookback_state(*key, 260) is b
    assert compact._lookback_state(torch.device("cpu"), 1, 3) is not b
    compact._STATE.pop((None, 12345), None)
    compact._STATE.pop((None, 1), None)


@pytest.mark.parametrize("kernel", ["compact", "sublane", "lookup"])
def test_wrappers_reject_bad_inputs(kernel):
    meta = torch.device("meta")
    if kernel == "compact":
        call = compact.row_compact
        good = (torch.zeros((4, L), dtype=torch.int32),)
        bad = [(torch.zeros((4, 64), dtype=torch.int32),),
               (torch.zeros((4, L), dtype=torch.int64),),
               (torch.zeros((4, L), dtype=torch.int32)[None],)]
    elif kernel == "sublane":
        call = sublane_gather.sublane_gather
        x = torch.zeros((8, L))
        idx = torch.zeros((8, L), dtype=torch.int32)
        good = (x, idx)
        bad = [(x, idx.long()), (x.double(), idx), (x, idx[:4]),
               (x, idx, "rows"), (torch.zeros((8, 64)), idx[:, :64])]
    else:
        call = lookup_bench.lookup_bench
        x = torch.zeros((L, L), dtype=torch.int32)
        tab = torch.zeros((79, L))
        good = (x, tab, tab)
        bad = [(x.long(), tab, tab), (x, tab[:7], tab[:7]),
               (x, tab, tab[:9]), (x, tab.double(), tab),
               (x, tab, tab, "texture")]
    call(*good)
    for args in bad:
        with pytest.raises(ValueError):
            call(*args)
    with pytest.raises(ValueError, match="device"):
        call(*(a.to(meta) if isinstance(a, torch.Tensor) else a
               for a in good))
