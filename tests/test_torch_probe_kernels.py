"""The three probe kernels (csrc/compact.cu, sublane_gather.cu,
lookup_bench.cu) against their plain PyTorch twins, on the card.

These tests need a CUDA GPU and nvcc and skip elsewhere.  This file imports
no JAX, so a GPU machine without JAX runs it (skipping conftest.py):

    python -m pytest tests/test_torch_probe_kernels.py -m cuda --noconftest

Tolerance: exact (int32 equality; float32 bit for bit).
"""

import pytest
import torch

from particle_simulation_tpu_torch.ops.kernels import (
    build, compact, lookup_bench, sublane_gather,
)
from particle_simulation_tpu_torch.probes import (
    experiment_worklog, microbench_lookup,
)

pytestmark = pytest.mark.cuda

L = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the card with -m cuda)")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")
    return torch.device("cuda", 0)


def _same_compaction(x):
    before = compact.row_compact.launches
    out, ptr = compact.row_compact(x)
    torch.cuda.synchronize()
    assert compact.row_compact.launches == before + 1
    want_out, want_ptr = compact.row_compact_plain(x.cpu())
    assert int(ptr) == int(want_ptr)
    assert torch.equal(out.cpu(), want_out)
    return out, ptr


@pytest.mark.parametrize("case", ["ragged", "all_empty", "all_full",
                                  "negatives", "many_waves"])
def test_row_compact_matches_plain(dev, case):
    """R not a multiple of a tile's 128 rows; no positive element (ptr 0);
    every lane positive; negatives mixed in (dropped, as zeros are); and
    40,000 rows, 313 tiles of one block, so the look-back crosses waves of
    the 132 SMs.  Rows are sparse enough in the last two that some are
    empty."""
    g = torch.Generator().manual_seed(7)
    if case == "ragged":
        x = experiment_worklog.make_lanes(1000, seed=1, device=dev)
    elif case == "all_empty":
        x = -torch.randint(0, 5, (777, L), generator=g, dtype=torch.int32)
    elif case == "all_full":
        x = torch.randint(1, 1 << 30, (4099, L), generator=g,
                          dtype=torch.int32)
    else:
        rows = 40_000 if case == "many_waves" else 3000
        x = torch.randint(-(1 << 30), 1 << 30, (rows, L), generator=g,
                          dtype=torch.int32)
        x[torch.rand((rows, L), generator=g) < 0.97] = 0
    out, ptr = _same_compaction(x.to(dev))
    if case == "all_empty":
        assert int(ptr) == 0 and not out.any()
    if case == "all_full":
        assert int(ptr) == x.shape[0] and torch.equal(out.cpu(), x)
    if case == "many_waves":
        assert 0 < int(ptr) < x.shape[0]


def test_row_compact_is_the_same_every_run(dev):
    x = experiment_worklog.make_lanes(50_000, density=0.01, seed=4, device=dev)
    first, first_ptr = compact.row_compact(x)
    for _ in range(10):
        out, ptr = compact.row_compact(x)
        assert int(ptr) == int(first_ptr)
        assert torch.equal(out, first)
    want, want_ptr = compact.row_compact_plain(x.cpu())
    assert int(first_ptr) == int(want_ptr) and torch.equal(first.cpu(), want)


def test_row_compact_calls_back_to_back_on_one_cached_state(dev):
    """16384 rows, then 33, then 777 empty rows, queued with no sync
    between them on the one cached look-back state: each exact, one launch
    a call, and the state's words all zero again after them."""
    big = experiment_worklog.make_lanes(16384, seed=5, device=dev)
    cases = [big, big[:33].clone(), -big[:777]]
    before = compact.row_compact.launches
    got = []
    for i, x in enumerate(cases):
        got.append(compact.row_compact(x))
        assert compact.row_compact.launches == before + i + 1
    torch.cuda.synchronize()
    for x, (out, ptr) in zip(cases, got):
        want_out, want_ptr = compact.row_compact_plain(x.cpu())
        assert int(ptr) == int(want_ptr)
        assert torch.equal(out.cpu(), want_out)
    assert int(got[2][1]) == 0 and not got[2][0].any()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = compact._STATE[(dev.index, stream)]
    assert state.numel() >= compact.state_words(16384)
    assert not state.any()


def test_row_compact_rejects_a_misaligned_tensor(dev):
    base = torch.zeros(4 * L + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        compact.row_compact(base[1:].view(4, L))


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("s", [8, 32, 79, 128])
def test_sublane_gather_matches_plain(dev, s, b):
    g = torch.Generator().manual_seed(s * 1000 + b)
    x = torch.randn((s, L), generator=g)
    idx = torch.randint(0, s, (b, s, L), generator=g, dtype=torch.int32)
    for variant in ("sublane", "both"):
        before = sublane_gather.sublane_gather.launches
        got = sublane_gather.sublane_gather(x.to(dev), idx.to(dev), variant)
        torch.cuda.synchronize()
        assert sublane_gather.sublane_gather.launches == before + 1
        want = sublane_gather.sublane_gather_plain(x, idx, variant)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    two_d = sublane_gather.sublane_gather(x.to(dev), idx[0].to(dev))
    assert torch.equal(two_d.cpu(), torch.gather(x, 0, idx[0].long()))


def test_sublane_gather_out_of_contract_indices(dev):
    """"both" takes any int32 (floor modulo, wrapping product); "sublane"
    writes NaN for an index outside [0, S) and reads nothing there."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((32, L), generator=g)
    idx = torch.randint(-(1 << 31), (1 << 31) - 1, (4, 32, L), generator=g,
                        dtype=torch.int32)
    got = sublane_gather.sublane_gather(x.to(dev), idx.to(dev), "both")
    want = sublane_gather.sublane_gather_plain(x, idx, "both")
    assert torch.equal(got.cpu(), want)
    bad = sublane_gather.sublane_gather(x.to(dev), idx.to(dev), "sublane")
    inside = (idx >= 0) & (idx < 32)
    assert torch.isnan(bad.cpu()[~inside]).all()


@pytest.mark.parametrize("shape", ["probe", "ragged", "int32_limits"])
def test_lookup_bench_variants_match_plain(dev, shape):
    """banked, paired, global, shared and the plain twin bitwise equal;
    none gives zeros.  "ragged": lanes not a multiple of a block;
    "int32_limits": lanes near both limits, where the sums wrap (banked's
    and paired's lanes near INT32_MAX take the formula, not the stepped
    index)."""
    if shape == "probe":
        inp = microbench_lookup.make_inputs(tiles=microbench_lookup.TILES,
                                            seed=2, device="cpu")
    else:
        inp = microbench_lookup.make_inputs(tiles=1, seed=3, device="cpu")
        x = inp.x.reshape(-1)[:5000].clone()
        if shape == "int32_limits":
            x[::2] = (1 << 31) - 1 - x[::2]
            x[1::2] = -(1 << 31) + x[1::2]
        inp = inp._replace(x=x)
    want = lookup_bench.lookup_bench_plain(*inp)
    gpu = [t.to(dev) for t in inp]
    for variant in ("banked", "paired", "global", "shared", "none"):
        before = lookup_bench.lookup_bench.launches
        got = lookup_bench.lookup_bench(*gpu, variant)
        torch.cuda.synchronize()
        assert lookup_bench.lookup_bench.launches == before + 1
        ref = torch.zeros_like(want) if variant == "none" else want
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))


def test_lookup_bench_banked_is_resident(dev):
    """The banked variant's 114,688 B blocks of 1024 threads are resident
    (two to an SM on an H100: 2 x (114,688 + 1,024) of 233,472 B)."""
    assert lookup_bench.banked_blocks_per_sm(dev) >= 1
