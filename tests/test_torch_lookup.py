"""Port parity: cross_section (tables, energy_to_index, the lookup outcome
table_lookup) and the status encodings of ops/kernels/push_mcc.

energy_to_index cannot be bitwise: torch.log and XLA:CPU's log differ on
rare float32 inputs (about 1.7% of random energies by one ulp), which moves
the bucket only when log10(E) lies within an ulp of a bucket edge.  Stated
bound, on 100,000 random energies over the table's range: at most 1 in
10,000 buckets differ, and none by more than one bucket.  Exact-parity tests
of the slice therefore use the constant table, whose chances do not depend
on the bucket.
"""

import jax
import numpy as np
import torch

from particle_simulation_tpu import cross_section as jcs
from particle_simulation_tpu.ops.pallas import push_mcc as jpm
from particle_simulation_tpu_torch import cross_section as tcs
from particle_simulation_tpu_torch.ops.kernels import engine
from particle_simulation_tpu_torch.ops.kernels import push_mcc as tpm

MAX_MISMATCH_FRACTION = 1e-4


def test_tables_equal():
    for path in jcs.bundled_paths():
        np.testing.assert_array_equal(np.asarray(jcs.load_table(path)),
                                      tcs.load_table(path, "cpu").numpy())
    np.testing.assert_array_equal(jcs.generate_table(), tcs.generate_table())
    assert tcs.bundled_paths()[0] == jcs.bundled_paths()[0]


def test_load_table_rejects_short_file(tmp_path):
    bad = tmp_path / "short.txt"
    bad.write_text("1 2\n3 4\n")
    try:
        tcs.load_table(str(bad), "cpu")
    except ValueError as e:
        assert "expected (10000, 2)" in str(e)
    else:
        raise AssertionError("a short table must raise")


def test_energy_to_index_within_stated_bound():
    r = np.random.default_rng(0)
    energy = (10.0 ** r.uniform(-7.0, 16.5, 100_000)).astype(np.float32)
    energy[:4] = (0.0, 1e-30, 1e30, 1e-6)
    want = np.asarray(jax.jit(jcs.energy_to_index)(energy))
    got = tcs.energy_to_index(torch.from_numpy(energy)).numpy()
    assert got.dtype == np.int32
    diff = np.abs(want.astype(np.int64) - got)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_MISMATCH_FRACTION
    np.testing.assert_array_equal(want[:4], got[:4])


def test_energy_to_index_fuses_the_add(monkeypatch):
    """With XLA's own log values, the port's formula is exact: log10(E) + 6
    is one fused multiply-add (two roundings differ on ~1e-4 of inputs)."""
    r = np.random.default_rng(1)
    energy = (10.0 ** r.uniform(-7.0, 16.5, 200_000)).astype(np.float32)
    want = np.asarray(jax.jit(jcs.energy_to_index)(energy))
    log_xla = torch.from_numpy(np.array(jax.jit(jax.numpy.log)(energy)))
    monkeypatch.setattr(torch, "log", lambda x: log_xla)
    got = tcs.energy_to_index(torch.from_numpy(energy)).numpy()
    np.testing.assert_array_equal(want, got)


def test_status_encodings_match():
    for resume in (1, 2, 57, 101, 32000):
        for stamp in (-1, 1, 99, 32000):
            s = jpm._encode_suspended(resume, stamp)
            assert tpm._encode_suspended(resume, stamp) == s
            assert tpm._is_suspended(s) and tpm._is_unfinished(s)
            assert tpm._suspended_resume(s) == resume
            assert tpm._suspended_stamp(s) == stamp
    assert engine.FIELD_NAMES == jpm.FIELD_NAMES
    assert tpm._INF_START == jpm._INF_START
    assert not tpm._is_unfinished(-2) and not tpm._is_unfinished(0)


def test_table_lookup_reads_the_bucket_row():
    table = torch.arange(20000, dtype=torch.float32).reshape(10000, 2)
    energy = torch.tensor([0.0, 1e-6, 1.0, 1e16], dtype=torch.float32)
    split, remove = tcs.table_lookup(table, energy)
    idx = tcs.energy_to_index(energy).long()
    assert torch.equal(split, 2.0 * idx) and torch.equal(remove, 2.0 * idx + 1)
