"""Port parity at the spawn depths and Threefry round counts outside the
CUDA kernels' compiled set (depth 1..4, rounds 13 and 20), which the
kernels run through their open instantiations: the port's ``dynamic`` and
``dynamic_old`` on the CPU against the JAX package on the same config, and
``csrc/threefry.cuh``'s cipher, compiled by the host C++ compiler, against
the JAX package's ``rng.threefry2x32``.

Tolerance: exact (per-step n, added, removed, overflow, pushes_lo,
pushes_hi; the sorted particle multiset with ids; the cipher's words bit
for bit).  The JAX package's ``dynamic`` runs its Pallas engine in
interpret mode for about 100 s a configuration on the CPU, so the
references are JAX ``naive`` (which the JAX package's own tests hold equal
to its ``dynamic``), ``sync`` and ``dynamic_old`` (the Pallas staged engine
in interpret mode, a few seconds).  Kernel-vs-plain at these depths and
rounds on the card: tests/test_torch_kernels.py and
tests/test_torch_staged_kernels.py (``test_open_variants_match_plain``).
"""

import ctypes
import functools
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import particle_simulation_tpu as J
from particle_simulation_tpu import rng as jrng
from particle_simulation_tpu.cross_section import bundled_paths
from particle_simulation_tpu.cross_section import load_table as j_load
from particle_simulation_tpu.cross_section import write_table
from particle_simulation_tpu.ops.step import poisson_step as j_step
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.cross_section import load_table
from particle_simulation_tpu_torch.ops.kernels import build, engine
from particle_simulation_tpu_torch.ops.kernels import push_mcc as tpm
from particle_simulation_tpu_torch.ops.step import poisson_step
from particle_simulation_tpu_torch.runtime import multiset_with_ids
from particle_simulation_tpu_torch.state import setup_particles

KEYS = ("n", "added", "removed", "overflow", "pushes_lo", "pushes_hi")
STEPS = 2
SMALL = dict(init_n=200, capacity=4096, grid_size=(16, 16, 16),
             poisson_timestep=6)
# tests/test_pallas.py's CFG: spawn depth 6, the constant 50/50 table
PALLAS = dict(init_n=300, capacity=8192, poisson_timestep=6,
              grid_size=(32, 32, 32), spawn_depth=6)
CONFIGS = {"small": SMALL, "pallas": PALLAS}


def _steps(state, step, table, cfg):
    """Per step: the six counters and the multiset with ids."""
    out = []
    for s in range(STEPS):
        state, m = step(state, s, table, cfg)
        st = state
        if not isinstance(st.n, int):
            st = interop.state_from_numpy(
                {f: np.asarray(getattr(st, f)) for f in interop.FIELDS},
                "cpu")
        out.append(({k: int(m[k]) for k in KEYS}, multiset_with_ids(st)))
    return out


@functools.lru_cache(maxsize=None)
def _jax(config: str, scheduler: str, table: int = 1, **kw):
    cfg = J.SimConfig(**CONFIGS[config], scheduler=scheduler, **kw)
    return _steps(J.setup_particles(cfg),
                  lambda st, s, t, c: j_step(st, jnp.uint32(s), t, c),
                  j_load(bundled_paths()[table]), cfg)


def _port(config: str, scheduler: str, table: int = 1, **kw):
    cfg = SimConfig(**CONFIGS[config], scheduler=scheduler, **kw)
    return _steps(setup_particles(cfg, device="cpu"), poisson_step,
                  load_table(bundled_paths()[table], "cpu"), cfg)


def _assert_same(port, ref, churn=True):
    for s, ((pm, pi), (jm, ji)) in enumerate(zip(port, ref)):
        assert pm == jm, (s, pm, jm)
        np.testing.assert_array_equal(pi, ji, err_msg=f"step {s}")
    # the const table's MCC fires at once; the sine table's needs more steps
    assert not churn or sum(m["added"] for m, _ in ref) > 0


@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_pallas_config_matches_jax_sync(scheduler):
    """tests/test_pallas.py's own configuration (spawn depth 6), which the
    kernels run through their open instantiations."""
    assert not engine.compiled(SimConfig(**PALLAS))
    _assert_same(_port("pallas", scheduler), _jax("pallas", "sync"))


@pytest.mark.parametrize("depth", [5, 6, 8])
def test_dynamic_at_new_depths_matches_jax_naive(depth):
    _assert_same(_port("small", "dynamic", spawn_depth=depth),
                 _jax("small", "naive", spawn_depth=depth))


@pytest.mark.parametrize("depth", [5, 6, 8])
def test_dynamic_old_at_new_depths_matches_jax_dynamic_old(depth):
    """Against the JAX staged engine at the same spawn depth (the Pallas
    kernel in interpret mode, a few seconds a depth)."""
    _assert_same(_port("small", "dynamic_old", spawn_depth=depth),
                 _jax("small", "dynamic_old", spawn_depth=depth))


@pytest.mark.parametrize("rounds", [5, 8, 12, 16])
@pytest.mark.parametrize("scheduler", ["dynamic", "dynamic_old"])
def test_new_round_counts_match_jax_naive(scheduler, rounds):
    """Both tables: the const table's churn and the sine table's pushes
    (its draws split nothing in two steps at this size)."""
    for table in (0, 1):
        _assert_same(
            _port("small", scheduler, table, rng_rounds=rounds),
            _jax("small", "naive", table, rng_rounds=rounds), churn=table)


def test_overflow_at_a_new_depth_is_flagged(tmp_path):
    """At spawn depth 6 with a split-heavy table (70% split, 10% absorb a
    step) at capacity 1,024, the JAX engines and the port's flag the
    overflow at the same step.  Past an overflow the populations differ
    by design: the port's engines reclaim dead rows before they drop
    children (the overflow rule of ops/kernels/push_mcc.py), the JAX
    engines do not, so only the flag and the capacity bound are held."""
    path = str(tmp_path / "split_heavy.txt")
    write_table(path, np.tile(np.float32([[70.0, 10.0]]), (10000, 1)))
    kw = dict(SMALL, capacity=1024, spawn_depth=6)
    flags = []
    for scheduler in ("naive", "dynamic_old"):
        cfg = J.SimConfig(**kw, scheduler=scheduler)
        _, m = j_step(J.setup_particles(cfg), jnp.uint32(0), j_load(path),
                      cfg)
        flags.append(bool(m["overflow"]))
    for scheduler in ("dynamic", "dynamic_old"):
        cfg = SimConfig(**kw, scheduler=scheduler)
        st, m = poisson_step(setup_particles(cfg, device="cpu"), 0,
                             load_table(path, "cpu"), cfg)
        flags.append(m["overflow"])
        assert 0 < st.n <= cfg.capacity
    assert flags == [True] * 4


def test_compiled_set_and_kernel_args():
    """Every spawn depth >= 1 and every round count is taken; the
    compiled set is depth 1..4 with rounds 13 and 20."""
    table = torch.zeros((10000, 2))
    for depth, rounds, fixed in ((2, 13, True), (4, 20, True), (5, 13, False),
                                 (2, 12, False), (16, 0, False)):
        cfg = SimConfig(spawn_depth=depth, rng_rounds=rounds)
        assert engine.compiled(cfg) == fixed
        engine.check_kernel_args(cfg, table, table.device)
    with pytest.raises(ValueError, match="spawn_depth"):
        engine.check_kernel_args(SimConfig(spawn_depth=0), table, table.device)


def test_open_scratch_shapes():
    """The open instantiations' children scratch: a Child (9 words) a
    resident thread and depth; the compiled set has none."""
    from particle_simulation_tpu_torch.ops.kernels import worklog

    cfg = SimConfig(spawn_depth=6)
    assert "kids" not in worklog.scratch_shapes(cfg, 4096)
    assert worklog.scratch_shapes(cfg, 4096, 264)["kids"] == (
        (6, 264 * worklog.TILE, 9), torch.int32)
    assert tpm.staged_scratch_shapes(cfg, 4096, 132)["kids"] == (
        (6, 132 * tpm.STAGED_TILE, 9), torch.int32)
    # the open symbols take the compiled ones' arguments, then the scratch
    # and its blocks before the stream
    for name in ("pst_worklog_phase", "pst_staged_phase"):
        args = build.SIGNATURES[name]
        assert build.SIGNATURES[f"{name}_open"] == (
            *args[:-1], ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)


THREEFRY_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <utility>
#include <vector>

#include "threefry.cuh"

using namespace pst;

template <int R>
void fixed(const std::vector<uint32_t>& in, uint32_t* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    threefry2x32<R>(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3],
                    out[2 * i], out[2 * i + 1]);
  }
}

template <int... R>
void all_fixed(std::integer_sequence<int, R...>,
               const std::vector<uint32_t>& in, uint32_t* out, size_t n) {
  (fixed<R>(in, out + 2 * n * R, n), ...);
}

// argv: n, the input words (n x 4: k0 k1 c0 c1), the output file: for
// rounds 0..24 the run-time cipher's words, then the templated one's
int main(int argc, char** argv) {
  const size_t n = std::strtoul(argv[1], nullptr, 10);
  constexpr int kRounds = 25;
  std::vector<uint32_t> in(4 * n), out(2 * 2 * n * kRounds);
  FILE* f = std::fopen(argv[2], "rb");
  if (!f || std::fread(in.data(), 4, in.size(), f) != in.size()) return 1;
  std::fclose(f);
  for (int r = 0; r < kRounds; ++r) {
    for (size_t i = 0; i < n; ++i) {
      threefry2x32_rt(r, in[4 * i], in[4 * i + 1], in[4 * i + 2],
                      in[4 * i + 3], out[2 * n * r + 2 * i],
                      out[2 * n * r + 2 * i + 1]);
    }
  }
  all_fixed(std::make_integer_sequence<int, kRounds>(), in,
            out.data() + 2 * n * kRounds, n);
  f = std::fopen(argv[3], "wb");
  if (!f || std::fwrite(out.data(), 4, out.size(), f) != out.size()) return 1;
  std::fclose(f);
  return 0;
}
"""


def test_threefry_header_matches_jax_for_any_rounds(tmp_path):
    """threefry2x32_rt and threefry2x32<ROUNDS>, compiled with the host
    C++ compiler, bitwise against the JAX package's cipher for rounds
    0-24 on 10^5 seeded inputs."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (c++ or g++)")
    n, rounds = 100_000, 25
    words = np.random.default_rng(0).integers(
        0, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32)
    src, exe = tmp_path / "threefry.cpp", tmp_path / "threefry"
    src.write_text(THREEFRY_HARNESS)
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-I", build.CSRC, str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    words.tofile(tmp_path / "in.bin")
    subprocess.run([str(exe), str(n), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, timeout=120)
    out = np.fromfile(tmp_path / "out.bin", np.uint32).reshape(2, rounds, n,
                                                                2)
    for r in range(rounds):
        want = np.stack([np.asarray(w) for w in jrng.threefry2x32(
            *words.T, rounds=r)], axis=1)
        np.testing.assert_array_equal(out[0, r], want, err_msg=f"rt {r}")
        np.testing.assert_array_equal(out[1, r], want, err_msg=f"fixed {r}")
    assert os.path.getsize(tmp_path / "out.bin") == out.nbytes


def test_ptxas_report_names_the_open_instantiations():
    """probes/ptxas.py: an open instantiation (template depth 0) by its
    draw protocol and model path, its depth and rounds printed open."""
    from particle_simulation_tpu_torch.probes import ptxas

    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN3pst6staged12staged_phaseILi0ELi0ELb1ELb1EEEvNS0_4ArgsE' for "
        "'sm_90a'\n"
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers\n")
    assert ptxas.phase_resources(log) == {
        ("staged_phase", 0, 0, True, "general"): dict(
            stack=8, spill_stores=0, spill_loads=0, registers=128)}
    assert ptxas.format_lines(log) == [
        "staged_phase general   depth and rounds open block2 1: 128 "
        "registers, stack 8 B, spill stores 0 B, loads 0 B"]
