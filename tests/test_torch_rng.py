"""Port parity: rng.py.  The same inputs through the JAX package's rng and
the port's must give bitwise equal words and uniforms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_simulation_tpu import rng as jrng
from particle_simulation_tpu_torch import rng as trng

N = 4096
SEED = 39587


def _lanes(seed=0):
    r = np.random.default_rng(seed)
    hi = r.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    lo = r.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _t(words_u32):
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(words_u32.view(np.int32).copy())


def _np(x):
    """A port word (int64 tensor) or float tensor -> numpy in JAX's dtype."""
    if x.dtype == torch.int64:
        return x.numpy().astype(np.uint32)
    return x.numpy()


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bitwise(rounds):
    hi, lo = _lanes(1)
    c0, c1 = _lanes(2)
    j = jrng.threefry2x32(hi, lo, c0, c1, rounds=rounds)
    t = trng.threefry2x32(_t(hi), _t(lo), _t(c0), _t(c1), rounds=rounds)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_initial_ids_bitwise():
    slots = np.arange(N, dtype=np.uint32) + np.uint32(123456)
    j = jrng.initial_ids(SEED, slots)
    t = trng.initial_ids(SEED, _t(slots))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("rounds", [13, 20])
@pytest.mark.parametrize("p_step", [0, 7])
def test_step_and_pair_draws_bitwise(rounds, p_step):
    hi, lo = _lanes(3)
    t_vec = np.random.default_rng(4).integers(1, 200, N).astype(np.uint32)
    j = jrng.step_draws(SEED, hi, lo, jnp.uint32(p_step), t_vec, 0.0, 100.0,
                        rounds=rounds)
    t = trng.step_draws(SEED, _t(hi), _t(lo), p_step, _t(t_vec), 0.0, 100.0,
                        rounds=rounds)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    te = t_vec & np.uint32(0xFFFFFFFE)
    j_even, j_odd = jrng.pair_draws(SEED, hi, lo, jnp.uint32(p_step), te,
                                    0.0, 100.0, rounds=rounds)
    t_even, t_odd = trng.pair_draws(SEED, _t(hi), _t(lo), p_step, _t(te),
                                    0.0, 100.0, rounds=rounds)
    for a, b in zip(j_even + j_odd, t_even + t_odd):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("mode", ["perstep", "block2"])
@pytest.mark.parametrize("rounds", [13, 20])
def test_step_draws_mode_and_child_ids_bitwise(mode, rounds):
    hi, lo = _lanes(5)
    for t_scalar in (1, 2, 99):
        j = jrng.step_draws_mode(mode, SEED, hi, lo, jnp.uint32(3),
                                 jnp.uint32(t_scalar), 0.0, 100.0,
                                 rounds=rounds)
        t = trng.step_draws_mode(mode, SEED, _t(hi), _t(lo), 3, t_scalar,
                                 0.0, 100.0, rounds=rounds)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), _np(b))
    t_vec = np.random.default_rng(6).integers(1, 101, N).astype(np.uint32)
    j = jrng.child_ids_at(mode, SEED, hi, lo, jnp.uint32(3), t_vec,
                          rounds=rounds)
    t = trng.child_ids_at(mode, SEED, _t(hi), _t(lo), 3, _t(t_vec),
                          rounds=rounds)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_setup_uniform_and_uniform_from_bits_bitwise():
    hi, lo = _lanes(7)
    for axis, (a, b) in enumerate([(0.34, 0.96), (0.0, 0.16), (1.98, 2.62)]):
        j = jrng.setup_uniform(hi, lo, axis, a, b)
        t = trng.setup_uniform(_t(hi), _t(lo), axis, a, b)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    bits = _lanes(8)[0]
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform_from_bits(bits, 0.0, 100.0)),
        trng.uniform_from_bits(_t(bits), 0.0, 100.0).numpy(),
    )


def test_word_conversions_round_trip():
    w = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
    i32 = trng.to_i32(w)
    assert i32.dtype == torch.int32
    assert i32.tolist() == [0, 1, (1 << 31) - 1, -(1 << 31), -1]
    assert trng.u32(i32).tolist() == w.tolist()
