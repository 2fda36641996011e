"""Port parity: state.setup_particles, interop, config and the float32
fused multiply-add emulation."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from particle_simulation_tpu import SimConfig as JConfig
from particle_simulation_tpu import setup_particles as j_setup
from particle_simulation_tpu.checkpoint import _FIELDS
from particle_simulation_tpu_torch import SimConfig, interop
from particle_simulation_tpu_torch.config import check_supported
from particle_simulation_tpu_torch.fma import fma_f32
from particle_simulation_tpu_torch.state import setup_particles


def _jax_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in _FIELDS}


@pytest.mark.parametrize(
    "kw,offset",
    [
        (dict(init_n=200, capacity=4096, grid_size=(16, 16, 16)), 0),
        # grid >= 62 cells: the seed box starts above 0 (lo > 0)
        (dict(init_n=3000, capacity=5000, grid_size=(64, 64, 64)), 0),
        (dict(init_n=1000, capacity=1024, grid_size=(256, 256, 256)), 5000),
        (dict(init_n=500, capacity=700, grid_size=(16, 70, 100),
              seed=7), 3),
    ],
)
def test_setup_particles_bitwise(kw, offset):
    j = _jax_numpy(j_setup(JConfig(**kw), slot_offset=offset))
    t = interop.state_to_numpy(setup_particles(SimConfig(**kw),
                                               slot_offset=offset,
                                               device="cpu"))
    for f in _FIELDS:
        assert j[f].dtype == t[f].dtype, f
        np.testing.assert_array_equal(j[f], t[f], err_msg=f)


def test_interop_round_trip():
    j = _jax_numpy(j_setup(JConfig(init_n=100, capacity=256,
                                   grid_size=(16, 16, 16))))
    st = interop.state_from_numpy(j, "cpu")
    assert st.id_hi.dtype == torch.int32 and st.n == 100
    back = interop.state_to_numpy(st)
    for f in _FIELDS:
        np.testing.assert_array_equal(j[f], back[f], err_msg=f)
    table = np.random.default_rng(0).random((10000, 2), dtype=np.float32)
    assert torch.equal(interop.table_from_numpy(table, "cpu"),
                       torch.from_numpy(table))
    with pytest.raises(ValueError, match="expected"):
        interop.table_from_numpy(table[:10], "cpu")


def test_setup_rejects_bad_configs():
    with pytest.raises(ValueError, match="exceeds capacity"):
        setup_particles(SimConfig(init_n=10, capacity=5))
    # the thermal start is ported: init_vth seeds Maxwellian velocities
    st = setup_particles(SimConfig(init_n=1, capacity=5, init_vth=1.0),
                         device="cpu")
    assert st.vel[0].abs().sum() > 0 and (st.vel[1:] == 0).all()


@pytest.mark.parametrize(
    "knob",
    [dict(integrator="rk4"), dict(collision_model="elastic"),
     dict(boundary="reflect"), dict(field_model="multigrid"),
     dict(precision="f16"), dict(init_vth=float("nan")),
     dict(b_field=(0.0, 0.0, float("inf"))),
     dict(rng_mode="other"), dict(spawn_depth=0),
     dict(scheduler="dynamic", poisson_timestep=40000),
     # the engines run float32 only (the JAX package's refusal)
     dict(precision="f64", scheduler="dynamic"),
     dict(precision="f64", scheduler="dynamic_old")],
)
def test_unported_model_knobs_raise(knob):
    with pytest.raises(ValueError):
        check_supported(SimConfig(**knob))


@pytest.mark.parametrize(
    "knob",
    [dict(integrator="boris"), dict(collision_model="isotropic"),
     dict(boundary="periodic"), dict(field_model="fft"),
     dict(init_vth=1e5), dict(b_field=(0.0, 0.0, 1.0)),
     dict(integrator="boris", b_field=(0.0, 0.0, -1.76e9),
          collision_model="isotropic", boundary="periodic", init_vth=2e6),
     # the float64 oracle mode on the plain schedulers
     dict(precision="f64"), dict(precision="f64", scheduler="sync")],
)
def test_ported_model_knobs_are_accepted(knob):
    check_supported(SimConfig(**knob))


def test_tpu_tuning_knobs_are_accepted():
    check_supported(SimConfig(lookup_mode="staticthresh", kernel_sublanes=8,
                              worklog_unroll=2, worklog_horizon=3,
                              bbox_subgrid=0, full_deposit="sorted"))


def _round_f32(x: Fraction) -> float:
    """Exact value -> nearest float32 (ties to even), by integer arithmetic."""
    if x == 0:
        return 0.0
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    q = max(e - 23, -149)                  # ulp exponent (subnormals: -149)
    scaled = x / Fraction(2) ** q
    n = scaled.numerator // scaled.denominator
    rem = scaled - n
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2 == 1):
        n += 1
    return sign * float(Fraction(n) * Fraction(2) ** q)


def test_fma_f32_rounds_once():
    r = np.random.default_rng(0)
    n = 3000
    a = (r.standard_normal(n) * 2.0 ** r.integers(-20, 20, n)).astype(np.float32)
    b = (r.standard_normal(n) * 2.0 ** r.integers(-20, 20, n)).astype(np.float32)
    c = (r.standard_normal(n) * 2.0 ** r.integers(-40, 40, n)).astype(np.float32)
    # cancellation: c close to -a*b
    c[: n // 3] = -(a[: n // 3] * b[: n // 3])
    # double-rounding traps: a*b = 2^-24 - 2^-70 next to an odd c in
    # [1, 2); float64 rounds the sum onto the float32 midpoint, the
    # correct result stays at c
    k = 200
    scale = 2.0 ** r.integers(-30, 30, k)
    a[-k:] = np.float32(2.0 ** -12 * (1 + 2.0 ** -23)) * scale
    b[-k:] = np.float32(2.0 ** -12 * (1 - 2.0 ** -23)) / scale
    c[-k:] = (1 + (2 * r.integers(0, 1 << 22, k) + 1) * 2.0 ** -23).astype(
        np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([
        _round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
        for x, y, z in zip(a, b, c)
    ], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    # the traps really are traps for a float64 emulation without the fix
    naive = (a[-k:].astype(np.float64) * b[-k:] + c[-k:]).astype(np.float32)
    assert (naive != want[-k:]).all()
