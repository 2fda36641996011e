"""npz checkpoints of the port (``checkpoint.py``): a round trip, the step
discovery, the hook, and resuming, within the port and across the two
packages: a JAX ``save_npz`` checkpoint resumes in the port and a port
checkpoint resumes in the JAX package, each equal to the uninterrupted run
(sorted multiset with ids, per-step populations; tolerance: exact)."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from particle_simulation_tpu import checkpoint as jck
from particle_simulation_tpu import runtime as jrt
from particle_simulation_tpu_torch import checkpoint, interop
from particle_simulation_tpu_torch.runtime import multiset_with_ids, run_pic
from particle_simulation_tpu_torch.state import setup_particles

from test_torch_runtime import CFG, j_ids, jax_config

FULL = CFG.replace(poisson_steps=4)


def test_npz_roundtrip_in_the_jax_types(tmp_path):
    st = run_pic(CFG.replace(poisson_steps=1), print_header=False,
                 device="cpu").state
    path = str(tmp_path / "snap.npz")
    checkpoint.save_npz(path, st, 7)
    with np.load(path) as z:
        assert z["id_hi"].dtype == np.uint32 and z["n"].shape == ()
        assert int(z["poisson_step"]) == 7
    back, step = checkpoint.load_npz(path, "cpu")
    assert step == 7 and back.n == st.n
    for f in ("pos", "vel", "acc", "status", "id_hi", "id_lo"):
        assert getattr(back, f).equal(getattr(st, f)), f
    jstate, jstep = jck.load_npz(path)  # the JAX package reads it too
    assert jstep == 7 and int(jstate.n) == st.n
    np.testing.assert_array_equal(j_ids(jstate), multiset_with_ids(st))


def test_latest_step_and_hook(tmp_path):
    d = str(tmp_path / "ck")
    assert checkpoint.latest_step(d) is None
    hook = checkpoint.make_checkpoint_hook(CFG, d)
    st = setup_particles(CFG, device="cpu")
    for t in (0, 4, 12):
        hook(t, st)
    assert sorted(os.listdir(d)) == [
        "step_000000.npz", "step_000004.npz", "step_000012.npz"]
    for junk in ("step_000099.txt", "step_x.npz", "other_000100.npz"):
        open(os.path.join(d, junk), "w").close()
    os.makedirs(os.path.join(d, "step_000200"))  # an orbax step directory
    assert checkpoint.latest_step(d) == 12


def test_resume_equals_the_uninterrupted_run(tmp_path):
    d = str(tmp_path / "ck")
    full = run_pic(FULL.replace(verbose=1), print_header=False, device="cpu",
                   on_step=checkpoint.make_checkpoint_hook(FULL, d))
    for t in (3, 4):  # keep the checkpoints up to step 2
        os.remove(os.path.join(d, f"step_{t:06d}.npz"))
    resumed = checkpoint.resume_run(FULL, d, device="cpu")
    assert [m.n for m in resumed.steps] == [m.n for m in full.steps[2:]]
    assert resumed.final_n == full.final_n
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  multiset_with_ids(full.state))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "ck")
    head = jrt.run_pic(jax_config(FULL.replace(poisson_steps=2)),
                       print_header=False)
    jck.save_npz(os.path.join(d, "step_000002.npz"), head.state, 2)
    resumed = checkpoint.resume_run(FULL, d, device="cpu")
    full = run_pic(FULL, print_header=False, device="cpu")
    ref = jrt.run_pic(jax_config(FULL), print_header=False)
    assert resumed.final_n == full.final_n == ref.final_n
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  multiset_with_ids(full.state))
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  j_ids(ref.state))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    d = str(tmp_path / "ck")
    head = run_pic(FULL.replace(poisson_steps=2), print_header=False,
                   device="cpu")
    checkpoint.save_npz(os.path.join(d, "step_000002.npz"), head.state, 2)
    resumed = jck.resume_run(jax_config(FULL), d)
    ref = jrt.run_pic(jax_config(FULL), print_header=False)
    assert resumed.final_n == ref.final_n
    assert [m.n for m in resumed.steps] == [m.n for m in ref.steps[2:]]
    np.testing.assert_array_equal(j_ids(resumed.state), j_ids(ref.state))
    np.testing.assert_array_equal(
        j_ids(resumed.state),
        multiset_with_ids(run_pic(FULL, print_header=False,
                                  device="cpu").state))


def test_resume_errors(tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        checkpoint.resume_run(FULL, d, device="cpu")
    checkpoint.save_npz(os.path.join(d, "step_000004.npz"),
                        setup_particles(FULL, device="cpu"), 4)
    with pytest.raises(ValueError, match="beyond"):
        checkpoint.resume_run(FULL, d, device="cpu")


def test_interop_fields_are_the_jax_checkpoint_fields():
    assert interop.FIELDS == jck._FIELDS


# ---- float64 checkpoints (precision="f64") --------------------------------

F64 = FULL.replace(precision="f64")


@contextlib.contextmanager
def x64():
    """JAX's float64 mode, restored in ``finally`` (tests/test_oracle.py)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_f64_checkpoint(d):
    """A float64 npz written by JAX's ``save_npz`` after 2 steps of an x64
    run, and JAX's own x64 resume of it."""
    with x64():
        head = jrt.run_pic(jax_config(F64.replace(poisson_steps=2)),
                           print_header=False)
        assert head.state.pos.dtype == np.float64
        jck.save_npz(os.path.join(d, "step_000002.npz"), head.state, 2)
        ref = jck.resume_run(jax_config(F64), d)
        return ref, np.asarray(ref.state.pos), np.asarray(ref.state.vel)


def test_jax_f64_checkpoint_resumes_in_the_port_f64(tmp_path):
    d = str(tmp_path / "ck")
    ref, ref_pos, ref_vel = _jax_f64_checkpoint(d)
    resumed = checkpoint.resume_run(F64, d, device="cpu")
    assert resumed.state.pos.dtype == torch.float64
    assert [m.n for m in resumed.steps] == [m.n for m in ref.steps]
    assert resumed.final_n == int(ref.state.n)
    n = resumed.final_n
    want = interop.state_from_numpy(
        {f: np.asarray(getattr(ref.state, f)) for f in interop.FIELDS},
        "cpu", torch.float64)
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  multiset_with_ids(want))
    np.testing.assert_array_equal(resumed.state.pos[:n].numpy(), ref_pos[:n])
    np.testing.assert_array_equal(resumed.state.vel[:n].numpy(), ref_vel[:n])
    # and the uninterrupted f64 run of the port
    full = run_pic(F64, print_header=False, device="cpu")
    np.testing.assert_array_equal(multiset_with_ids(full.state),
                                  multiset_with_ids(resumed.state))


def test_jax_f64_checkpoint_converts_by_value_under_f32(tmp_path):
    """The same float64 file under an f32 config: rounded by value, as
    JAX's ``load_npz`` with x64 off rounds it (the port read the float64
    words as float32 bit patterns before its repair)."""
    d = str(tmp_path / "ck")
    _jax_f64_checkpoint(d)
    path = os.path.join(d, "step_000002.npz")
    jstate, _ = jck.load_npz(path)  # x64 off: float32 by value
    assert jstate.pos.dtype == np.float32
    got, step = checkpoint.load_npz(path, "cpu")
    assert step == 2 and got.pos.dtype == torch.float32
    for f in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)
    resumed = checkpoint.resume_run(FULL, d, device="cpu")
    ref = jck.resume_run(jax_config(FULL), d)
    assert [m.n for m in resumed.steps] == [m.n for m in ref.steps]
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  j_ids(ref.state))


def test_port_f64_checkpoint_resumes(tmp_path):
    d = str(tmp_path / "ck")
    full = run_pic(F64.replace(verbose=1), print_header=False, device="cpu",
                   on_step=checkpoint.make_checkpoint_hook(F64, d))
    with np.load(os.path.join(d, "step_000002.npz")) as z:
        assert z["pos"].dtype == z["vel"].dtype == np.float64
        assert z["acc"].dtype == np.float32
    for t in (3, 4):
        os.remove(os.path.join(d, f"step_{t:06d}.npz"))
    resumed = checkpoint.resume_run(F64, d, device="cpu")
    assert [m.n for m in resumed.steps] == [m.n for m in full.steps[2:]]
    np.testing.assert_array_equal(multiset_with_ids(resumed.state),
                                  multiset_with_ids(full.state))
    with pytest.raises(ValueError, match="initial_state holds"):
        run_pic(FULL, print_header=False, initial_state=resumed.state)
