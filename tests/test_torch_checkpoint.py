"""npz checkpoints of the port (``checkpoint.py``): a round trip, the step
discovery, the hook, and resuming, within the port and across the two
packages: a JAX ``save_npz`` checkpoint resumes in the port and a port
checkpoint resumes in the JAX package, each equal to the uninterrupted run
(sorted multiset with ids, per-step populations; tolerance: exact)."""

import os

import numpy as np
import pytest

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
