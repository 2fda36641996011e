"""The port's observability (``observability.py``) against the JAX
package's: the CSV header and rows, the rendered scatter, the PNG's decoded
pixels (the JAX package may write through its native encoder, whose bytes
may differ), and the log hook's printed lines and PNGs on the same state.
Tolerance: exact."""

import os
import struct
import zlib

import numpy as np
import pytest

from particle_simulation_tpu import observability as jobs
from particle_simulation_tpu import runtime as jrt
from particle_simulation_tpu_torch import interop, observability
from particle_simulation_tpu_torch.runtime import run_pic

from test_torch_runtime import CFG, jax_config, printed


def test_csv_header_is_the_reference_schema():
    assert observability.CSV_HEADER == jobs.CSV_HEADER


def test_timing_csv_matches_jax(tmp_path):
    cfg = CFG.replace(poisson_steps=1)
    run = run_pic(cfg, print_header=False, device="cpu")
    ref = jrt.run_pic(jax_config(cfg), print_header=False)
    ref.device_time_ms = run.device_time_ms
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    observability.write_timing_csv([run, run], a)
    jobs.write_timing_csv([ref, ref], b)
    assert open(a).read() == open(b).read()


def _positions(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    size = CFG.sim_size
    # a few outside the domain on each side: the scatter clips them
    return (rng.uniform(-0.1, 1.1, (n, 3)) * np.array(size)).astype(np.float32)


@pytest.mark.parametrize("resolution", [512, 64])
def test_render_matches_jax(resolution):
    pos = _positions()
    np.testing.assert_array_equal(
        observability.render_particles(pos, CFG.sim_size, resolution),
        jobs.render_particles(pos, CFG.sim_size, resolution))


def test_png_pixels_match_jax(tmp_path):
    img = jobs.render_particles(_positions(), CFG.sim_size, 96)
    img[3, :, 0] = np.arange(96)  # colours, not only black and white
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    observability.write_png(a, img)
    jobs.write_png(b, img)
    np.testing.assert_array_equal(observability.read_png(a), img)
    np.testing.assert_array_equal(observability.read_png(b), img)


def test_read_png_rejects_other_files(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        observability.read_png(str(bad))
    good = tmp_path / "good.png"
    observability.write_png(str(good), np.zeros((4, 5, 3), np.uint8))
    data = bytearray(good.read_bytes())
    data[20] ^= 1  # inside IHDR: its CRC no longer holds
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        observability.read_png(str(bad))
    # a row with filter 1 (sub), valid otherwise
    raw = zlib.compress(b"\x01" + bytes(15) + b"\x00" + bytes(15))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    bad.write_bytes(b"\x89PNG\r\n\x1a\n"
                    + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 2, 8, 2, 0,
                                                 0, 0))
                    + chunk(b"IDAT", raw) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter"):
        observability.read_png(str(bad))


@pytest.mark.parametrize("print_particles", [None, True, False])
def test_log_hook_matches_jax(print_particles, tmp_path):
    cfg = CFG.replace(poisson_steps=1, verbose=1)
    ref = jrt.run_pic(jax_config(cfg), print_header=False).state
    arrays = {f: np.asarray(getattr(ref, f)) for f in interop.FIELDS}
    state = interop.state_from_numpy(arrays, "cpu")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _, out = printed(observability.make_log_hook(cfg, a, print_particles),
                     3, state)
    _, ref_out = printed(jobs.make_log_hook(jax_config(cfg), b,
                                            print_particles), 3, ref)
    assert out == ref_out
    assert len(out.splitlines()) == (1 if print_particles is False
                                     else 1 + state.n)
    assert os.listdir(a) == ["test_0003.png"]
    np.testing.assert_array_equal(
        observability.read_png(os.path.join(a, "test_0003.png")),
        observability.read_png(os.path.join(b, "test_0003.png")))
