"""Observability (counterpart of ``particle_simulation_tpu/observability.py``):
verbose state dumps, PNG snapshots, CSV timing output.

Reference equivalents (src/utility.cu):
  * log(): copy the state to the host every ``verbose`` Poisson steps,
    print every electron, render a PNG scatter (:124-137);
  * image()/draw_particle(): an x/y scatter to
    out/visualization/test_%04d.png (:4-74);
  * printCSV(): the timing CSV with the header ``CSV_HEADER`` (:87-106),
    kept identical so the reference's analyse/ scripts read our output.

PNGs are written by a minimal pure-Python encoder (8-bit RGB, one IDAT,
filter 0 on every row); ``read_png`` decodes that format back to pixels.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, List

import numpy as np

CSV_HEADER = (
    "func,init n,iterations,mobility steps,block size,sleep time,"
    "split chance,final n,time"
)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        _PNG_SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as ``write_png`` writes it (8-bit RGB, not interlaced,
    filter 0 on every row) to an (H, W, 3) uint8 array; raise ValueError
    for any other file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, b""
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG ({header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size != h * (1 + 3 * w):
        raise ValueError(f"{path}: {rows.size} pixel bytes for {w}x{h}")
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def render_particles(pos: np.ndarray, sim_size,
                     resolution: int = 512) -> np.ndarray:
    """x/y scatter of particles on a black background (white dots), the
    reference's visualization (draw_particle plots position.x vs position.y,
    src/utility.cu:28-43)."""
    img = np.zeros((resolution, resolution, 3), np.uint8)
    if len(pos):
        xs = np.clip((pos[:, 0] / sim_size[0] * resolution).astype(np.int64),
                     0, resolution - 1)
        ys = np.clip((pos[:, 1] / sim_size[1] * resolution).astype(np.int64),
                     0, resolution - 1)
        img[resolution - 1 - ys, xs] = 255
    return img


def make_log_hook(config, out_dir: str = "out/visualization",
                  print_particles=None):
    """Returns on_step(t, state) matching the reference's log() behavior."""
    if print_particles is None:
        print_particles = config.verbose > 0 and config.init_n <= 10_000

    def on_step(t, state):
        n = state.n
        pos = state.pos[:n].cpu().numpy()
        print(f"Amount of particles: {n}")
        if print_particles:
            vel = state.vel[:n].cpu().numpy()
            acc = state.acc[:n].cpu().numpy()
            status = state.status[:n].cpu().numpy()
            for i in range(len(pos)):
                print(
                    f"{i}: ({pos[i,0]:.15f}, {pos[i,1]:.15f}, {pos[i,2]:.15f}) "
                    f"({vel[i,0]:.15f}, {vel[i,1]:.15f}, {vel[i,2]:.15f}) "
                    f"(({acc[i,0]:.7f}, {acc[i,1]:.7f}, {acc[i,2]:.7f})) "
                    f"[{status[i]}]"
                )
        os.makedirs(out_dir, exist_ok=True)
        img = render_particles(pos, config.sim_size)
        write_png(os.path.join(out_dir, f"test_{t:04d}.png"), img)

    return on_step


def write_timing_csv(runs: Iterable, path: str) -> None:
    """``runs`` is an iterable of runtime.RunData."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines: List[str] = [CSV_HEADER]
    for r in runs:
        lines.append(csv_row(r))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def csv_row(run) -> str:
    """One RunData as a row of ``CSV_HEADER``; the split chance column is
    a dead field in the reference too (SURVEY.md §5.5)."""
    c = run.config
    return (f"{run.function},{c.init_n},{c.poisson_steps},"
            f"{c.poisson_timestep},{c.block_size},{c.sleep_time_ns},0,"
            f"{run.final_n},{run.device_time_ms}")
