"""Stitch the PNG snapshots into a GIF (counterpart of the JAX package's
to_gif; reference analyse/to_gif.py).

    python -m particle_simulation_tpu_torch.analyse.to_gif [src] [out.gif]

``src`` defaults to ``out/visualization`` (where the CLI's verbose runs
write their PNGs), the GIF to ``out/torch/result.gif``.
"""
import glob
import os
import sys


def main(src: str = "out/visualization",
         out: str = "out/torch/result.gif") -> int:
    """Write the GIF; return its frame count."""
    from PIL import Image

    frames = [Image.open(p) for p in sorted(glob.glob(f"{src}/*.png"))]
    if not frames:
        raise SystemExit(f"no frames under {src}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    print(f"{out} ({len(frames)} frames)")
    return len(frames)


if __name__ == "__main__":
    main(*sys.argv[1:])
