"""Registers, stack and spills of the phase kernels' instantiations, as
``nvcc -Xptxas -v`` reports them in the build of one checkout of this
repository, with the build's time.

Each engine (``worklog_phase``, ``staged_phase``) is instantiated per spawn
depth (1-4), Threefry rounds (13, 20) and draw protocol (block2 or not),
and, where the checkout has it, per model path (``reference``: leapfrog,
absorbing box, reverse collisions; ``general``: the model menu read at run
time); the open instantiation (template depth 0, printed "open"), where
the checkout has it, reads the spawn depth and the rounds at run time.  A
checkout without the model switch reports its instantiations as
``reference``.  ``--tree`` may name another checkout (a ``git archive`` of
an earlier commit): its package is imported in place of this one and
builds its own kernels.  Run it as a file, so that ``--tree`` decides which
package loads:

    python particle_simulation_tpu_torch/probes/ptxas.py [--tree DIR]

Two checkouts' reference lines compare the main path's code before and
after a change to the kernels' sources.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, List, Tuple

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_PHASE = re.compile(r"(worklog_phase|staged_phase)ILi(\d)ELi(\d+)ELb([01])E"
                    r"(?:Lb([01])E)?")

Key = Tuple[str, int, int, bool, str]


def entry_resources(build_log: str) -> Dict[str, dict]:
    """Each entry function's (mangled name's) registers, stack frame,
    spill stores and loads (bytes), from a build's ``-Xptxas -v``
    output."""
    out: Dict[str, dict] = {}
    name = None
    for line in build_log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_key(name: str):
    """(engine, depth, rounds, block2, "reference" | "general") of a phase
    kernel's mangled name, or None for another kernel."""
    p = _PHASE.search(name)
    if p is None:
        return None
    return (p.group(1), int(p.group(2)), int(p.group(3)), p.group(4) == "1",
            "general" if p.group(5) == "1" else "reference")


def phase_resources(build_log: str) -> Dict[Key, dict]:
    """The phase kernels' entries of ``entry_resources``, by
    ``phase_key``."""
    return {phase_key(n): r for n, r in entry_resources(build_log).items()
            if phase_key(n) is not None}


def _describe(r: dict) -> str:
    return (f"{r.get('registers')} registers, stack {r.get('stack')} B, "
            f"spill stores {r.get('spill_stores')} B, loads "
            f"{r.get('spill_loads')} B")


def format_lines(build_log: str) -> List[str]:
    """One line an entry function: the phase kernels by their template
    arguments, in order, then the others by their mangled names."""
    entries = entry_resources(build_log)
    phases = sorted(((phase_key(n), r) for n, r in entries.items()
                     if phase_key(n) is not None), key=lambda kr: kr[0])
    lines = [f"{e} {path:9s} "
             f"{f'depth {d} rounds {r}' if d else 'depth and rounds open'} "
             f"block2 {int(b)}: {_describe(res)}"
             for (e, d, r, b, path), res in phases]
    lines += [f"{n}: {_describe(res)}" for n, res in sorted(entries.items())
              if phase_key(n) is None]
    return lines


def run(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    from particle_simulation_tpu_torch.ops.kernels import build

    lib = build.load()
    print(f"{os.path.abspath(tree)}: build {lib.build_seconds:.1f} s",
          flush=True)
    for line in format_lines(lib.build_log):
        print(f"  {line}", flush=True)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose kernels are built (default: this "
                    "one)")
    run(ap.parse_args(argv).tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
