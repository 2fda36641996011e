"""Command-line entry point (counterpart of ``particle_simulation_tpu/cli.py``)
with the reference's 8-argument positional contract.

Reference (run:1-9, src/main.cu:8-47):
    main MODE VERBOSE INIT_N MAX_T BLOCK_SIZE MAX_N SLEEP_TIME POISSON_TS
with MODE in {bench, 30 (Dynamic), 31 (CPU Sync), 32 (Naive),
33 (Dynamic Old), test}.

Usage:  python -m particle_simulation_tpu_torch 30 0 1000000 10 256 50000000 100 100
Keyword overrides after the positional args: grid=, cs=, seed=, field=,
bfield=, gridmode=, precision=, ckpt=DIR (npz checkpoints on the verbose
cadence), platform=cpu|cuda (the device; the card by default), bucket=
(accepted, no effect: the port needs no capacity ladder), mesh= (only 0:
multi-GPU runs are not ported yet); bench mode: profile=ci|quick|full and
resume=0/1.  Any other scalar SimConfig field is accepted as key=value,
coerced by the field's type; unknown keys are an error, and so is a model
selection the port does not run yet (config.check_supported).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

from .config import SCHEDULER_MODES, SimConfig, check_supported


@dataclasses.dataclass
class CliOptions:
    mode: str
    config: SimConfig
    ckpt_dir: str = ""
    bench_profile: str = "full"   # bench mode: profile=ci|quick|full
    bench_resume: bool = False    # bench mode: resume=1 continues the CSV
    device: Optional[str] = None  # platform=cpu|cuda; None: the card


def parse_args(argv) -> CliOptions:
    mode = argv[0]
    cfg = SimConfig()
    positional = [a for a in argv[1:] if "=" not in a]
    if mode in SCHEDULER_MODES or mode == "test":
        # the reference requires all 8 positional args (src/main.cu:10-24);
        # accept mode-only for defaults but reject partial arg lists
        if positional and len(positional) != 7:
            raise SystemExit(
                "usage: MODE VERBOSE INIT_N MAX_T BLOCK_SIZE MAX_N "
                "SLEEP_TIME POISSON_TS [key=value ...]\n"
                f"got {len(positional) + 1} positional args, need 8"
            )
    if len(positional) == 7:
        cfg = cfg.replace(
            verbose=int(positional[0]),
            init_n=int(positional[1]),
            poisson_steps=int(positional[2]),
            block_size=int(positional[3]),
            capacity=int(positional[4]),
            sleep_time_ns=int(positional[5]),
            poisson_timestep=int(positional[6]),
        )
    opts = CliOptions(mode=mode, config=cfg)
    for extra in argv[1:]:
        if "=" not in extra:
            continue
        key, _, val = extra.partition("=")
        if key == "grid":
            g = int(val)
            cfg = cfg.replace(grid_size=(g, g, g))
        elif key == "cs":
            cfg = cfg.replace(cross_section_path=val)
        elif key == "seed":
            cfg = cfg.replace(seed=int(val))
        elif key == "precision":
            cfg = cfg.replace(precision=val)
        elif key == "field":
            cfg = cfg.replace(field_model=val)
        elif key == "bfield":
            # uniform cyclotron vector Ω = qB/m (rad/s) for integrator=boris
            parts = tuple(float(x) for x in val.split(","))
            if len(parts) != 3:
                raise SystemExit("bfield takes three comma-separated floats")
            cfg = cfg.replace(b_field=parts)
        elif key == "gridmode":
            cfg = cfg.replace(grid_mode=val)
        elif key == "ckpt":
            opts.ckpt_dir = val
        elif key == "mesh":
            if int(val):
                raise SystemExit(
                    f"mesh={val}: multi-GPU runs are not ported yet "
                    "(ROADMAP.md Queue 1 item 7)")
        elif key == "bucket":
            int(val)  # accepted as in the JAX CLI; the port has no ladder
        elif key == "profile":
            if val not in ("ci", "quick", "full"):
                raise SystemExit("profile must be ci, quick, or full")
            opts.bench_profile = val
        elif key == "resume":
            opts.bench_resume = bool(int(val))
        elif key == "platform":
            if val not in ("cpu", "cuda"):
                raise SystemExit("platform must be cpu or cuda")
            opts.device = val
        else:
            # any scalar SimConfig field (e.g. spawn_depth=1,
            # bbox_subgrid=0) coerced by its default's type; unknown keys
            # stay a hard error
            default = getattr(cfg, key, None)
            if isinstance(default, bool):
                cfg = cfg.replace(**{key: bool(int(val))})
            elif isinstance(default, int):
                cfg = cfg.replace(**{key: int(val)})
            elif isinstance(default, float):
                cfg = cfg.replace(**{key: float(val)})
            elif isinstance(default, str):
                cfg = cfg.replace(**{key: val})
            else:
                raise SystemExit(f"unknown override {extra!r}")
    if mode in SCHEDULER_MODES:
        cfg = cfg.replace(scheduler=SCHEDULER_MODES[mode])
    try:
        check_supported(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    opts.config = cfg
    return opts


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    start = time.perf_counter()
    opts = parse_args(argv)
    mode, cfg = opts.mode, opts.config

    if mode == "bench":
        from .benchmarks import run_benchmark

        run_benchmark(profile=opts.bench_profile, resume=opts.bench_resume,
                      device=opts.device)
    elif mode in SCHEDULER_MODES:
        from .observability import make_log_hook
        from .runtime import run_pic

        hook = make_log_hook(cfg)
        if opts.ckpt_dir:
            from .checkpoint import make_checkpoint_hook

            ckpt_hook = make_checkpoint_hook(cfg, opts.ckpt_dir)
            log_hook = hook

            def hook(t, state):
                log_hook(t, state)
                ckpt_hook(t, state)

            if not cfg.verbose:
                cfg = cfg.replace(verbose=1)
        run_pic(cfg, on_step=hook, device=opts.device)
    elif mode == "test":
        from .testing import run_unit_test

        if not run_unit_test(cfg, device=opts.device):
            return 1
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"CPU time of program: {(time.perf_counter() - start) * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
