"""particle_simulation_tpu_torch: the PyTorch + CUDA port of
``particle_simulation_tpu``, for one NVIDIA Hopper GPU.

The module names mirror the JAX package's; each module's docstring names
its counterpart.  The port imports torch, numpy and the standard library,
never jax and never the JAX package.  Plain tensor code runs on the CPU and
on CUDA alike; the work-log engine (scheduler ``dynamic``) is a hand-written
CUDA kernel on CUDA tensors (ops/kernels/worklog.py, csrc/).
"""

from .config import SimConfig
from .state import SimState, setup_particles

__all__ = ["SimConfig", "SimState", "setup_particles"]
