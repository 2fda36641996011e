"""The model menu (counterpart of ``particle_simulation_tpu/models``).

Each model is a ``SimConfig`` selection, run by every scheduler of the
port (the plain cadences on any device and both CUDA engines):

* integrator: ``leapfrog`` (the reference's kick-drift-kick) or ``boris``
  (the full kick, then the drift; with ``b_field``, the cyclotron vector
  Omega = qB/m in rad/s, the Boris rotation between the half-kicks):
  ``ops.physics.leapfrog`` and ``boris``, ``csrc/physics.cuh``;
* collision_model: ``reverse`` (the child copies the moved lane, whose
  velocity flips) or ``isotropic`` (the child leaves at the lane's speed
  in a direction drawn from its own id words; the lane keeps its
  velocity);
* boundary: ``absorb`` (out of bounds kills before the roll) or
  ``periodic`` (``ops.physics.wrap_periodic``);
* init_vth: the thermal start, each velocity component
  ``init_vth * N(0, 1)`` (``rng.setup_gaussian``);
* field_model: ``neighbour`` (the reference's stencil, ``ops/grid.py``) or
  ``fft`` (the spectral Poisson solve, ``poisson_fft``);
* the cross-section table: a file, or ``cross_section.physical_table``
  and ``argon_like_table`` written with ``write_table``.

``config.MODEL_VALUES`` lists the values; ``config.check_supported``
refuses any other.  As the JAX package's ``models`` does, this package
re-exports the integrators and the field paths and names the collision
and field models.
"""

from ..config import MODEL_VALUES
from ..ops.grid import (  # noqa: F401
    deposit,
    gather_acceleration,
    gather_acceleration_packdiff,
    gather_acceleration_packed,
)
from ..ops.physics import INTEGRATORS, boris, leapfrog  # noqa: F401
from . import poisson_fft  # noqa: F401

COLLISION_MODELS = MODEL_VALUES["collision_model"]
FIELD_MODELS = MODEL_VALUES["field_model"]
