"""Physical constants and status codes (counterpart of
``particle_simulation_tpu/constants.py``; the values are identical).

Reference: electron charge/mass src/electron.h:9-10, cell size, epsilon0
and pi src/cell.h:5-7, the grid and force constant src/cell.cu:3-5, the
status protocol src/electron.h:8 and src/pic.cu:167-176.
"""

ELECTRON_CHARGE = -1.602176487e-19  # Coulombs
ELECTRON_MASS = 9.1093837015e-31  # kg
EPSILON0 = 8.8541878176e-12
PI = 3.1415926536

DEFAULT_CELL_SIZE = 1e-2  # metres per grid cell edge
DEFAULT_GRID_SIZE = (512, 512, 512)
DEFAULT_MOBILITY_DT = 1e-12  # seconds; reference src/pic.cu:371
DEFAULT_SEED = 39587  # reference src/random.cu:4

# Status ("timestamp") protocol, identical codes to the reference:
#   0    -> slot empty / unpublished
#   -1   -> alive since the start of the current Poisson step
#   t>0  -> spawned at mobility step t of the current Poisson step
#   -2   -> dead (absorbed or out of bounds)
STATUS_EMPTY = 0
STATUS_ALIVE = -1
STATUS_DEAD = -2


def electric_force_constant(cell_size: float = DEFAULT_CELL_SIZE) -> float:
    """e^2 / (4 pi eps0 cell_size^2 m_e)  [reference src/cell.cu:5]."""
    return (ELECTRON_CHARGE * ELECTRON_CHARGE) / (
        4 * PI * EPSILON0 * cell_size * cell_size * ELECTRON_MASS
    )
