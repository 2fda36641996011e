"""Utilities of the port (counterpart of ``particle_simulation_tpu/utils``)."""
