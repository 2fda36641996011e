"""Offline analysis of the port's runs (counterpart of
``particle_simulation_tpu/analyse``, the reference's analyse/*.py): plots
over the timing CSV of ``observability.CSV_HEADER``, the collision-chance
sweep, the validation against the branching process, the rng histogram
and the GIF of the PNG snapshots.  pandas, matplotlib and PIL are imported
inside the functions that use them, so every module imports where they
are not installed; the default outputs go under ``out/torch/``."""
