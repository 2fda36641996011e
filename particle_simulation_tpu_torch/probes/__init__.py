"""Microbenchmarks and probes of the port's kernels on the card
(counterparts of the JAX package's ``scripts/`` probes).  Each runs with
``python -m particle_simulation_tpu_torch.probes.<name>`` and needs CUDA."""
