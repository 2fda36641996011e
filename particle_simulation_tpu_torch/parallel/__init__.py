"""Multi-GPU runs on ``torch.distributed`` (counterpart of
``particle_simulation_tpu/parallel``): ``sharded`` the step, ``launch`` the
processes, one a rank."""
