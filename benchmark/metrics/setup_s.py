"""Process start to the first timed episode: torch, the CUDA context, the
kernel library (built in the first run of a checkout), the table and one
warm episode of each of the run's simulation seeds."""


def read(r):
    return r.setup_s
