"""The 90th percentile of the episodes' wall times, from the call of
``runtime.run_pic`` to its return (which synchronises), in ms."""

import numpy as np


def read(r):
    if not r.episode_s:
        return None
    return float(np.percentile(np.asarray(r.episode_s), 90)) * 1e3
