"""Lane-steps advanced in the window (the episodes' pushes counters) over
all the window's seconds, re-seeding included."""


def read(r):
    return r.pushes / r.window_s if r.window_s > 0 and r.pushes else None
