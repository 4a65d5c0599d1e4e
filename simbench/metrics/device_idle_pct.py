"""The share of a traced sweep's wall in which nothing ran on the
device."""
from simbench.devtrace import busy_ns


def read(cap):
    lo, hi = cap.window
    if not cap.device or hi <= lo:
        return None
    return 100.0 * (1 - busy_ns(cap, lo, hi) / (hi - lo))
