"""Host wall of a traced sweep outside its rounds: from the call to the
first round's first device operation (bucketing, trace stacking, upload,
state set-up) plus from the last round's last device operation to the
return (read-back, the host fold, the per-point summaries)."""
from simbench.devtrace import rounds_span


def read(cap):
    span = rounds_span(cap)
    if span is None:
        return None
    lo, hi = cap.window
    return ((span[0] - lo) + (hi - span[1])) / 1e6
