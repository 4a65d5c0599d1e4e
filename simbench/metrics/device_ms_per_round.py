"""The union of the device's busy intervals inside the rounds' span of
a traced sweep, per round."""
from simbench.devtrace import busy_ns, rounds_span


def read(cap):
    span = rounds_span(cap)
    if span is None:
        return None
    return busy_ns(cap, *span) / 1e6 / cap.context["rounds"]
