"""Device kernels, copies and sets that start inside the rounds' span of
a traced sweep, per round."""
from simbench.devtrace import rounds_span


def read(cap):
    span = rounds_span(cap)
    if span is None:
        return None
    n = sum(1 for _, s, _ in cap.device if span[0] <= s <= span[1])
    return n / cap.context["rounds"]
