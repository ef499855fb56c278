"""Device milliseconds a forward in every kernel that is not B1: the
activations' requantization, pools, bias and shortcut adds, the head."""

import traced


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    other = sum(d for n, _, d, _ in t.kernels if traced.B1_NAME not in n)
    return other * 1e-3 / t.queries
