"""Device kernels a forward in the traced window (copies not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.queries:
        return None
    return len(t.kernels) / t.queries
