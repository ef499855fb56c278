"""Host milliseconds a forward inside the program's ``cnn.forward`` span:
the time to enqueue one forward in the traced window.  The profiler's
host cost is included, and it can double the untraced figure, which the
program's ring buffer (``REPRO_TRACE=1``, no profiler) gives.  Nothing
without a whole trace or without the program's spans."""

import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    fw = spans.forwards(t)
    return sum(b - a for a, b in fw) * 1e-3 / len(fw) if fw else None
