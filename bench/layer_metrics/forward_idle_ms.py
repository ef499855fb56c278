"""Device-idle milliseconds a forward while the host is inside the
program's ``cnn.forward`` span, in the profiled window (whose host cost
moves it): each idle gap of the traced window counts
where its midpoint falls, as `traced.Traced.idle_gaps` places it
(`spans`).  Nothing without a whole trace or without the program's
spans."""

import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    fw = spans.forwards(t)
    return spans.forward_idle_us(t) * 1e-3 / len(fw) if fw else None
