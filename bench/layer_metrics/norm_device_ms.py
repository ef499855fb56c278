"""Device milliseconds a forward of the kernels launched inside the
program's ``cnn.norm`` spans: its LayerNorms (`spans`; a forward whose
launches and device events do not pair is left out).  Nothing without a
whole trace, without the program's spans or without a ``cnn.norm``
span."""

import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    by = spans.device_ms_a_forward(t)
    return None if by is None else by.get("cnn.norm")
