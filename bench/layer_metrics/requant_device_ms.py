"""Device milliseconds a forward of the kernels and copies launched inside
the program's ``cnn.requant`` spans: `relu_q`'s ReLU and log
requantization (`spans`; a forward whose launches and device events do
not pair is left out).  Nothing without a whole trace, without the
program's spans, or when no forward pairs."""

import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    by = spans.device_ms_a_forward(t)
    return None if by is None else by.get("cnn.requant", 0.0)
