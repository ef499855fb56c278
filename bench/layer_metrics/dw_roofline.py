"""The depthwise convs' share of their roofline: the sum over one
forward's depthwise convs (``groups > 1``) of max(FLOP / peak, bytes / HBM
bandwidth) (`costs`), over the device time a forward inside the program's
``cnn.dwconv`` spans, which hold each depthwise conv and its bias add
(`spans`).  Nothing without a whole trace, without depthwise convs or
without a ``cnn.dwconv`` span."""

import costs
import spans


def read(run):
    t = run.trace
    bound = sum(costs.conv_bound_s(c) for c in run.convs if c["groups"] > 1)
    if t is None or bound <= 0:
        return None
    by = spans.device_ms_a_forward(t)
    ms = None if by is None else by.get("cnn.dwconv")
    return 100.0 * bound / (ms * 1e-3) if ms else None
