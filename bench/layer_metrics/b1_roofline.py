"""Kernel B1's share of its roofline over the traced window: the sum over
the window's convs of max(FLOP / peak, bytes / HBM bandwidth) (`costs`),
over the sum of B1's device time.  Nothing without a whole trace or
without B1 on the path."""

import costs


def read(run):
    t = run.trace
    if t is None:
        return None
    kernel_s = sum(dur for _, _, dur, _ in t.b1_kernels()) * 1e-6
    if kernel_s <= 0:
        return None
    bound = sum(costs.conv_bound_s(c) for c in run.convs) * t.queries
    return 100.0 * bound / kernel_s
