"""Seconds from the harness's first line to the first timed query: imports,
the CUDA context, the kernel build on a cold checkout, weights, packing
and the warm-up queries."""


def read(run):
    return run.setup_s
