"""95th percentile of every query's latency in the timed window, from its
issue (before its images are copied in) to its logits on the host."""

import loadgen


def read(run):
    lat = run.window.latencies_ms()
    return loadgen.percentile(lat, 95) if lat else None
