"""The requantization's share of its byte bound: each element of the maps
one forward requantizes (`requant_maps`) read twice and written once, in
float32 (12 B: the kernel's max pass reads a map, its quantize pass reads
it again and writes it), over the HBM bandwidth (`costs`), over the device
time a forward inside the program's ``cnn.requant`` spans (`spans`).  Both
the signed requantization (ConvNeXt-T) and the ReLU one (VGG-16) are read.
Nothing without a whole trace, without the program's spans or without a
``cnn.requant`` span."""

import costs
import requant_maps
import spans

BYTES = 3 * costs.ACT_BYTES   # two reads of an element and one write


def read(run):
    t = run.trace
    if t is None:
        return None
    by = spans.device_ms_a_forward(t)
    ms = None if by is None else by.get("cnn.requant")
    if not ms:
        return None
    n = requant_maps.requant_elements(run.config, run.traffic["batch"])
    return 100.0 * BYTES * n / costs.HBM_BYTES_PER_S / (ms * 1e-3)
