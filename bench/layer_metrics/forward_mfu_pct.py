"""The whole forward's share of the card's bf16 dense peak: the model's
FLOPs (convs and head, `costs`) times the timed window's images, over its
seconds and the peak."""

import costs


def read(run):
    if run.window is None or run.window.seconds <= 0:
        return None
    flops = costs.model_flops_per_image(run.config) * run.window.images
    return 100.0 * flops / run.window.seconds / costs.PEAK_FLOPS
