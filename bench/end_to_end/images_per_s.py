"""Images whose logits reached the host in the timed window, over the
window: from the first query's issue to the last one's logits."""


def read(run):
    return run.window.images_per_s if run.window.done else None
