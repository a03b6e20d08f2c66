"""device_idle.train: the share of the traced stretch of a training
window in which no kernel, copy or memset ran on the card (layer:
device)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("trace"):
        return None
    s = ctx["trace"]
    return 100.0 * (1.0 - s["busy_s"] / s["span_s"])
