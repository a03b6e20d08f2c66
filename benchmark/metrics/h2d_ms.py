"""h2d_ms: the host-to-device copies of a training batch per traced
step, the summed durations of the program's `train.h2d` spans over the
steps of the traced stretch (layer: train/loop.batch_features, read on
the profiler's clock)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("traced_steps") \
            or not ctx.get("trace"):
        return None
    durs = [m[2] for m in ctx["trace"]["marks"] if m[0] == "train.h2d"]
    if not durs:
        return None
    return sum(durs) / 1e3 / len(ctx["traced_steps"])
