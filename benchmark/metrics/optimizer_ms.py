"""optimizer_ms: the optimizer's phase of a training step per traced
step (the gradient norm, the NaN check when on, and NoamAdam.update:
clip, Adam.step, zeroing), the summed durations of the program's
`train.optimizer` spans over the steps of the traced stretch (layer:
train/loop.TrainStep, train/optim.py, read on the profiler's clock)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("traced_steps") \
            or not ctx.get("trace"):
        return None
    durs = [m[2] for m in ctx["trace"]["marks"]
            if m[0] == "train.optimizer"]
    if not durs:
        return None
    return sum(durs) / 1e3 / len(ctx["traced_steps"])
