"""train_mfu: model FLOPs of the window's steps (matmuls and attention
over the valid frames and tokens, x3 for forward and backward; see
benchmark/flops.py) per second of the window, as a share of one H100's
bf16 peak (layer: train/loop.TrainStep, models/*, train/optim.py)."""

from benchmark.flops import BF16_FLOP_PER_S, train_step_flops


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    flops = sum(train_step_flops(step, ctx["config"]) for step in ctx["steps"])
    return 100.0 * flops / ctx["window_s"] / BF16_FLOP_PER_S
