"""ctc_loss_roofline.train: the least time of the traced steps' CTC
forward and backward work on one H100 (benchmark/flops.py, each
utterance's encoder frames and labels) over the device time of the CTC
loss kernels in the trace (layer: ops/ctc_loss.py + csrc/ctc_loss.cu)."""

from benchmark.flops import ctc_bound_s, subsampled
from benchmark.trace import kernel_seconds

KERNELS = ("ctc_alpha", "ctc_beta_grad")
EXCLUDE = ("probe",)


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("trace"):
        return None
    bound = sum(ctc_bound_s(subsampled(t), u, False)
                + ctc_bound_s(subsampled(t), u, True)
                for step in ctx["traced_steps"] for t, u in step)
    spent = kernel_seconds(ctx["trace"], KERNELS, EXCLUDE)
    return 100.0 * bound / spent if spent > 0 else None
