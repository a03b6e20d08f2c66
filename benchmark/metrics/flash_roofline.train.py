"""flash_roofline.train: the least time of the traced training steps'
attention forward, dq and dk/dv work on one H100 (benchmark/flops.py,
from each utterance's valid lengths: the transformer encoder's self-
attention, the decoder's causal self-attention and its cross-attention,
at the configuration's heads and head size) over the device time of the
flash kernels in the trace (layer: ops/flash_attention.py +
csrc/flash_attention*.cu)."""

from benchmark.flops import (flash_bwd_bound_s, flash_fwd_bound_s,
                             subsampled)
from benchmark.trace import kernel_seconds

KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv")


def call_bound(tq, tk, h, dh, causal):
    return (flash_fwd_bound_s(tq, tk, h, dh, causal)
            + flash_bwd_bound_s(tq, tk, h, dh, causal, "dq")
            + flash_bwd_bound_s(tq, tk, h, dh, causal, "dkv"))


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("trace"):
        return None
    c = ctx["config"]
    h, dh = c["num_heads"], c["d_model"] // c["num_heads"]
    bound = 0.0
    for step in ctx["traced_steps"]:
        for t, u in step:
            te, ud = subsampled(t), u + 1
            if c["encoder_type"] == "transformer":
                bound += c["num_enc_layers"] * call_bound(te, te, h, dh, False)
            bound += c["num_dec_layers"] * (call_bound(ud, ud, h, dh, True)
                                            + call_bound(ud, te, h, dh, False))
    spent = kernel_seconds(ctx["trace"], KERNELS)
    return 100.0 * bound / spent if spent > 0 else None
