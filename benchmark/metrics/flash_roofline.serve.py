"""flash_roofline.serve: over the batches decoded wholly inside the
traced stretch, the least time of the encoder's self-attention forward
on one H100 (each request's valid encoder frames, the configuration's
heads; benchmark/flops.py) over the device time of the flash forward kernels
launched in those batches (layer: ops/flash_attention.py +
csrc/flash_attention.cu)."""

from benchmark.flops import flash_fwd_bound_s, subsampled
from benchmark.trace import marked_batches

KERNELS = ("flash_attention_fwd",)


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    c = ctx["config"]
    if c["encoder_type"] != "transformer" or not c.get("use_pallas"):
        return None
    h, dh = c["num_heads"], c["d_model"] // c["num_heads"]
    bound = spent = 0.0
    for rows, kernels in marked_batches(ctx["trace"], "decode_batch",
                                        "decode_rows"):
        bound += sum(c["num_enc_layers"] * flash_fwd_bound_s(
            subsampled(t), subsampled(t), h, dh, False) for t, _ in rows)
        spent += sum(d for n, _, d in kernels
                     if any(k in n for k in KERNELS)) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
