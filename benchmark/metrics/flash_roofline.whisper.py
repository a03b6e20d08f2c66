"""flash_roofline.whisper: over the batches decoded wholly inside the
traced stretch, the least time of Whisper's encoder self-attention on
one H100 (each answered request's window: audio_ctx frames against
audio_ctx, no mask, the configuration's heads, every encoder layer;
benchmark/flops.py) over the device time of the flash forward kernels
launched in those batches (layer: ops/flash_attention.py +
csrc/flash_attention.cu). Reads nothing for a configuration that is not
Whisper's or takes no flash kernel."""

from benchmark.flops import flash_fwd_bound_s
from benchmark.trace import marked_batches

KERNELS = ("flash_attention_fwd",)


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    c = ctx["config"]
    if "audio_ctx" not in c or not c.get("use_pallas"):
        return None
    t, h = c["audio_ctx"], c["num_heads"]
    per_row = c["num_enc_layers"] * flash_fwd_bound_s(
        t, t, h, c["d_model"] // h, False)
    bound = spent = 0.0
    for rows, kernels in marked_batches(ctx["trace"], "decode_batch",
                                        "decode_rows"):
        bound += per_row * len(rows)
        spent += sum(d for n, _, d in kernels
                     if any(k in n for k in KERNELS)) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
