"""decode_mfu: the model FLOPs that the answers of the window need, over
the window, as a share of one H100's bf16 peak: encoder and CTC head
over each request's valid frames, plus the decoder over its answer's
tokens and end for each of the beam's hypotheses (the work the search
needs, not the steps an implementation ran; benchmark/flops.py) (layer:
models/* in decode)."""

from benchmark.flops import BF16_FLOP_PER_S, decoder_flops, encoder_flops


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["answered"]:
        return None
    c, w = ctx["config"], ctx["decode"]["beam"]
    flops = sum(encoder_flops(t, c) + w * decoder_flops(t, u + 1, c)
                for t, u in ctx["answered"])
    return 100.0 * flops / ctx["window_s"] / BF16_FLOP_PER_S
