"""cross_kv_issue_ms: the mean host time of the program's
`decoder.cross_kv` span a batch in the traced stretch (every decoder
layer's cross-attention K/V of a batch's encoder output, written into
the beam's buffers once a batch), on the profiler's clock (layer:
recognizer and decode loop, the batcher thread in models/decoder.py's
and models/whisper.py's write_cross_kv). A program without the span
reads nothing.

Nothing in the span synchronizes, so this is the time the host takes
to issue two projections a decoder layer, not their device time: the
launches, plus any wait for room in a full launch queue while the
encoder's work is still running. One projection for all layers at once
lowers it; a faster GEMM on the device does not."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    durs = [m[2] for m in ctx["trace"]["marks"]
            if m[0] == "decoder.cross_kv"]
    if not durs:
        return None
    return sum(durs) / 1e3 / len(durs)
