"""encode_issue_ms: the mean host time of the program's
`recognizer.encode` span a batch in the traced stretch, on the
profiler's clock (layer: recognizer and decode loop, the batcher
thread in decode/recognizer.Recognizer._encode).

Nothing in the span synchronizes, so this is the time the host takes
to issue the frontend's features through the encoder (and, in the joint
mode, the CTC head's log-softmax), not the device time of that work:
the launches, plus any wait of the host for room in a full launch queue
when the device runs behind. Fewer or cheaper launches (an encoder
captured as a CUDA graph, fused kernels) lower it; a faster kernel on
the device does not."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    durs = [m[2] for m in ctx["trace"]["marks"]
            if m[0] == "recognizer.encode"]
    if not durs:
        return None
    return sum(durs) / 1e3 / len(durs)
