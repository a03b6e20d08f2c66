"""decode_batch_ms: the mean time of the harness's span around
Recognizer.decode_batch_nbest over the batches that ended in the window
(layer: decode/recognizer.py and the decode loop it runs)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["spans"]:
        return None
    return 1e3 * sum(b - a for a, b, _ in ctx["spans"]) / len(ctx["spans"])
