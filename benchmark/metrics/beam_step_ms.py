"""beam_step_ms: the mean time of one step of the attention beam loop
(decoder step, LM step, joint scoring and prefix scan, top-k, reorder of
caches and state), the program's `beam.step` spans in the traced stretch
(layer: decode/beam.attention_beam_search, read on the profiler's
clock)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    durs = [m[2] for m in ctx["trace"]["marks"] if m[0] == "beam.step"]
    if not durs:
        return None
    return sum(durs) / 1e3 / len(durs)
