"""beam_sync_ms: the beam loop's host sync (its early-exit read of
`finished.all()`) per step, the summed durations of the program's
`beam.sync` spans over the count of its `beam.step` spans in the traced
stretch (layer: decode/beam.attention_beam_search, read on the
profiler's clock)."""


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace"):
        return None
    marks = ctx["trace"]["marks"]
    steps = sum(1 for m in marks if m[0] == "beam.step")
    syncs = [m[2] for m in marks if m[0] == "beam.sync"]
    if not steps or not syncs:
        return None
    return sum(syncs) / 1e3 / steps
