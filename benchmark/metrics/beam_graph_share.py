"""beam_graph_share: the share of the window's beam steps that replayed
a captured CUDA graph of the step, from the server's `beam_graph_steps`
and `beam_steps` counters over the window (layer: decode/beam.BeamGraphs,
which the Recognizer holds on the card)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    s0, s1 = ctx.get("stats0") or {}, ctx.get("stats1") or {}
    if "beam_graph_steps" not in s0 or "beam_graph_steps" not in s1:
        return None
    steps = s1["beam_steps"] - s0["beam_steps"]
    if steps <= 0:
        return None
    return (s1["beam_graph_steps"] - s0["beam_graph_steps"]) / steps
