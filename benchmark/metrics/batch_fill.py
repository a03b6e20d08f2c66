"""batch_fill: requests decoded over rows decoded in the window, from
AsrServer.stats (each batch pads to the server's static batch size)
(layer: serve.AsrServer)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    rows = ctx["stats1"]["rows_decoded"] - ctx["stats0"]["rows_decoded"]
    reqs = ctx["stats1"]["requests"] - ctx["stats0"]["requests"]
    return reqs / rows if rows > 0 else None
