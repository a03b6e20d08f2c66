"""queue_wait_ms: the mean wait of a request from AsrServer.submit to the
start of its batch's decode (the collection window and the groups
decoded before it), from the server's `queue_wait_s` and `requests`
counters over the window (layer: serve.AsrServer)."""


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    s0, s1 = ctx.get("stats0") or {}, ctx.get("stats1") or {}
    if "queue_wait_s" not in s0 or "queue_wait_s" not in s1:
        return None
    reqs = s1["requests"] - s0["requests"]
    if reqs <= 0:
        return None
    return 1e3 * (s1["queue_wait_s"] - s0["queue_wait_s"]) / reqs
