"""server_p95_ms: the 95th percentile of the latency of every request
answered in the window, each timed by the client's clock from its
submit call (layer: serve.AsrServer)."""

import numpy as np


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(ctx["latencies_s"], 95))
