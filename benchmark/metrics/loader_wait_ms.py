"""loader_wait_ms: mean host wait on the training loader's next() per
step of the window, timed by the harness's clock around each call
(layer: data/loader.py, data/bucketing.py)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    return 1e3 * ctx["loader_wait_s"] / len(ctx["steps"])
