"""decode_mfu.whisper: the model FLOPs that the window's answers need,
over the window, as a share of one H100's bf16 peak: for each answer
Whisper's encoder over the whole 30 s window and its stem, the cross
K/V projection, and the decoder over the prompt, the answer's tokens
and the end for each of the beam's hypotheses (benchmark/
flops_whisper.py) (layer: models/whisper.py in decode). Reads nothing
for a configuration that is not Whisper's."""

from benchmark.flops import BF16_FLOP_PER_S
from benchmark.flops_whisper import request_flops


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("answered"):
        return None
    c = ctx["config"]
    if "audio_ctx" not in c:
        return None
    w = ctx["decode"]["beam"]
    flops = sum(request_flops(u, w, c) for _, u in ctx["answered"])
    return 100.0 * flops / ctx["window_s"] / BF16_FLOP_PER_S
