"""prefix_scan_roofline.serve: over the batches decoded wholly inside
the traced stretch, the least time on one H100 of the CTC prefix scores
that the joint beam needs (for each request, each of its answer's
tokens and its end, each of the beam's hypotheses scores the 2W
attention candidates over the valid encoder frames, keeping the forward
histories (eos takes no scan); benchmark/flops.py) over the device time of the
prefix-scan kernel launched in those batches (layer: ops/ctc_prefix.py +
csrc/ctc_prefix_scan.cu)."""

from benchmark.flops import prefix_scan_bound_s, subsampled
from benchmark.trace import marked_batches

KERNELS = ("ctc_prefix_scan_kernel",)


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("trace") \
            or ctx["decode"]["mode"] != "joint":
        return None
    w = ctx["decode"]["beam"]
    k = 2 * w
    bound = spent = 0.0
    for rows, kernels in marked_batches(ctx["trace"], "decode_batch",
                                        "decode_rows"):
        bound += sum((u + 1) * w * prefix_scan_bound_s(subsampled(t), k,
                                                       True)
                     for t, u in rows)
        spent += sum(d for n, _, d in kernels
                     if any(x in n for x in KERNELS)) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
