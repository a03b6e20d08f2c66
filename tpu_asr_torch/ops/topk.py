"""Exact top-k with the reference's tie order (port of tpu_asr/ops/topk.py).

`lax.top_k` breaks ties by the SMALLEST index; `torch.topk` promises no
tie order. The beam search depends on the order whenever several
candidates sit at NEG_INF (finished beams, beams 1..W-1 at step 0), so
this takes a stable descending sort — equal values keep their index
order — and slices the first k.
"""

from __future__ import annotations

import torch


def exact_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries over the last axis,
    ties broken by the smallest index (jax.lax.top_k semantics)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
