"""CIF (continuous integrate-and-fire) as parallel overlap math (port of
tpu_asr/ops/cif.py).

Firing boundaries are the integer crossings of c = cumsum(alpha): frame t
gives output u the overlap of [c_{t-1}, c_t] with [u, u+1],

    w[t, u] = max(min(c_t, u+1) - max(c_{t-1}, u), 0),

and fired[u] = sum_t w[t, u] h[t]. That reproduces the sequential
accumulate-and-fire loop of the CIF paper (Dong & Xu, arXiv:1905.11235)
including the boundary-frame weight splitting.

`cif_fire` here is the plain version: it builds W [B, T, U] and takes one
float32 product. The CUDA kernel (ops/cif_fire.py) computes the same
function without W; the model and the decoders go through its dispatcher.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 products in full float32 (no TF32) inside the block, as the
    reference's Precision.HIGHEST: W comes from cumsum cancellation, and
    TF32's ~3 digits would blur the fire boundaries. Sets torch's global
    matmul precision and restores it on exit."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def scale_alphas(alphas: torch.Tensor, valid_mask: torch.Tensor,
                 target_lengths: torch.Tensor) -> torch.Tensor:
    """Training-time scaling alpha * U / sum(alpha) per utterance, so the
    number of fires equals the target length U."""
    alphas = torch.where(valid_mask, alphas, 0.0)
    total = alphas.sum(dim=-1, keepdim=True)
    return alphas * (target_lengths[..., None] / total.clamp(min=1e-6))


def quantity_loss(alphas: torch.Tensor, valid_mask: torch.Tensor,
                  target_lengths: torch.Tensor,
                  row_valid: torch.Tensor | None = None,
                  n_total: torch.Tensor | None = None) -> torch.Tensor:
    """|sum(alpha) - U| averaged over the batch (on the unscaled alphas);
    row_valid masks the loader's dummy rows; n_total, the rows to divide
    by (a data-parallel shard's global count), goes with row_valid."""
    total = torch.where(valid_mask, alphas, 0.0).sum(dim=-1)
    per = (total - target_lengths.to(total.dtype)).abs()
    if row_valid is None:
        return per.mean()
    n = (row_valid.sum() if n_total is None else n_total).clamp(min=1)
    return torch.where(row_valid, per, 0.0).sum() / n


def cif_weights(alphas: torch.Tensor, u_max: int) -> torch.Tensor:
    """[B, T] fire weights -> [B, T, u_max] frame-to-output weights."""
    c = torch.cumsum(alphas, dim=-1)
    c_prev = c - alphas
    u = torch.arange(u_max, dtype=alphas.dtype, device=alphas.device)
    lo = torch.maximum(c_prev[..., None], u)
    hi = torch.minimum(c[..., None], u + 1.0)
    # maximum, not clamp: at a tie its gradient splits in halves, as jax's
    return torch.maximum(hi - lo, torch.zeros((), dtype=lo.dtype,
                                              device=lo.device))


def cif_fire(hidden: torch.Tensor, alphas: torch.Tensor,
             u_max: int) -> torch.Tensor:
    """Plain integrate-and-fire: hidden [B, T, D] + alphas [B, T] ->
    fired [B, u_max, D], accumulated in full float32."""
    w = cif_weights(alphas, u_max)
    with full_fp32_matmul():
        return torch.einsum("btu,btd->bud", w, hidden.to(w.dtype))


def fire_count(alphas: torch.Tensor, valid_mask: torch.Tensor,
               tail_threshold: float = 0.5) -> torch.Tensor:
    """Inference-time number of fires: floor(sum alpha), plus one if the
    residual is >= tail_threshold. int32 [B]."""
    total = torch.where(valid_mask, alphas, 0.0).sum(dim=-1)
    full = torch.floor(total)
    return (full + (total - full >= tail_threshold)).to(torch.int32)
