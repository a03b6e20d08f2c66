"""Multi-head scaled-dot-product attention (port of
tpu_asr/models/attention.py).

The public layout stays JAX's [B, T, H, dh]. Masks become a FINITE
additive bias (NEG_INF = -1e30, never -inf): a length-0 dummy row, which
the server pads its static batches with, then softmaxes to a uniform row
instead of NaN. Softmax runs in float32 and is cast back to the compute
dtype, as in the reference.

With use_pallas (the config's `attention_pallas`), the full passes take
the flash formulation (ops/flash_attention.py: on the card its forward
kernel, and in training its dq and dk/dv kernels through the autograd
Function); cached decode steps always take `attend`, as in the
reference.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpu_asr_torch.models.modules import Dense
from tpu_asr_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


def attend(q, k, v, bias=None, dtype=torch.float32):
    """q [B,Tq,H,dh], k/v [B,Tk,H,dh], bias broadcastable to [B,H,Tq,Tk]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """boolean mask (True = attend allowed) -> additive bias."""
    return torch.where(mask, 0.0, NEG_INF).to(dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32,
                 param_dtype=torch.float32, use_pallas: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.d_head = d_model // num_heads
        self.compute_dtype = dtype
        self.use_pallas = use_pallas
        dense = lambda: Dense(d_model, d_model, dtype=dtype,     # noqa: E731
                              param_dtype=param_dtype)
        self.q_proj = dense()
        self.k_proj = dense()
        self.v_proj = dense()
        self.out_proj = dense()

    def _heads(self, x):
        return x.view(*x.shape[:-1], self.num_heads, self.d_head)

    def _merge(self, x):
        return self.out_proj(x.reshape(*x.shape[:-2], -1))

    def forward(self, q_in, kv_in, bias=None):
        q = self._heads(self.q_proj(q_in))
        k, v = self.project_kv(kv_in)
        if self.use_pallas:
            return self._merge(flash_attention(q, k, v, bias))
        return self._merge(attend(q, k, v, bias, dtype=self.compute_dtype))

    def project_kv(self, kv_in):
        """K/V [B, T, H, dh]: cross-attention precompute, or one new
        position's self-attention K/V for the cache append."""
        return self._heads(self.k_proj(kv_in)), self._heads(self.v_proj(kv_in))

    project_kv_step = project_kv

    def step(self, q_in, k_cache, v_cache, bias=None):
        """Single-position query against a cache.

        q_in: [B, 1, D]; k_cache/v_cache: [B, Tk, H, dh].
        """
        q = self._heads(self.q_proj(q_in))
        return self._merge(attend(q, k_cache, v_cache, bias,
                                  dtype=self.compute_dtype))
