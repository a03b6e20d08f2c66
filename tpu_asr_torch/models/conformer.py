"""Conformer encoder blocks (port of tpu_asr/models/conformer.py; Gulati
et al., arXiv:2005.08100): the pre-norm macaron layer of half FFN,
relative-position MHSA, convolution module, half FFN and a final
LayerNorm. `ModelConfig.encoder_type = "conformer"` swaps these in for
the transformer layers under every objective.

Numerics follow the reference in the compute dtype:
- relative-position scores: score = (q + u) k^T + rel_shift((q + v) p^T),
  realigned by the pad-reshape shift (`rel_shift`); divided by
  sqrt(d_head) rounded to the compute dtype, softmax in float32, cast
  back;
- the depthwise convolution is k shifted multiply-adds in the compute
  dtype, in the reference's order (not a grouped F.conv1d, whose bf16
  sums round elsewhere); its parameters keep nn.Conv1d's layout
  ([C, 1, k] weight, [C] bias);
- the conv module zeroes padded frames before the GLU and after it, so
  the outputs do not depend on the bucket's pad width; with a
  chunk-masked encoder (enc_chunk_size > 0) its padding is causal (left
  only).

The rel-pos attention has no fused kernel (none exists in the reference
either), so a `use_pallas` conformer keeps these layers plain and only
its decoder takes the flash and LN kernels. The `step` methods are the
streaming chunk steps; the encoder's chunk loop (`init_cache`,
`encode_chunk`) comes with the streaming slice.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.modules import (Dense, LayerNorm,
                                          PositionwiseFeedForward)
from tpu_asr_torch.parallel.sharding import (column_parallel, copy_to_model,
                                             local_part, row_parallel)


@functools.lru_cache(maxsize=16)
def rel_sinusoid_table(t: int, d_model: int) -> np.ndarray:
    """[2T-1, d_model] float32 embeddings of the relative distances T-1
    .. -(T-1), descending (Transformer-XL: row j encodes distance
    T-1-j). Building one at the encoder's widths takes milliseconds of
    host time, which every host-bound forward would pay, so the tables
    are cached: read-only numpy arrays that callers copy to their
    device (rel_table)."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)[:, None]
    dim = np.arange(d_model, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_model)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    table = table.astype(np.float32)
    table.flags.writeable = False
    return table


def rel_table(t: int, d_model: int, dtype, device) -> torch.Tensor:
    """rel_sinusoid_table as a tensor of `dtype` on `device` (a copy)."""
    return torch.tensor(rel_sinusoid_table(t, d_model), dtype=torch.float32,
                        device=device).to(dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] raw position scores -> [B, H, T, T] with
    out[..., i, j] = x[..., i, (T-1) + (j - i)]: column j scores the
    relative distance i - j of the descending table. Pad one column on
    the left, fold the length-2T rows over, drop the first row,
    truncate."""
    b, h, t, n = x.shape
    x = F.pad(x, (1, 0))                                  # [B, H, T, 2T]
    x = x.reshape(b, h, n + 1, t)
    x = x[:, :, 1:].reshape(b, h, t, n)
    return x[..., :t]


class RelPosMultiHeadAttention(nn.Module):
    """MHSA with Transformer-XL relative position scores. Under tensor
    parallelism (`tp` set by parallel.sharding.shard_params) the full
    pass runs on this rank's heads: q/k/v and out_proj are split as
    MultiHeadAttention's; pos_proj's weight and the [H, dh] u/v biases
    stay whole on every rank (the reference replicates them) and are
    read by head slice."""
    TP_SHARDED = {"q_proj.weight": 0, "k_proj.weight": 0,
                  "v_proj.weight": 0, "out_proj.weight": 1}
    TP_SLICED = ("q_proj.bias", "k_proj.bias", "v_proj.bias",
                 "pos_proj.weight", "u_bias", "v_bias")

    def __init__(self, c: ModelConfig):
        super().__init__()
        d, h, dh = c.d_model, c.num_heads, c.d_head
        self.d_model, self.num_heads, self.d_head = d, h, dh
        self.compute_dtype = c.dtype
        dense = lambda bias=True: Dense(d, h * dh, bias=bias,  # noqa: E731
                                        dtype=c.dtype,
                                        param_dtype=c.param_dtype)
        self.q_proj = dense()
        self.k_proj = dense()
        self.v_proj = dense()
        self.pos_proj = dense(bias=False)
        self.out_proj = Dense(h * dh, d, dtype=c.dtype,
                              param_dtype=c.param_dtype)
        self.u_bias = nn.Parameter(torch.zeros(h, dh, dtype=c.param_dtype))
        self.v_bias = nn.Parameter(torch.zeros(h, dh, dtype=c.param_dtype))
        self.tp = None       # the model axis under tensor parallelism

    def _heads(self, x):
        """[..., n * dh] -> [..., n, dh] (n: this rank's heads)."""
        return x.view(*x.shape[:-1], x.shape[-1] // self.d_head,
                      self.d_head)

    def _proj(self, dense, x):
        return dense(x) if self.tp is None else column_parallel(dense, x,
                                                                self.tp)

    def _local(self, t):
        """A whole [H, ...] tensor's rows of this rank's heads."""
        return t if self.tp is None else local_part(t, 0, self.tp)

    def _pos(self, table):
        """pos_proj of the relative table -> [2T-1, n, dh]."""
        dt = self.compute_dtype
        w = self._local(self.pos_proj.weight).to(dt)
        return self._heads(F.linear(table.to(dt), w))

    def _biased_queries(self, x):
        q = self._heads(self._proj(self.q_proj, x))
        dt = self.compute_dtype
        return (q + self._local(self.u_bias).to(dt),
                q + self._local(self.v_bias).to(dt))

    def _finish(self, content, pos_score, v, bias):
        dt = self.compute_dtype
        scale = torch.tensor(math.sqrt(self.d_head), dtype=torch.float32).to(
            dt)
        scores = (content + pos_score) / scale
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        out = out.reshape(*out.shape[:-2], -1)
        return self.out_proj(out) if self.tp is None else row_parallel(
            self.out_proj, out, self.tp)

    def forward(self, x, pos_emb, bias=None):
        """x [B, T, D], pos_emb [2T-1, D] (rel_table), bias broadcastable
        to [B, H, T, T] -> [B, T, D]."""
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        qu, qv = self._biased_queries(x)
        k = self._heads(self._proj(self.k_proj, x))
        v = self._heads(self._proj(self.v_proj, x))
        p = self._pos(pos_emb)                            # [2T-1, H, dh]
        content = torch.einsum("bqhd,bkhd->bhqk", qu, k)
        pos_score = rel_shift(torch.einsum("bqhd,nhd->bhqn", qv, p))
        return self._finish(content, pos_score, v, bias)

    def step(self, x_chunk, pos: int, k_cache, v_cache, bias=None):
        """Streaming chunk step: x_chunk [B, C, D] at global positions
        pos .. pos+C-1. Writes the chunk's K/V into rows pos .. pos+C-1
        of k_cache/v_cache [B, t_max, H, dh] in place, scores every
        cached position against the full [2 t_max - 1] table (each query
        gathers its own diagonal), and returns (out [B, C, D], k_cache,
        v_cache)."""
        b, ck, _ = x_chunk.shape
        t_max = k_cache.shape[1]
        qu, qv = self._biased_queries(x_chunk)
        k_cache[:, pos:pos + ck] = self._heads(self.k_proj(x_chunk))
        v_cache[:, pos:pos + ck] = self._heads(self.v_proj(x_chunk))
        dev = x_chunk.device
        table = rel_table(t_max, self.d_model, self.compute_dtype, dev)
        p = self._heads(self.pos_proj(table))             # [2t_max-1, H, dh]
        content = torch.einsum("bqhd,bkhd->bhqk", qu, k_cache)
        pos_full = torch.einsum("bqhd,nhd->bhqn", qv, p)
        # the table row of distance d is (t_max - 1) - d; query i sits at
        # pos + i, key j at j: d = pos + i - j
        gi = pos + torch.arange(ck, device=dev)
        idx = (t_max - 1) - (gi[:, None] - torch.arange(t_max, device=dev))
        idx = idx.clamp(0, 2 * t_max - 2)                 # [C, t_max]
        pos_score = torch.gather(
            pos_full, 3, idx.expand(b, self.num_heads, ck, t_max))
        return self._finish(content, pos_score, v_cache, bias), k_cache, \
            v_cache


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise convolution as kernel-many shifted multiply-adds in the
    compute dtype (the reference's order). The parameters are those of
    nn.Conv1d(C, C, k, groups=C): weight [C, 1, k], bias [C]."""

    def __init__(self, channels: int, kernel_size: int, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__(channels, channels, kernel_size, groups=channels,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, h):
        """h [B, T + k - 1, C] (already padded) -> [B, T, C] (VALID)."""
        dt = self.compute_dtype
        k = self.kernel_size[0]
        h = h.to(dt)
        w = self.weight.to(dt)[:, 0]                      # [C, k]
        t_out = h.shape[1] - k + 1
        out = h[:, :t_out] * w[:, 0]
        for i in range(1, k):
            out = out + h[:, i:i + t_out] * w[:, i]
        return out + self.bias.to(dt)


class ConvModule(nn.Module):
    """Pointwise GLU -> depthwise conv -> LayerNorm -> swish ->
    pointwise -> dropout."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        self.kernel = c.conv_kernel
        self.causal = c.enc_chunk_size > 0
        self.pw1 = Dense(c.d_model, 2 * c.d_model, dtype=c.dtype,
                         param_dtype=c.param_dtype)
        self.depthwise = DepthwiseConv1d(c.d_model, c.conv_kernel, c.dtype,
                                         c.param_dtype)
        self.norm = LayerNorm(c.d_model, c.dtype, c.param_dtype)
        self.pw2 = Dense(c.d_model, c.d_model, dtype=c.dtype,
                         param_dtype=c.param_dtype)
        self.drop = nn.Dropout(c.dropout)

    def _glu(self, x):
        a, b = self.pw1(x).chunk(2, dim=-1)
        return a * torch.sigmoid(b)

    def _tail(self, h):
        h = self.norm(h)
        return self.drop(self.pw2(h * torch.sigmoid(h)))

    def forward(self, x, valid):
        """x [B, T, D], valid [B, T] bool -> [B, T, D]."""
        pad = ~valid[..., None]
        h = self._glu(x.masked_fill(pad, 0.0)).masked_fill(pad, 0.0)
        k = self.kernel
        left, right = (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2)
        return self._tail(self.depthwise(F.pad(h, (0, 0, left, right))))

    def step(self, x_chunk, conv_cache):
        """Streaming step of the causal conv: x_chunk [B, C, D];
        conv_cache [B, kernel-1, D] the previous post-GLU frames (zeros at
        the start, as the offline left padding). -> (out [B, C, D], the
        new conv_cache)."""
        ext = torch.cat([conv_cache, self._glu(x_chunk)], dim=1)
        return self._tail(self.depthwise(ext)), ext[:, -(self.kernel - 1):]


class ConformerLayer(nn.Module):
    """Pre-norm macaron block: 1/2 FFN -> rel-pos MHSA -> conv -> 1/2 FFN
    -> final LayerNorm."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        ffn = lambda: PositionwiseFeedForward(  # noqa: E731
            c.d_model, c.d_inner, c.dropout, c.dtype, c.param_dtype)
        norm = lambda: LayerNorm(c.d_model, c.dtype,  # noqa: E731
                                 c.param_dtype)
        self.ffn1 = ffn()
        self.ffn2 = ffn()
        self.slf_attn = RelPosMultiHeadAttention(c)
        self.conv = ConvModule(c)
        self.norm_ffn1 = norm()
        self.norm_attn = norm()
        self.norm_conv = norm()
        self.norm_ffn2 = norm()
        self.norm_out = norm()
        self.dropout = nn.Dropout(c.dropout)

    def forward(self, x, pos_emb, bias, valid):
        x = x + 0.5 * self.ffn1(self.norm_ffn1(x))
        x = x + self.dropout(self.slf_attn(self.norm_attn(x), pos_emb, bias))
        x = x + self.conv(self.norm_conv(x), valid)
        x = x + 0.5 * self.ffn2(self.norm_ffn2(x))
        return self.norm_out(x)

    def step(self, x_chunk, pos: int, k_cache, v_cache, conv_cache, bias):
        """Streaming chunk step (cached rel-pos attention, causal conv):
        forward for the chunk's valid frames. -> (out [B, C, D], k_cache,
        v_cache, conv_cache)."""
        x = x_chunk + 0.5 * self.ffn1(self.norm_ffn1(x_chunk))
        h, k_cache, v_cache = self.slf_attn.step(
            self.norm_attn(x), pos, k_cache, v_cache, bias)
        x = x + h
        h, conv_cache = self.conv.step(self.norm_conv(x), conv_cache)
        x = x + h
        x = x + 0.5 * self.ffn2(self.norm_ffn2(x))
        return self.norm_out(x), k_cache, v_cache, conv_cache
