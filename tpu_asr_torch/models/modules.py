"""Shared transformer building blocks (port of tpu_asr/models/modules.py).

`Dense` and `LayerNorm` reproduce flax's numerics: a Dense casts its
input and weights to the compute dtype; a LayerNorm takes its statistics
in float32 with flax's eps of 1e-6 (torch's default is 1e-5) and casts
the result back to the compute dtype. `PostNormBlock(use_pallas=True)`
takes the fused residual+LayerNorm (ops/layernorm.py: its forward
kernel, and in training its backward kernel, whose dgamma and dbeta
reach `norm.weight` and `norm.bias`) on calls of at least 512 rows, as
the reference does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.ops.layernorm import layer_norm_residual
from tpu_asr_torch.parallel.sharding import (column_parallel, copy_to_model,
                                             row_parallel)

LN_EPS = 1e-6   # flax nn.LayerNorm default
FUSED_LN_MIN_ROWS = 512   # the reference's switch (smaller: decode steps)


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] sinusoidal position encodings (Vaswani et al.)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    dim = np.arange(d_model, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_model)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


class Dense(nn.Linear):
    """nn.Linear that computes in `dtype` (flax Dense semantics)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__(d_in, d_out, bias=bias, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics, eps 1e-6 (flax's; torch's 1e-5
    for Whisper), output in `dtype`."""

    def __init__(self, d: int, dtype=torch.float32,
                 param_dtype=torch.float32, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(d, dtype=param_dtype))
        self.compute_dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int = 5000,
                 dtype=torch.float32):
        super().__init__()
        self.register_buffer("table",
                             torch.from_numpy(sinusoid_table(max_len, d_model)),
                             persistent=False)
        self.compute_dtype = dtype

    def forward(self, x, offset: int = 0):
        t = x.shape[-2]
        pe = self.table[offset: offset + t]
        return x + pe.to(self.compute_dtype)


class PositionwiseFeedForward(nn.Module):
    """w_2(dropout(act(w_1(x)))), act ReLU (Whisper: exact-erf GELU).
    Under tensor parallelism (`tp` set by parallel.sharding.shard_params)
    it runs on this rank's d_inner / n_model columns, and w_2's partial
    sums are added over the model axis."""
    TP_SHARDED = {"w_1.weight": 0, "w_2.weight": 1}
    TP_SLICED = ("w_1.bias",)

    def __init__(self, d_model: int, d_inner: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 activation=F.relu):
        super().__init__()
        self.activation = activation
        self.w_1 = Dense(d_model, d_inner, dtype=dtype,
                         param_dtype=param_dtype)
        self.dropout = nn.Dropout(dropout)
        self.w_2 = Dense(d_inner, d_model, dtype=dtype,
                         param_dtype=param_dtype)
        self.tp = None       # the model axis under tensor parallelism

    def forward(self, x):
        if self.tp is None:
            return self.w_2(self.dropout(self.activation(self.w_1(x))))
        h = self.activation(column_parallel(
            self.w_1, copy_to_model(x, self.tp), self.tp))
        return row_parallel(self.w_2, self.dropout(h), self.tp)


class PostNormBlock(nn.Module):
    """residual + dropout + LayerNorm (post-norm, reference convention):
    LN(residual + dropout(sublayer_out)).

    With use_pallas, a call of at least FUSED_LN_MIN_ROWS rows takes the
    fused form (the add in float32, output in residual's dtype); smaller
    calls (decode steps) and use_pallas=False add in the compute dtype and
    normalize with LayerNorm. The parameters are `norm.weight/bias` either
    way, as the reference keeps its tree under the flag."""

    def __init__(self, d_model: int, dropout: float = 0.1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 use_pallas: bool = False):
        super().__init__()
        self.dropout = nn.Dropout(dropout)
        self.norm = LayerNorm(d_model, dtype, param_dtype)
        self.use_pallas = use_pallas

    def forward(self, residual, sublayer_out):
        h = self.dropout(sublayer_out)
        if self.use_pallas and \
                residual.numel() // residual.shape[-1] >= FUSED_LN_MIN_ROWS:
            return layer_norm_residual(residual, h, self.norm.weight,
                                       self.norm.bias, LN_EPS)
        return self.norm(residual + h)
