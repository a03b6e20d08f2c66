"""Conv2d subsampling front-end: 4x time reduction into d_model (port of
tpu_asr/models/conv.py).

flax convolves a [B, T, F, 1] NHWC input and flattens (f, c) with c
FASTEST before the `out` Dense. torch convolves NCHW, so the output is
permuted to [B, T', F', C] before the reshape; otherwise the `out`
weight (F'*C rows) lines up with the wrong features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.models.modules import Dense


class Conv2dSubsampling(nn.Module):
    def __init__(self, d_input: int, d_model: int, channels=256,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        c1, c2 = (channels if isinstance(channels, (tuple, list))
                  else (channels, channels))
        self.conv1 = nn.Conv2d(1, c1, 3, stride=2, dtype=param_dtype)
        self.conv2 = nn.Conv2d(c1, c2, 3, stride=2, dtype=param_dtype)
        f_out = ((d_input - 1) // 2 - 1) // 2
        self.out = Dense(f_out * c2, d_model, dtype=dtype,
                         param_dtype=param_dtype)
        self.compute_dtype = dtype

    def _conv(self, conv, x):
        dt = self.compute_dtype
        return F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                               stride=2))

    def forward(self, feats, feat_lengths):
        """[B, T, D] + [B] -> ([B, T', d_model], [B] subsampled lengths)."""
        x = feats.to(self.compute_dtype)[:, None]        # [B, 1, T, D]
        x = self._conv(self.conv2, self._conv(self.conv1, x))
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)    # c fastest (flax)
        out_lengths = ((feat_lengths - 1) // 2 - 1) // 2
        return self.out(x), out_lengths.clamp(min=0)
