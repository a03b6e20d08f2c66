"""Encoder with conv2d subsampling: transformer or conformer blocks
(port of tpu_asr/models/encoder.py).

The transformer adds the absolute sinusoidal PE; the conformer adds
none (its attention scores carry relative positions) and passes each
layer a relative-position table and the frame mask. With enc_chunk_size
> 0 the self-attention takes the offline chunk mask: frame q attends to
the frames of chunks <= its own (and >= its own - enc_left_chunks when
that is >= 0), and the conformer's depthwise conv turns causal. The
incremental chunk encoder (`init_cache`/`encode_chunk`) comes with the
streaming slice, the LFR+linear input layer with the frontend slice.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_asr_torch.models.attention import MultiHeadAttention, mask_to_bias
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.conformer import ConformerLayer, rel_table
from tpu_asr_torch.models.conv import Conv2dSubsampling
from tpu_asr_torch.models.modules import (PositionalEncoding,
                                          PositionwiseFeedForward,
                                          PostNormBlock)
from tpu_asr_torch.utils.padding import make_valid_mask


class EncoderLayer(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        self.slf_attn = MultiHeadAttention(c.num_heads, c.d_model, c.dtype,
                                           c.param_dtype, c.attention_pallas)
        self.ffn = PositionwiseFeedForward(c.d_model, c.d_inner, c.dropout,
                                           c.dtype, c.param_dtype)
        self.post_attn = PostNormBlock(c.d_model, c.dropout, c.dtype,
                                       c.param_dtype, c.layernorm_pallas)
        self.post_ffn = PostNormBlock(c.d_model, c.dropout, c.dtype,
                                      c.param_dtype, c.layernorm_pallas)

    def forward(self, x, bias):
        x = self.post_attn(x, self.slf_attn(x, x, bias))
        return self.post_ffn(x, self.ffn(x))

    def step(self, x_t, pos: int, k_self, v_self, self_bias):
        """Cached causal step (the CIF decoder's decode loop): x_t
        [B, 1, D] -> [B, 1, D]. Writes this step's K/V into row `pos` of
        the caches k_self/v_self [B, U_max, H, dh] in place; self_bias
        masks the rows after pos."""
        k_t, v_t = self.slf_attn.project_kv(x_t)
        k_self[:, pos] = k_t[:, 0]
        v_self[:, pos] = v_t[:, 0]
        x = self.post_attn(x_t, self.slf_attn.step(x_t, k_self, v_self,
                                                   self_bias))
        return self.post_ffn(x, self.ffn(x))


class Encoder(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        if c.input_layer != "conv2d":
            raise NotImplementedError(
                f"input_layer={c.input_layer!r}: the LFR+linear input layer "
                f"is not ported yet")
        if c.encoder_type not in ("transformer", "conformer"):
            raise ValueError(f"unknown encoder_type {c.encoder_type!r}")
        self.cfg = c
        self.conformer = c.encoder_type == "conformer"
        self.subsample = Conv2dSubsampling(c.d_input, c.d_model,
                                           c.conv_channels, c.dtype,
                                           c.param_dtype)
        if not self.conformer:
            self.pe = PositionalEncoding(c.d_model, c.pe_maxlen, c.dtype)
        self.dropout = nn.Dropout(c.dropout)
        layer = ConformerLayer if self.conformer else EncoderLayer
        self.layers = nn.ModuleList(layer(c)
                                    for _ in range(c.num_enc_layers))

    def forward(self, feats, feat_lengths):
        """[B, T, D_in] + [B] -> ([B, T', d_model], [B] lengths)."""
        c = self.cfg
        x, out_lengths = self.subsample(feats, feat_lengths)
        t = x.shape[1]
        valid = make_valid_mask(out_lengths, t)                 # [B, T']
        mask = valid[:, None, None, :]                          # [B,1,1,T']
        if c.enc_chunk_size > 0:
            cid = torch.arange(t, device=x.device) // c.enc_chunk_size
            allow = cid[:, None] >= cid[None, :]                # [T', T']
            if c.enc_left_chunks >= 0:
                allow &= (cid[:, None] - cid[None, :]) <= c.enc_left_chunks
            mask = mask & allow[None, None]                     # [B,1,T',T']
        bias = mask_to_bias(mask, c.dtype)
        if self.conformer:
            x = self.dropout(x)
            pos_emb = rel_table(t, c.d_model, c.dtype, x.device)
            for layer in self.layers:
                x = layer(x, pos_emb, bias, valid)
        else:
            x = self.dropout(self.pe(x))
            for layer in self.layers:
                x = layer(x, bias)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths
