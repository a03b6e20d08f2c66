"""Encoder with conv2d subsampling or the LFR + linear input layer:
transformer or conformer blocks (port of tpu_asr/models/encoder.py).

The linear input layer (input_layer "linear", the reference lineage's
default) takes LFR-stacked features [B, T/n, m * d_input]
(frontend.build_lfr_features, applied by the train steps and the
Recognizer): a Dense to d_model, then a LayerNorm; the lengths pass
through.

The transformer adds the absolute sinusoidal PE; the conformer adds
none (its attention scores carry relative positions) and passes each
layer a relative-position table and the frame mask. With enc_chunk_size
> 0 the self-attention takes the offline chunk mask: frame q attends to
the frames of chunks <= its own (and >= its own - enc_left_chunks when
that is >= 0), and the conformer's depthwise conv turns causal.

The incremental chunk encoder (`init_cache`, `encode_chunk`) is what
streaming (decode/streaming.py) runs: one chunk of C encoder frames a
call from the 4C+3 feature frames whose VALID conv fields make exactly
those frames, against per-layer K/V caches (and the conformer's conv
cache) of the frames before it. Its outputs equal the full pass's under
the same chunk mask up to the rounding of GEMMs over C rows against T'
rows; it needs the conv2d input layer, as the reference's does.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_asr_torch.models.attention import MultiHeadAttention, mask_to_bias
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.conformer import ConformerLayer, rel_table
from tpu_asr_torch.models.conv import Conv2dSubsampling
from tpu_asr_torch.models.modules import (Dense, LayerNorm,
                                          PositionalEncoding,
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
        """Cached step over C new rows (C = 1 in the CIF decoder's decode
        loop, a chunk in the streaming encoder): x_t [B, C, D] -> [B, C,
        D]. Writes the rows' K/V into rows pos .. pos+C-1 of the caches
        k_self/v_self [B, T_max, H, dh] in place; self_bias masks the rows
        a query may not read."""
        k_t, v_t = self.slf_attn.project_kv(x_t)
        c = x_t.shape[1]
        k_self[:, pos:pos + c] = k_t
        v_self[:, pos:pos + c] = v_t
        x = self.post_attn(x_t, self.slf_attn.step(x_t, k_self, v_self,
                                                   self_bias))
        return self.post_ffn(x, self.ffn(x))


class Encoder(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        if c.encoder_type not in ("transformer", "conformer"):
            raise ValueError(f"unknown encoder_type {c.encoder_type!r}")
        self.cfg = c
        self.conformer = c.encoder_type == "conformer"
        if c.input_layer == "conv2d":
            self.subsample = Conv2dSubsampling(c.d_input, c.d_model,
                                               c.conv_channels, c.dtype,
                                               c.param_dtype)
        elif c.input_layer == "linear":
            self.linear_in = Dense(c.encoder_input_dim, c.d_model,
                                   dtype=c.dtype, param_dtype=c.param_dtype)
            self.norm_in = LayerNorm(c.d_model, c.dtype, c.param_dtype)
        else:
            raise ValueError(f"unknown input_layer {c.input_layer!r}")
        if not self.conformer:
            self.pe = PositionalEncoding(c.d_model, c.pe_maxlen, c.dtype)
        self.dropout = nn.Dropout(c.dropout)
        layer = ConformerLayer if self.conformer else EncoderLayer
        self.layers = nn.ModuleList(layer(c)
                                    for _ in range(c.num_enc_layers))

    def forward(self, feats, feat_lengths):
        """[B, T, D_in] + [B] -> ([B, T', d_model], [B] lengths); D_in =
        cfg.encoder_input_dim (m * d_input for the linear input layer)."""
        c = self.cfg
        if c.input_layer == "conv2d":
            x, out_lengths = self.subsample(feats, feat_lengths)
        else:
            x, out_lengths = self.norm_in(self.linear_in(feats)), feat_lengths
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

    # ---- incremental (KV-cached) chunk encoding for streaming ----

    def init_cache(self, batch: int, t_max: int, device=None) -> dict:
        """Per-layer self-attention K/V caches over t_max encoder frames,
        {"layer_<i>": {"k", "v": [B, t_max, H, dh]}}, plus a conformer
        layer's depthwise-conv cache "conv" [B, kernel-1, D]: zeros, as
        the offline causal conv's left padding."""
        c = self.cfg
        shape = (batch, t_max, c.num_heads, c.d_head)
        caches = {}
        for i in range(c.num_enc_layers):
            entry = {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                     "v": torch.zeros(shape, dtype=c.dtype, device=device)}
            if self.conformer:
                entry["conv"] = torch.zeros(
                    (batch, c.conv_kernel - 1, c.d_model), dtype=c.dtype,
                    device=device)
            caches[f"layer_{i}"] = entry
        return caches

    def encode_chunk(self, feat_window, chunk_idx: int, caches: dict,
                     valid_upto: int | None = None):
        """Encode chunk `chunk_idx`: feat_window [B, 4C+3, D_in] holds the
        feature frames from 4 C chunk_idx on, whose VALID conv fields give
        exactly the chunk's C encoder frames. Each layer writes the
        chunk's K/V into its caches (init_cache) in place; a query attends
        to the cached frames before the chunk's end (and from chunk_idx -
        enc_left_chunks on when that is >= 0), and to none at or past
        valid_upto (the stream's encoder length, which a last partial
        chunk does not fill). -> (enc_chunk [B, C, d_model], caches)."""
        c = self.cfg
        chunk = c.enc_chunk_size
        if chunk <= 0:
            raise ValueError("chunked encoding needs enc_chunk_size > 0")
        if feat_window.shape[1] != c.conv_input_window(chunk):
            raise ValueError(f"a chunk's window is "
                             f"{c.conv_input_window(chunk)} frames, not "
                             f"{feat_window.shape[1]}")
        b, win = feat_window.shape[:2]
        x, _ = self.subsample(feat_window, torch.full(
            (b,), win, dtype=torch.long, device=feat_window.device))
        pos = chunk_idx * chunk
        if not self.conformer:
            x = self.pe(x, offset=pos)
        t_max = caches["layer_0"]["k"].shape[1]
        idx = torch.arange(t_max, device=x.device)
        allowed = idx < pos + chunk
        if valid_upto is not None:
            allowed &= idx < valid_upto
        if c.enc_left_chunks >= 0:
            allowed &= idx >= max(chunk_idx - c.enc_left_chunks, 0) * chunk
        bias = mask_to_bias(allowed[None, None, None, :], c.dtype)
        new_caches = {}
        for i, layer in enumerate(self.layers):
            key = f"layer_{i}"
            entry = caches[key]
            if self.conformer:
                x, k, v, conv = layer.step(x, pos, entry["k"], entry["v"],
                                           entry["conv"], bias)
                new_caches[key] = {"k": k, "v": v, "conv": conv}
            else:
                x = layer.step(x, pos, entry["k"], entry["v"], bias)
                new_caches[key] = {"k": entry["k"], "v": entry["v"]}
        return x, new_caches
