"""Transformer decoder: teacher-forced pass + cached single-step decode
(port of tpu_asr/models/decoder.py).

The self-attention caches of all layers are held as two stacked tensors
k/v [L, N, U_max, H, dh], so the beam search reorders them with one
index_select each instead of one per layer. `step` writes position `pos`
in place and attends over the first pos+1 cache rows; the reference
attends over all U_max rows with the later ones masked to exp(-1e30) = 0,
which gives the same result.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from tpu_asr_torch.models.attention import MultiHeadAttention, mask_to_bias
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.modules import (Dense, PositionalEncoding,
                                          PositionwiseFeedForward,
                                          PostNormBlock)
from tpu_asr_torch.utils.padding import make_causal_mask, make_valid_mask


class DecoderLayer(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        mha = lambda: MultiHeadAttention(c.num_heads, c.d_model,  # noqa: E731
                                         c.dtype, c.param_dtype,
                                         c.attention_pallas)
        self.slf_attn = mha()
        self.crs_attn = mha()
        self.ffn = PositionwiseFeedForward(c.d_model, c.d_inner, c.dropout,
                                           c.dtype, c.param_dtype)
        post = lambda: PostNormBlock(c.d_model, c.dropout,  # noqa: E731
                                     c.dtype, c.param_dtype,
                                     c.layernorm_pallas)
        self.post_slf = post()
        self.post_crs = post()
        self.post_ffn = post()

    def forward(self, y, enc, self_bias, cross_bias):
        y = self.post_slf(y, self.slf_attn(y, y, self_bias))
        y = self.post_crs(y, self.crs_attn(y, enc, cross_bias))
        return self.post_ffn(y, self.ffn(y))

    def step(self, y_t, k_self, v_self, k_cross, v_cross, cross_bias):
        """One decode position. y_t: [N, 1, D]; k_self/v_self: this
        layer's cache rows 0..pos [N, pos+1, H, dh] (row pos already
        written); k_cross/v_cross: [N, T, H, dh]."""
        y = self.post_slf(y_t, self.slf_attn.step(y_t, k_self, v_self))
        y = self.post_crs(y, self.crs_attn.step(y, k_cross, v_cross,
                                                cross_bias))
        return self.post_ffn(y, self.ffn(y))


class TokenDecoder(nn.Module):
    """What the attention decoder, the CIF decoder and the external LM
    share: the token embedding (scaled by sqrt(d_model)), positional
    encoding, dropout, the (tied) output projection and the stacked
    self-attention caches. A subclass adds `layers`. `c` is a ModelConfig
    or an LMConfig (the fields read here are common to both)."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        self.cfg = c
        self.embed = nn.Embedding(c.vocab_size, c.d_model,
                                  dtype=c.param_dtype)
        # sqrt(d_model) in float32, rounded to the compute dtype (flax)
        self.emb_scale = float(torch.tensor(math.sqrt(c.d_model),
                                            dtype=torch.float32).to(c.dtype))
        self.pe = PositionalEncoding(c.d_model, c.pe_maxlen, c.dtype)
        self.dropout = nn.Dropout(c.dropout)
        if not c.tie_embedding:
            self.out_proj = Dense(c.d_model, c.vocab_size, bias=False,
                                  dtype=c.dtype, param_dtype=c.param_dtype)

    def _embed(self, ys):
        return self.embed.weight.to(self.cfg.dtype)[ys] * self.emb_scale

    def _project_out(self, y):
        if self.cfg.tie_embedding:
            # flax Embed.attend: y @ embedding.T in the compute dtype
            return y @ self.embed.weight.to(self.cfg.dtype).T
        return self.out_proj(y)

    def init_cache(self, batch: int, u_max: int, device=None):
        c = self.cfg
        shape = (len(self.layers), batch, u_max, c.num_heads, c.d_head)
        return {"k": torch.zeros(shape, dtype=c.dtype, device=device),
                "v": torch.zeros(shape, dtype=c.dtype, device=device)}


class Decoder(TokenDecoder):
    def __init__(self, c: ModelConfig):
        super().__init__(c)
        self.layers = nn.ModuleList(DecoderLayer(c)
                                    for _ in range(c.num_dec_layers))

    def _embed_in(self, ys, offset: int = 0):
        return self.dropout(self.pe(self._embed(ys), offset=offset))

    def forward(self, enc_out, enc_lengths, ys_in):
        """Teacher-forced: enc_out [B,T,D], ys_in [B,U] -> logits [B,U,V]."""
        dt = self.cfg.dtype
        u = ys_in.shape[1]
        y = self._embed_in(ys_in)
        self_bias = mask_to_bias(
            make_causal_mask(u, ys_in.device)[None, None], dt)
        cross_bias = self._cross_bias(enc_lengths, enc_out.shape[1])
        for layer in self.layers:
            y = layer(y, enc_out, self_bias, cross_bias)
        return self._project_out(y)

    def _cross_bias(self, enc_lengths, t):
        valid = make_valid_mask(enc_lengths, t)
        return mask_to_bias(valid[:, None, None, :], self.cfg.dtype)

    # ---- cached decode-step API (used by tpu_asr_torch.decode) ----

    def precompute_cross_kv(self, enc_out):
        """Cross-attention K/V of every layer, stacked [L, B, T, H, dh],
        computed once per utterance batch."""
        ks, vs = zip(*(layer.crs_attn.project_kv(enc_out)
                       for layer in self.layers))
        return {"k": torch.stack(ks), "v": torch.stack(vs)}

    def step(self, y_prev, pos: int, cache, cross_kv, enc_lengths):
        """One decode step for the whole (flattened) batch/beam.

        y_prev: [N] previous token ids; pos: 0-based position of y_prev.
        Writes cache row `pos` in place; returns (logits [N, V], cache).
        """
        y = self._embed_in(y_prev[:, None], offset=pos)          # [N,1,D]
        cross_bias = self._cross_bias(enc_lengths, cross_kv["k"].shape[2])
        for i, layer in enumerate(self.layers):
            k_t, v_t = layer.slf_attn.project_kv(y)
            cache["k"][i, :, pos] = k_t[:, 0]
            cache["v"][i, :, pos] = v_t[:, 0]
            y = layer.step(y, cache["k"][i, :, : pos + 1],
                           cache["v"][i, :, : pos + 1],
                           cross_kv["k"][i], cross_kv["v"][i], cross_bias)
        return self._project_out(y)[:, 0], cache
