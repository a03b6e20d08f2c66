"""Transformer decoder: teacher-forced pass + cached single-step decode
(port of tpu_asr/models/decoder.py).

The self-attention caches of all layers are held as two stacked tensors
k/v [L, N, U_max, H, dh], so the beam search reorders them with one
index_select each instead of one per layer. `step_at` takes the position
as a device tensor, writes cache row `pos` in place and attends over all
U_max rows with those after `pos` masked to exp(-1e30) = 0, the
reference's own form: every call has the same shapes and no Python int
reaches an op, so the beam search captures it in a CUDA graph
(decode/beam.py).
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
from tpu_asr_torch.utils.tracing import span


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

    def step(self, y_t, k_self, v_self, k_cross, v_cross, cross_bias,
             self_bias):
        """One decode position. y_t: [N, 1, D]; k_self/v_self: this
        layer's cache rows [N, U_max, H, dh] (row pos already written),
        self_bias masking those after pos; k_cross/v_cross: [N, T, H,
        dh]."""
        y = self.post_slf(y_t, self.slf_attn.step(y_t, k_self, v_self,
                                                  self_bias))
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

    def cache_shape(self, batch: int, u_max: int) -> tuple:
        """[L, batch, u_max, H, dh]: the stacked self-attention caches (and
        the decoder's stacked cross-attention K/V, u_max = T)."""
        c = self.cfg
        return (len(self.layers), batch, u_max, c.num_heads, c.d_head)

    def cross_kv_shape(self, batch: int, t: int) -> tuple:
        """The stacked cross-attention K/V of a batch (write_cross_kv):
        cache_shape's layout [L, B, T, H, dh]."""
        return self.cache_shape(batch, t)

    def init_cache(self, batch: int, u_max: int, device=None):
        shape, dt = self.cache_shape(batch, u_max), self.cfg.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}


class Decoder(TokenDecoder):
    def __init__(self, c: ModelConfig):
        super().__init__(c)
        self.layers = nn.ModuleList(DecoderLayer(c)
                                    for _ in range(c.num_dec_layers))

    def forward(self, enc_out, enc_lengths, ys_in):
        """Teacher-forced: enc_out [B,T,D], ys_in [B,U] -> logits [B,U,V]."""
        dt = self.cfg.dtype
        u = ys_in.shape[1]
        y = self.dropout(self.pe(self._embed(ys_in)))
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

    def write_cross_kv(self, enc_out, out):
        """The cross-attention K/V of every layer, computed once per
        utterance batch and written layer by layer into out["k"] /
        out["v"] [L, B, T, H, dh] (span decoder.cross_kv)."""
        with span("decoder.cross_kv"):
            for i, layer in enumerate(self.layers):
                k, v = layer.crs_attn.project_kv(enc_out)
                out["k"][i].copy_(k)
                out["v"][i].copy_(v)

    def step_at(self, y_prev, pos: torch.Tensor, cache, cross_kv,
                enc_lengths, beams: int = 1):
        """One decode step for the whole (flattened) batch/beam. y_prev:
        [N] previous token ids; pos: [1] int64 on the device, the 0-based
        position of y_prev, shared by all rows. Writes cache row pos in
        place and attends over all U_max rows, those after pos masked
        (the reference's Decoder.step). cross_kv (write_cross_kv) holds
        one row an utterance, [L, N / beams, T, H, dh]: row b serves the
        `beams` rows from b * beams on. Returns (logits [N, V], cache)."""
        dt = self.cfg.dtype
        u_max = cache["k"].shape[2]
        y = self.dropout(self._embed(y_prev[:, None])
                         + self.pe.table.index_select(0, pos).to(dt))
        allowed = torch.arange(u_max, device=pos.device) <= pos
        self_bias = mask_to_bias(allowed[None, None, None, :], dt)
        cross_bias = self._cross_bias(enc_lengths, cross_kv["k"].shape[2])
        for i, layer in enumerate(self.layers):
            k_t, v_t = layer.slf_attn.project_kv(y)
            cache["k"][i].index_copy_(1, pos, k_t)
            cache["v"][i].index_copy_(1, pos, v_t)
            # each utterance's cross K/V repeated for its rows in the one
            # copy that attend's einsums would make anyway: in the layout
            # they take them, K [N, H, dh, T] and V [N, H, T, dh]
            k_x = _repeat_rows(cross_kv["k"][i].permute(0, 2, 3, 1), beams)
            v_x = _repeat_rows(cross_kv["v"][i].permute(0, 2, 1, 3), beams)
            y = layer.step(y, cache["k"][i], cache["v"][i],
                           k_x.permute(0, 3, 1, 2), v_x.permute(0, 2, 1, 3),
                           cross_bias, self_bias)
        return self._project_out(y)[:, 0], cache


def _repeat_rows(x, n: int):
    """x [B, ...] -> [B * n, ...], each row n times in a row."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])
