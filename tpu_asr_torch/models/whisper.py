"""Whisper (Radford et al. 2022, arXiv:2212.04356), as openai/whisper's
whisper/model.py builds it: an encoder-decoder of pre-LN residual
attention blocks over the 30 s log-mel window (frontend.whisper_log_mel).

- encoder: two k3 Conv1d with exact-erf GELU (stride 1, then stride 2,
  padding 1), the fixed `sinusoids` table ([sin | cos] halves) added, the
  blocks x + attn(attn_ln(x)), x + mlp(mlp_ln(x)) with mlp = w_2(gelu(w_1
  x)) of 4 d_model, then ln_post. It attends all `audio_ctx` frames of
  the window, padding included, as Whisper does: the lengths it returns
  are the frames that carry speech (the length ratios of the beam read
  them), not a mask;
- decoder: token embedding plus a learned position table (no scaling),
  blocks with causal self-attention, cross-attention over the whole
  window and the MLP, each pre-LN, then ln, and the logits against the
  token embedding (tied);
- query, value and out projections carry a bias, the key projection
  none; LayerNorm eps 1e-5 (torch's default), statistics in float32.

The compute follows the port's other models: Dense and Conv in the
compute dtype over the parameters, softmax in float32, scores divided by
sqrt(d_head) (openai scales q and k by d_head^-1/4 each, the same up to
rounding). With use_pallas the encoder's self-attention and the
teacher-forced decoder's attentions take the flash kernel.

The cached decode step keeps models/decoder.py's contract, which the
beam search captures in a CUDA graph: `step_at` takes the position as a
device tensor, writes that row of the stacked self-attention caches
[L, N, U_max, H, dh] (TokenDecoder.cache_shape) in place and attends
all U_max rows under a mask. Cross-attention reads one K/V row an
utterance, kept as [L, B, H, T, dh] (`cross_kv_shape`): the W beams of an
utterance are W queries against it, two batched products with no copy
of the K/V.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch.models.attention import MultiHeadAttention, mask_to_bias
from tpu_asr_torch.models.config import WhisperConfig
from tpu_asr_torch.models.decoder import TokenDecoder
from tpu_asr_torch.models.modules import LayerNorm, PositionwiseFeedForward
from tpu_asr_torch.utils.padding import make_causal_mask
from tpu_asr_torch.utils.tracing import span

LN_EPS = 1e-5      # torch.nn.LayerNorm's default, which Whisper keeps


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> torch.Tensor:
    """openai's `sinusoids`: [length, channels] float32, sin of each
    timescale in the first half and cos in the second, timescales
    geometric from 1 to max_timescale over channels / 2 - 1 steps."""
    if channels % 2:
        raise ValueError(f"sinusoids need an even width, not {channels}")
    step = np.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-step * torch.arange(channels // 2))
    scaled = torch.arange(length)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


class WhisperBlock(nn.Module):
    """openai's ResidualAttentionBlock: pre-LN self-attention, (in the
    decoder) pre-LN cross-attention, pre-LN GELU MLP, each added to the
    residual stream."""

    def __init__(self, c: WhisperConfig, cross: bool):
        super().__init__()
        mha = lambda: MultiHeadAttention(  # noqa: E731
            c.num_heads, c.d_model, c.dtype, c.param_dtype,
            c.attention_pallas, key_bias=False)
        norm = lambda: LayerNorm(c.d_model, c.dtype,  # noqa: E731
                                 c.param_dtype, eps=LN_EPS)
        self.slf_attn, self.attn_ln = mha(), norm()
        if cross:
            self.crs_attn, self.crs_ln = mha(), norm()
        self.ffn = PositionwiseFeedForward(c.d_model, c.d_inner, 0.0,
                                           c.dtype, c.param_dtype,
                                           activation=F.gelu)
        self.ffn_ln = norm()

    def forward(self, x, self_bias=None, xa=None):
        h = self.attn_ln(x)
        x = x + self.slf_attn(h, h, self_bias)
        if xa is not None:
            x = x + self.crs_attn(self.crs_ln(x), xa)
        return x + self.ffn(self.ffn_ln(x))

    def step(self, y, pos, k_self, v_self, self_bias, k_x, v_x):
        """One decode position for N = B * W rows. y [N, 1, D]; writes
        this position's K/V into row pos of k_self/v_self [N, U_max, H,
        dh]; self_bias masks the rows after pos; k_x/v_x [B, H, T, dh]:
        one cross K/V row an utterance, the rows b * W .. b * W + W - 1
        of y are its beams."""
        h = self.attn_ln(y)
        k_t, v_t = self.slf_attn.project_kv(h)
        k_self.index_copy_(1, pos, k_t)
        v_self.index_copy_(1, pos, v_t)
        y = y + self.slf_attn.step(h, k_self, v_self, self_bias)
        y = y + self._cross_step(self.crs_ln(y), k_x, v_x)
        return y + self.ffn(self.ffn_ln(y))

    def _cross_step(self, h, k_x, v_x):
        att = self.crs_attn
        b, heads, _, dh = k_x.shape
        n = h.shape[0]
        q = att._heads(att.q_proj(h)).view(b, n // b, heads, dh)
        s = torch.matmul(q.transpose(1, 2), k_x.transpose(-1, -2)) \
            / math.sqrt(dh)                                   # [B, H, W, T]
        p = torch.softmax(s.float(), dim=-1).to(att.compute_dtype)
        out = torch.matmul(p, v_x).transpose(1, 2)          # [B, W, H, dh]
        return att.out_proj(out.reshape(n, 1, heads * dh))


class WhisperEncoder(nn.Module):
    """openai's AudioEncoder over [B, 2 audio_ctx, n_mels] features."""

    def __init__(self, c: WhisperConfig):
        super().__init__()
        self.cfg = c
        self.conv1 = nn.Conv1d(c.d_input, c.d_model, 3, padding=1,
                               dtype=c.param_dtype)
        self.conv2 = nn.Conv1d(c.d_model, c.d_model, 3, stride=2,
                               padding=1, dtype=c.param_dtype)
        self.register_buffer("pe", sinusoids(c.audio_ctx, c.d_model),
                             persistent=False)
        self.layers = nn.ModuleList(WhisperBlock(c, cross=False)
                                    for _ in range(c.num_enc_layers))
        self.ln_post = LayerNorm(c.d_model, c.dtype, c.param_dtype,
                                 eps=LN_EPS)

    def _conv(self, conv, x, stride):
        dt = self.cfg.dtype
        return F.gelu(F.conv1d(x, conv.weight.to(dt), conv.bias.to(dt),
                               stride=stride, padding=1))

    def forward(self, feats, feat_lengths):
        """feats [B, T, n_mels] (the whole window, T = 2 audio_ctx) +
        feat_lengths [B] (the frames that carry speech) -> ([B,
        audio_ctx, D], [B] encoder frames that carry speech)."""
        c = self.cfg
        x = self._conv(self.conv1, feats.to(c.dtype).transpose(1, 2), 1)
        x = self._conv(self.conv2, x, 2).transpose(1, 2)
        if x.shape[1] != c.audio_ctx:
            raise ValueError(f"Whisper's encoder takes the whole window of "
                             f"{2 * c.audio_ctx} frames, not "
                             f"{feats.shape[1]}")
        x = (x + self.pe).to(c.dtype)
        for layer in self.layers:
            x = layer(x)
        lens = c.subsampled_length(feat_lengths).clamp(0, c.audio_ctx)
        return self.ln_post(x), lens


class WhisperDecoder(TokenDecoder):
    """openai's TextDecoder: the shared token embedding and output
    projection and TokenDecoder's self-attention cache layout, with a
    learned position table `pe` [pe_maxlen, D] and no embedding scale."""

    def __init__(self, c: WhisperConfig):
        super().__init__(c)
        self.pe = nn.Embedding(c.pe_maxlen, c.d_model, dtype=c.param_dtype)
        self.layers = nn.ModuleList(WhisperBlock(c, cross=True)
                                    for _ in range(c.num_dec_layers))
        self.ln = LayerNorm(c.d_model, c.dtype, c.param_dtype, eps=LN_EPS)

    def _embed_at(self, ys, positions):
        dt = self.cfg.dtype
        return self.embed.weight.to(dt)[ys] + \
            self.pe.weight.to(dt).index_select(0, positions)

    def forward(self, enc_out, enc_lengths, ys_in):
        """Teacher-forced: enc_out [B, T, D], ys_in [B, U] -> logits [B,
        U, V]. Every frame of enc_out is attended (enc_lengths unused)."""
        u = ys_in.shape[1]
        y = self._embed_at(ys_in, torch.arange(u, device=ys_in.device))
        self_bias = mask_to_bias(
            make_causal_mask(u, ys_in.device)[None, None], self.cfg.dtype)
        for layer in self.layers:
            y = layer(y, self_bias, enc_out)
        return self._project_out(self.ln(y))

    def cross_kv_shape(self, batch: int, t: int) -> tuple:
        """[L, B, H, T, dh]: the layout the step's products read."""
        c = self.cfg
        return (len(self.layers), batch, c.num_heads, t, c.d_head)

    def write_cross_kv(self, enc_out, out):
        """Every layer's cross-attention K/V of enc_out, once per
        utterance batch, into out["k"] / out["v"] (cross_kv_shape)."""
        with span("decoder.cross_kv"):
            for i, layer in enumerate(self.layers):
                k, v = layer.crs_attn.project_kv(enc_out)
                out["k"][i].copy_(k.transpose(1, 2))
                out["v"][i].copy_(v.transpose(1, 2))

    def step_at(self, y_prev, pos: torch.Tensor, cache, cross_kv,
                enc_lengths, beams: int = 1):
        """One decode step of N = B * beams rows at the device position
        pos [1] (Decoder.step_at's contract); cross_kv holds one row an
        utterance. The whole window is attended (enc_lengths unused).
        -> (logits [N, V], cache)."""
        u_max = cache["k"].shape[2]
        if u_max > self.cfg.pe_maxlen:
            raise ValueError(f"{u_max} decoder positions (the prompt and "
                             f"max_len) pass Whisper's {self.cfg.pe_maxlen}")
        y = self._embed_at(y_prev, pos.expand(y_prev.shape[0]))[:, None]
        allowed = torch.arange(u_max, device=pos.device) <= pos
        self_bias = mask_to_bias(allowed[None, None, None, :],
                                 self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            y = layer.step(y, pos, cache["k"][i], cache["v"][i], self_bias,
                           cross_kv["k"][i], cross_kv["v"][i])
        return self._project_out(self.ln(y))[:, 0], cache


class Whisper(nn.Module):
    """The encoder-decoder, with the Transformer glue's inference API
    (encode, decode_logits, decoder); no CTC head and no loss: the port
    serves Whisper and does not train it."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        if cfg.model_type != "transformer":
            raise ValueError(f"Whisper is an attention-only model, not "
                             f"model_type={cfg.model_type!r}")
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)
        self.eval()

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def decode_logits(self, enc_out, enc_lengths, ys_in):
        return self.decoder(enc_out, enc_lengths, ys_in)
