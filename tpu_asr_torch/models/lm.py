"""Transformer language model for shallow fusion and n-best rescoring
(port of tpu_asr/models/lm.py).

A decoder-only transformer over the ASR model's token ids (sos =
vocab - 2, eos = vocab - 1; a sequence is scored as P(y_1 .. y_U, eos |
sos)), trained on transcripts by `python -m tpu_asr_torch.train_lm`. It
plugs into the attention/joint beam (decode/beam.py) and the CTC prefix
beam (decode/ctc_beam.py) through the cached `step_at`, and
into attn_rescore (decode/rescore.py) through one teacher-forced pass.

The modules are the ASR decoder's minus cross-attention, and the
submodules carry the flax names (`embed`, `layers.<i>.slf_attn|ffn|
post_slf|post_ffn`, `out_proj` when untied), so `weights.load_jax_params`
carries a tpu_asr LM's params across. The self-attention caches of all
layers are stacked k/v [L, N, U_max, H, dh] as in models/decoder.py, so
one index_select on dim 1 reorders them beside the decoder's.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn

from tpu_asr_torch.models.attention import MultiHeadAttention, mask_to_bias
from tpu_asr_torch.models.decoder import TokenDecoder
from tpu_asr_torch.models.modules import PositionwiseFeedForward, PostNormBlock
from tpu_asr_torch.utils.padding import make_causal_mask

LM_CONFIG_FILE = "lm_config.json"


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 4233
    d_model: int = 256
    d_inner: int = 1024
    num_heads: int = 4
    num_layers: int = 4
    dropout: float = 0.1
    pe_maxlen: int = 5000
    tie_embedding: bool = True
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def d_head(self) -> int:
        return self.d_model // self.num_heads


class LMLayer(nn.Module):
    """Masked self-attention + FFN with post-norm residuals (the ASR
    DecoderLayer minus cross-attention)."""

    def __init__(self, c: LMConfig):
        super().__init__()
        self.slf_attn = MultiHeadAttention(c.num_heads, c.d_model, c.dtype,
                                           c.param_dtype)
        self.ffn = PositionwiseFeedForward(c.d_model, c.d_inner, c.dropout,
                                           c.dtype, c.param_dtype)
        self.post_slf = PostNormBlock(c.d_model, c.dropout, c.dtype,
                                      c.param_dtype)
        self.post_ffn = PostNormBlock(c.d_model, c.dropout, c.dtype,
                                      c.param_dtype)

    def forward(self, y, self_bias):
        y = self.post_slf(y, self.slf_attn(y, y, self_bias))
        return self.post_ffn(y, self.ffn(y))

    def step(self, y_t, k_self, v_self, self_bias):
        """One position against its cache rows (already written), those
        after the position masked by self_bias."""
        y = self.post_slf(y_t, self.slf_attn.step(y_t, k_self, v_self,
                                                  self_bias))
        return self.post_ffn(y, self.ffn(y))


class TransformerLM(TokenDecoder):
    """Starts in eval mode (no dropout), as the ASR models do."""

    def __init__(self, cfg: LMConfig):
        super().__init__(cfg)
        self.layers = nn.ModuleList(LMLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.eval()

    def forward(self, ys_in):
        """Teacher-forced: ys_in [B, U] -> logits [B, U, V], where
        logits[:, j] predicts the token after ys_in[:, j]."""
        u = ys_in.shape[1]
        y = self.dropout(self.pe(self._embed(ys_in)))
        self_bias = mask_to_bias(
            make_causal_mask(u, ys_in.device)[None, None], self.cfg.dtype)
        for layer in self.layers:
            y = layer(y, self_bias)
        return self._project_out(y)

    def step_at(self, y_prev, pos: torch.Tensor, cache):
        """One cached step with a position per row: y_prev [N] at 0-based
        positions pos [N] (the CTC prefix beam, where each beam is at its
        own prefix length; the attention beam, where all rows share one)
        -> (logits [N, V] of the NEXT token, cache). Row n writes cache
        row pos[n] in place and attends over all U_max rows, those after
        pos[n] masked."""
        u_max = cache["k"].shape[2]
        rows = torch.arange(y_prev.shape[0], device=y_prev.device)
        y = self._embed(y_prev[:, None]) + \
            self.pe.table[pos][:, None, :].to(self.cfg.dtype)
        allowed = torch.arange(u_max, device=pos.device)[None, :] <= \
            pos[:, None]
        bias = mask_to_bias(allowed[:, None, None, :], self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            k_t, v_t = layer.slf_attn.project_kv(y)
            cache["k"][i, rows, pos] = k_t[:, 0]
            cache["v"][i, rows, pos] = v_t[:, 0]
            y = layer.step(y, cache["k"][i], cache["v"][i], bias)
        return self._project_out(y)[:, 0], cache


# ---- config sidecar: lm_config.json in the LM's checkpoint folder (the
# port's Checkpointer.save_config is ModelConfig-typed), readable by
# tpu_asr.models.lm.load_lm_config too ----

def save_lm_config(directory: str, cfg: LMConfig) -> None:
    from tpu_asr_torch.train.checkpoints import config_to_json
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, LM_CONFIG_FILE), "w") as f:
        json.dump(config_to_json(cfg), f, indent=2)


def load_lm_config(directory: str) -> LMConfig:
    with open(os.path.join(directory, LM_CONFIG_FILE)) as f:
        d = json.load(f)
    d["dtype"] = getattr(torch, d["dtype"])
    d["param_dtype"] = getattr(torch, d["param_dtype"])
    return LMConfig(**d)


def load_lm(directory: str, step: int | None = None) -> TransformerLM:
    """The LM of a `train_lm` checkpoint folder, on the CPU: its config
    and the weights of `step` (default: the best by cv loss)."""
    from tpu_asr_torch.train.checkpoints import Checkpointer
    lm = TransformerLM(load_lm_config(directory))
    ck = Checkpointer(directory)
    lm.load_state_dict(ck.restore(ck.best_step() if step is None
                                  else step)["model"])
    return lm
