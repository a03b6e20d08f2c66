"""Transformer-Transducer (RNN-T) model (port of
tpu_asr/models/transducer.py).

* Predictor: the causal label-history network, embed x sqrt(d) + PE +
  dropout + N `LMLayer`s. It is the external LM's stack
  (models/lm.py TransformerLM) without the output projection, so its
  per-row cached step is the LM's `step_at` and it has no `out_proj`
  parameter. Its caches are the LM's stacked k/v [L, N, U_max, H, dh].
  `step_at` writes every row's cache position in place, including the
  rows a decoder then keeps unchanged (they did not emit): each row
  rewrites a position before it reads it, so this equals the reference's
  select of the old cache.

* Joint: logits = tanh(enc_proj(h_t) + pred_proj(g_u)) @ joint_out_kernel
  + joint_out_bias, the output projection held as raw parameters [d_joint,
  V] and [V] (the flax leaves' names and layout), because the loss
  (ops/transducer.py) applies it chunk by chunk of frames.

* The auxiliary CTC head (ctc_weight > 0): L = w * L_ctc + (1 - w) *
  L_rnnt, through ops.ctc_loss.ctc_loss_kernel (the CUDA kernel pair on
  the card), as models/transformer.py.

`forward(feats, feat_lengths, targets, target_lengths)` returns the
losses as a dict of 0-d tensors, so the Solver, loaders and checkpoints
apply unchanged. The module starts in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_asr_torch import IGNORE_ID
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.lm import LMConfig, TransformerLM
from tpu_asr_torch.models.modules import Dense
from tpu_asr_torch.models.transformer import CTCHead
from tpu_asr_torch.ops.ctc_loss import ctc_loss_kernel
from tpu_asr_torch.ops.losses import masked_row_mean
from tpu_asr_torch.ops.transducer import transducer_loss


def pred_lm_config(c: ModelConfig) -> LMConfig:
    """The predictor's LMConfig (tied embedding, so no output layer)."""
    return LMConfig(vocab_size=c.vocab_size, d_model=c.d_model,
                    d_inner=c.d_inner, num_heads=c.num_heads,
                    num_layers=c.num_pred_layers, dropout=c.dropout,
                    pe_maxlen=c.pe_maxlen, dtype=c.dtype,
                    param_dtype=c.param_dtype)


class Predictor(TransformerLM):
    """forward(ys_in [B, U1]) -> hidden states [B, U1, D] (row u = history
    token at position u, sos at 0); step_at(y_prev [N], pos [N], cache) ->
    (hidden [N, D], cache) with a position per row."""

    def _project_out(self, y):
        return y


class TransducerModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.model_type != "transducer":
            raise ValueError(f"TransducerModel has no model_type="
                             f"{cfg.model_type!r}")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.predictor = Predictor(pred_lm_config(cfg))
        dense = lambda: Dense(cfg.d_model, cfg.d_joint,  # noqa: E731
                              dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.enc_proj = dense()
        self.pred_proj = dense()
        self.joint_out_kernel = nn.Parameter(torch.zeros(
            cfg.d_joint, cfg.vocab_size, dtype=cfg.param_dtype))
        self.joint_out_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=cfg.param_dtype))
        self.has_ctc = cfg.ctc_weight > 0.0
        if self.has_ctc:
            self.ctc_head = CTCHead(cfg)
        self.eval()

    @property
    def sos_id(self) -> int:
        return self.cfg.vocab_size - 2

    @property
    def blank_id(self) -> int:
        return 0

    # ---- pieces the decoders reuse (decode/transducer_decode.py) ----

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def enc_features(self, enc_out):
        """Encoder-side joint projection f [B, T, d_joint]."""
        return self.enc_proj(enc_out)

    def ctc_logits(self, enc_out):
        return self.ctc_head(enc_out)

    def predict_sequence(self, ys_in):
        """Predictor-side joint projections g [B, U1, d_joint]."""
        return self.pred_proj(self.predictor(ys_in))

    def predictor_init_cache(self, batch: int, u_max: int, device=None):
        return self.predictor.init_cache(batch, u_max, device=device)

    def predictor_step(self, y_prev, pos, cache):
        """(tokens [N], per-row positions [N], cache) -> (g [N, d_joint],
        cache); writes cache row pos[n] of every row n in place."""
        h, cache = self.predictor.step_at(y_prev.long(), pos.long(), cache)
        return self.pred_proj(h), cache

    def joint_out(self):
        """(w_out in the compute dtype, b_out in float32)."""
        return (self.joint_out_kernel.to(self.cfg.dtype),
                self.joint_out_bias.float())

    def joint_step(self, f_t, g):
        """One frame x one history per row: ([N, dj], [N, dj]) -> logits
        [N, V] float32."""
        w, b = self.joint_out()
        return (torch.tanh(f_t + g) @ w + b).float()

    # ---- training ----

    def forward(self, feats, feat_lengths, targets, target_lengths,
                counts=None):
        """feats [B, T, D], feat_lengths [B], targets [B, U] (IGNORE_ID
        padded), target_lengths [B] -> dict(loss, loss_rnnt[, loss_ctc])
        of 0-d tensors. Rows with feat_lengths == 0 carry no loss.
        `counts`: as Transformer.forward's (its "rows" here)."""
        c = self.cfg
        rows = None if counts is None else counts["rows"]
        targets = targets.long()
        enc_out, enc_lengths = self.encode(feats, feat_lengths)
        row_valid = feat_lengths > 0
        safe = torch.where(targets == IGNORE_ID, 0, targets)
        sos = torch.full_like(safe[:, :1], self.sos_id)
        f = self.enc_features(enc_out)
        g = self.predict_sequence(torch.cat([sos, safe], dim=1))  # [B,U+1]
        w, b = self.joint_out()
        nll = transducer_loss(f, g, w, b, safe,
                              torch.where(row_valid, enc_lengths, 0),
                              target_lengths, blank=self.blank_id,
                              reduction="none")
        per_label = target_lengths.clamp(min=1)
        loss = masked_row_mean(nll / per_label, row_valid, rows)
        out = {"loss_rnnt": loss}
        if self.has_ctc:
            ctc_nll = ctc_loss_kernel(self.ctc_logits(enc_out), safe,
                                      enc_lengths, target_lengths, blank=0,
                                      reduction="none")
            loss_ctc = masked_row_mean(ctc_nll / per_label, row_valid, rows)
            out["loss_ctc"] = loss_ctc
            loss = c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss
        out["loss"] = loss
        return out
