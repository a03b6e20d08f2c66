"""CIF model: assigner + integrate-and-fire + autoregressive decoder (port
of tpu_asr/models/cif.py).

A conv net over the encoder output emits per-frame weights alpha =
sigmoid(.); integrate-and-fire turns them and the encoder states into one
embedding per output token; a causal self-attention decoder reads
embed(previous token) + fuse(fired[u]). Training scales alpha so the fire
count equals the target length plus one (the eos fire), and adds the
quantity loss |sum(alpha) - (U + 1)| on the unscaled alphas and, with
ctc_weight > 0, an auxiliary CTC head:
L = att + cif_quantity_weight * qty + ctc_weight * ctc.

Firing always goes through ops.cif_fire.cif_fire_kernel (the CUDA kernel
on the card, its plain version on the CPU), and the CTC branch through
ops.ctc_loss.ctc_loss_kernel. The encoder and the decoder share
EncoderLayer, so with use_pallas their full passes take flash attention
and the fused residual+LayerNorm as the hybrid model's do; the decoder's
cached steps stay on attend.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_asr_torch import IGNORE_ID
from tpu_asr_torch.models.attention import mask_to_bias
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import TokenDecoder
from tpu_asr_torch.models.encoder import Encoder, EncoderLayer
from tpu_asr_torch.models.modules import Dense
from tpu_asr_torch.models.transformer import CTCHead, add_sos_eos
from tpu_asr_torch.ops.cif import quantity_loss, scale_alphas
from tpu_asr_torch.ops.cif_fire import cif_fire_kernel
from tpu_asr_torch.ops.ctc_loss import ctc_loss_kernel
from tpu_asr_torch.ops.losses import (label_smoothing_loss, masked_row_mean,
                                      token_accuracy)
from tpu_asr_torch.utils.padding import make_causal_mask, make_valid_mask

ASSIGNER_CONV_WIDTH = 3       # alpha_j reads encoder frames j-1 .. j+1


class Assigner(nn.Module):
    """Per-frame fire weights: SAME conv over time -> ReLU -> Dense(1) ->
    sigmoid (compute dtype), then float32, 0 past the encoder length."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        self.conv = nn.Conv1d(c.d_model, c.d_model, ASSIGNER_CONV_WIDTH,
                              padding=ASSIGNER_CONV_WIDTH // 2,
                              dtype=c.param_dtype)
        self.proj = Dense(c.d_model, 1, dtype=c.dtype,
                          param_dtype=c.param_dtype)
        self.compute_dtype = c.dtype

    def forward(self, enc_out, enc_lengths):
        """-> (alphas [B, T] float32, valid [B, T])."""
        dt = self.compute_dtype
        h = F.conv1d(enc_out.to(dt).transpose(1, 2), self.conv.weight.to(dt),
                     self.conv.bias.to(dt), padding=self.conv.padding)
        h = F.relu(h.transpose(1, 2))
        alphas = torch.sigmoid(self.proj(h))[..., 0]
        valid = make_valid_mask(enc_lengths, alphas.shape[1])
        return torch.where(valid, alphas.float(), 0.0), valid


class CifDecoder(TokenDecoder):
    """Causal self-attention decoder over embed(y) + fuse(fired): encoder
    layers (no cross-attention) under a causal bias."""

    def __init__(self, c: ModelConfig):
        super().__init__(c)
        self.fuse = Dense(c.d_model, c.d_model, dtype=c.dtype,
                          param_dtype=c.param_dtype)
        self.layers = nn.ModuleList(EncoderLayer(c)
                                    for _ in range(c.num_dec_layers))

    def _fused_input(self, ys, fired, offset: int = 0):
        y = self._embed(ys) + self.fuse(fired.to(self.cfg.dtype))
        return self.pe(y, offset=offset)

    def forward(self, ys_in, fired):
        """ys_in [B, U], fired [B, U, D] -> logits [B, U, V]."""
        y = self.dropout(self._fused_input(ys_in, fired))
        bias = mask_to_bias(
            make_causal_mask(ys_in.shape[1], ys_in.device)[None, None],
            self.cfg.dtype)
        for layer in self.layers:
            y = layer(y, bias)
        return self._project_out(y)

    # ---- cached decode-step API (used by tpu_asr_torch.decode) ----

    def step(self, y_prev, fired_t, pos: int, cache):
        """One decode position for the whole (flattened) batch: y_prev [N]
        token ids, fired_t [N, D] this position's fired embedding. Writes
        cache row `pos` in place; returns (logits [N, V], cache)."""
        u_max = cache["k"].shape[2]
        y = self._fused_input(y_prev[:, None], fired_t[:, None], offset=pos)
        allowed = torch.arange(u_max, device=y.device) <= pos
        bias = mask_to_bias(allowed[None, None, None, :], self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            y = layer.step(y, pos, cache["k"][i], cache["v"][i], bias)
        return self._project_out(y)[:, 0], cache


class CifModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.model_type != "cif":
            raise ValueError(f"CifModel needs model_type='cif', got "
                             f"{cfg.model_type!r}")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.assigner = Assigner(cfg)
        self.decoder = CifDecoder(cfg)
        self.use_ctc = cfg.ctc_weight > 0.0
        if self.use_ctc:
            self.ctc_head = CTCHead(cfg)
        self.eval()

    @property
    def sos_id(self) -> int:
        return self.cfg.vocab_size - 2

    @property
    def eos_id(self) -> int:
        return self.cfg.vocab_size - 1

    def encode(self, feats, feat_lengths):
        """-> (enc_out, enc_lengths, alphas [B, T'] float32, valid)."""
        enc_out, enc_lengths = self.encoder(feats, feat_lengths)
        alphas, valid = self.assigner(enc_out, enc_lengths)
        return enc_out, enc_lengths, alphas, valid

    def fire(self, enc_out, alphas, u_max: int):
        return cif_fire_kernel(enc_out, alphas, u_max)

    def decode_logits(self, ys_in, fired):
        return self.decoder(ys_in, fired)

    def ctc_logits(self, enc_out):
        return self.ctc_head(enc_out)

    def forward(self, feats, feat_lengths, targets, target_lengths):
        """-> dict(loss, loss_att, loss_qty, acc[, loss_ctc]) of 0-d
        tensors. Rows with feat_lengths == 0 (the loader's dummy rows)
        carry no loss."""
        c = self.cfg
        targets = targets.long()
        enc_out, enc_lengths, alphas, valid = self.encode(feats, feat_lengths)
        row_valid = feat_lengths > 0
        u_fire = target_lengths + 1          # one fire per token, and eos
        loss_qty = quantity_loss(alphas, valid, u_fire, row_valid=row_valid)
        scaled = scale_alphas(alphas, valid, u_fire)
        ys_in, ys_out = add_sos_eos(targets, target_lengths, self.sos_id,
                                    self.eos_id)
        ys_out = torch.where(row_valid[:, None], ys_out, IGNORE_ID)
        fired = self.fire(enc_out, scaled, ys_in.shape[1])
        logits = self.decode_logits(ys_in, fired)
        loss_att, _ = label_smoothing_loss(logits, ys_out, c.label_smoothing)
        out = {"loss_att": loss_att, "loss_qty": loss_qty,
               "acc": token_accuracy(logits, ys_out)}
        loss = loss_att + c.cif_quantity_weight * loss_qty
        if self.use_ctc:
            safe_targets = torch.where(targets == IGNORE_ID, 0, targets)
            nll = ctc_loss_kernel(self.ctc_logits(enc_out), safe_targets,
                                  enc_lengths, target_lengths, blank=0,
                                  reduction="none")
            loss_ctc = masked_row_mean(nll / target_lengths.clamp(min=1),
                                       row_valid)
            out["loss_ctc"] = loss_ctc
            loss = loss + c.ctc_weight * loss_ctc
        out["loss"] = loss
        return out
