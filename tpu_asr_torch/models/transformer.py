"""Model glue: encoder + decoder + CTC head, and the joint objective (port
of tpu_asr/models/transformer.py).

Covers model_type in {transformer, ctc, hybrid}; cif and transducer
have their own modules (models/cif.py, models/transducer.py, picked by
models.build_model). `forward` returns the
losses of a batch as a dict of 0-d tensors, L = lambda * ctc +
(1 - lambda) * att. Dropout follows torch's train/eval mode; the module
starts in eval mode, so decoding never drops anything.

The CTC branch always goes through ops.ctc_loss.ctc_loss_kernel: the CUDA
kernel pair on the card, its plain recursions on the CPU. The reference
picks its Pallas kernel by `ctc_pallas`; the port picks by device and
reads no such flag.
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_asr_torch import IGNORE_ID
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.modules import Dense
from tpu_asr_torch.ops.ctc_loss import ctc_loss_kernel
from tpu_asr_torch.ops.losses import (label_smoothing_loss, masked_row_mean,
                                      token_accuracy)


def add_sos_eos(targets: torch.Tensor, target_lengths: torch.Tensor,
                sos_id: int, eos_id: int, ignore_id: int = IGNORE_ID):
    """[B, U] ignore-padded targets -> (ys_in [B, U+1], ys_out [B, U+1]):
    ys_in = <sos> + targets (pads become eos, a real id for the
    embedding), ys_out = targets + <eos> (pads stay ignore_id)."""
    b, u = targets.shape
    safe = torch.where(targets == ignore_id, eos_id, targets)
    sos = torch.full((b, 1), sos_id, dtype=targets.dtype,
                     device=targets.device)
    ys_in = torch.cat([sos, safe], dim=1)
    base = torch.cat([targets, torch.full_like(sos, ignore_id)], dim=1)
    pos = torch.arange(u + 1, device=targets.device)[None, :]
    ys_out = torch.where(pos == target_lengths[:, None], eos_id, base)
    return ys_in, ys_out


class CTCHead(nn.Module):
    """Linear d_model -> vocab on encoder output."""

    def __init__(self, c: ModelConfig):
        super().__init__()
        self.ctc_proj = Dense(c.d_model, c.vocab_size, dtype=c.dtype,
                              param_dtype=c.param_dtype)

    def forward(self, enc_out):
        return self.ctc_proj(enc_out)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.model_type not in ("transformer", "ctc", "hybrid"):
            raise NotImplementedError(
                f"Transformer has no model_type={cfg.model_type!r} (cif "
                f"and transducer have their own modules: "
                f"models.build_model)")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.has_decoder = cfg.model_type in ("transformer", "hybrid")
        self.has_ctc = cfg.model_type in ("ctc", "hybrid")
        if self.has_decoder:
            self.decoder = Decoder(cfg)
        if self.has_ctc:
            self.ctc_head = CTCHead(cfg)
        self.eval()

    @property
    def sos_id(self) -> int:
        return self.cfg.vocab_size - 2

    @property
    def eos_id(self) -> int:
        return self.cfg.vocab_size - 1

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def ctc_logits(self, enc_out):
        return self.ctc_head(enc_out)

    def decode_logits(self, enc_out, enc_lengths, ys_in):
        return self.decoder(enc_out, enc_lengths, ys_in)

    def forward(self, feats, feat_lengths, targets, target_lengths,
                counts=None):
        """feats [B, T, D], feat_lengths [B], targets [B, U] (IGNORE_ID
        padded), target_lengths [B] -> dict(loss, loss_att, loss_ctc, acc)
        of 0-d tensors (only the heads the model has). Rows with
        feat_lengths == 0 (the loader's dummy rows) carry no loss.
        `counts` (ops.losses.loss_counts of the global batch) makes each
        term a data-parallel shard's part of the global mean."""
        c = self.cfg
        rows, tokens = (None, None) if counts is None else (
            counts["rows"], counts["tokens"])
        targets = targets.long()
        enc_out, enc_lengths = self.encode(feats, feat_lengths)
        row_valid = feat_lengths > 0
        out = {}
        loss = None
        if self.has_decoder:
            ys_in, ys_out = add_sos_eos(targets, target_lengths, self.sos_id,
                                        self.eos_id)
            ys_out = torch.where(row_valid[:, None], ys_out, IGNORE_ID)
            logits = self.decode_logits(enc_out, enc_lengths, ys_in)
            loss_att, _ = label_smoothing_loss(logits, ys_out,
                                               c.label_smoothing,
                                               n_total=tokens)
            out["loss_att"] = loss_att
            out["acc"] = token_accuracy(logits, ys_out, n_total=tokens)
            loss = loss_att
        if self.has_ctc:
            safe_targets = torch.where(targets == IGNORE_ID, 0, targets)
            nll = ctc_loss_kernel(self.ctc_logits(enc_out), safe_targets,
                                  enc_lengths, target_lengths, blank=0,
                                  reduction="none")
            loss_ctc = masked_row_mean(
                nll / target_lengths.clamp(min=1), row_valid, rows)
            out["loss_ctc"] = loss_ctc
            loss = (loss_ctc if loss is None else
                    c.ctc_weight * loss_ctc + (1.0 - c.ctc_weight) * loss)
        out["loss"] = loss
        return out
