"""Model glue: encoder + decoder + CTC head (port of
tpu_asr/models/transformer.py, inference surface).

Covers model_type in {transformer, ctc, hybrid}. The training objective
(`__call__` with the CTC and label-smoothed losses) comes with the
training slice.
"""

from __future__ import annotations

from torch import nn

from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.modules import Dense


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
                f"model_type={cfg.model_type!r} is not ported yet")
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
