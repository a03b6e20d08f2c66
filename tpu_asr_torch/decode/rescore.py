"""Attention-rescoring decode: CTC prefix beam n-best + ONE teacher-forced
decoder pass (port of tpu_asr/decode/rescore.py).

  1. the frame-synchronous CTC prefix beam search (decode/ctc_beam.py)
     gives W hypotheses per utterance with their CTC scores;
  2. one teacher-forced decoder forward over all B*W hypotheses scores
     every hypothesis at once (no autoregressive loop, no cache);
  3. final score = attention log-prob + ctc_weight * CTC log-prob, the
     best hypothesis first (WeNet's convention); with an external LM
     (models/lm.py) and lm_weight > 0, plus lm_weight * its log-prob of
     each hypothesis and eos, from one more teacher-forced pass.

The decoder pass is a full pass, so a `use_pallas` model runs it through
the flash attention (causal self-attention, key-padded cross-attention)
and the fused residual+LayerNorm.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.decode.ctc_beam import ctc_prefix_beam_search

NEG_INF = -1e30


def attention_rescore(decoder, enc_out: torch.Tensor,
                      enc_lengths: torch.Tensor, ctc_logits: torch.Tensor,
                      sos_id: int, eos_id: int, beam: int = 10,
                      max_len: int = 64, ctc_weight: float = 0.5,
                      ctc_topk: int = 8, lm=None, lm_weight: float = 0.0):
    """-> dict(tokens [B, W, L] (-1-padded), scores [B, W], lengths
    [B, W], att_scores, ctc_scores) sorted best-first by the combined
    score. decoder: models.decoder.Decoder; ctc_logits [B, T', V] raw CTC
    head logits; lm: a models.lm.TransformerLM, used when lm_weight > 0."""
    b = enc_out.shape[0]
    w = beam
    l = min(max_len, ctc_logits.shape[1])
    dev = enc_out.device

    toks, lens, ctc_scores = ctc_prefix_beam_search(
        ctc_logits, enc_lengths, beam=w, topk=ctc_topk, max_len=l)
    n = b * w
    toks_f = toks.reshape(n, l).long()
    lens_f = lens.reshape(n)
    # teacher-forced input [sos, y_0 .. y_{L-1}]: pads clipped to the eos
    # id for a valid embedding lookup; their positions are masked below
    sos = torch.full((n, 1), sos_id, dtype=torch.long, device=dev)
    ys_in = torch.cat([sos, torch.where(toks_f >= 0, toks_f, eos_id)], 1)
    logits = decoder(enc_out.repeat_interleave(w, dim=0),
                     enc_lengths.repeat_interleave(w), ys_in)
    # position j < len scores token j; position j == len scores eos
    pos = torch.arange(l + 1, device=dev)[None, :]
    tgt = torch.cat([toks_f.clamp(min=0), torch.zeros_like(sos)], 1)
    tgt = torch.where(pos == lens_f[:, None], eos_id, tgt)     # [N, L+1]
    scored = pos <= lens_f[:, None]

    def seq_score(logits):
        logp = torch.log_softmax(logits.float(), dim=-1)
        tok_lp = torch.gather(logp, 2, tgt[..., None])[..., 0]
        return torch.where(scored, tok_lp, 0.0).sum(dim=1).reshape(b, w)

    att_score = seq_score(logits)
    final = att_score + ctc_weight * ctc_scores
    if lm is not None and lm_weight > 0.0:
        final = final + lm_weight * seq_score(lm(ys_in))
    # dead n-best slots (CTC score ~NEG_INF) stay dead
    final = torch.where(ctc_scores <= NEG_INF / 2, NEG_INF, final)
    order = torch.argsort(-final, dim=1, stable=True)

    def take(x):
        if x.ndim == 3:
            return torch.gather(x, 1, order[..., None].expand(x.shape))
        return torch.gather(x, 1, order)

    return {"tokens": take(toks), "scores": take(final),
            "lengths": take(lens), "att_scores": take(att_score),
            "ctc_scores": take(ctc_scores)}
