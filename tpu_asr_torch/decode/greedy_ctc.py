"""Greedy CTC decode: argmax + vectorized collapse (port of
tpu_asr/decode/greedy_ctc.py)."""

from __future__ import annotations

import torch

from tpu_asr_torch.ops.ctc import ctc_greedy_collapse


def ctc_greedy_decode(ctc_logits: torch.Tensor, enc_lengths: torch.Tensor,
                      blank: int = 0, pad_id: int = -1,
                      return_times: bool = False):
    """ctc_logits [B, T, V] -> (tokens [B, T] pad_id-padded, lengths [B]
    [, emission frame indices [B, T] -1-padded with return_times])."""
    ids = torch.argmax(ctc_logits, dim=-1)
    return ctc_greedy_collapse(ids, enc_lengths, blank=blank, pad_id=pad_id,
                               return_times=return_times)
