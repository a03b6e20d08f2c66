"""Sequence losses: label-smoothed cross-entropy, masked row mean and token
accuracy (port of tpu_asr/ops/losses.py).

All three take the decoder's logits in the compute dtype (bf16 on the
card) and work in float32.
"""

from __future__ import annotations

import torch

from tpu_asr_torch import IGNORE_ID


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         ignore_id: int = IGNORE_ID
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Label-smoothed CE. logits [B, U, V]; targets [B, U] with ignore_id
    padding. Returns (loss normalized by #real tokens, #real tokens).

    eps is spread over the other V-1 classes (the reference's
    `one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)`), so
    CE = -((1 - eps - eps/(V-1)) * logp[target] + eps/(V-1) * sum_v logp[v])."""
    v = logits.shape[-1]
    valid = targets != ignore_id
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    logp_target = torch.gather(logp, -1, safe[..., None])[..., 0]
    if smoothing > 0.0:
        off = smoothing / (v - 1)
        nll = -((1.0 - smoothing - off) * logp_target + off * logp.sum(-1))
    else:
        nll = -logp_target
    n_tokens = valid.sum()
    loss = torch.where(valid, nll, 0.0).sum() / n_tokens.clamp(min=1)
    return loss, n_tokens


def masked_row_mean(per_row: torch.Tensor,
                    row_valid: torch.Tensor) -> torch.Tensor:
    """Mean of per-row losses over valid rows only: batches are padded with
    dummy rows (feat_lengths == 0) that must carry no loss."""
    n = row_valid.sum().clamp(min=1)
    return torch.where(row_valid, per_row, 0.0).sum() / n


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   ignore_id: int = IGNORE_ID) -> torch.Tensor:
    """Fraction of non-ignored positions predicted correctly."""
    valid = targets != ignore_id
    pred = logits.float().argmax(dim=-1)
    correct = (valid & (pred == targets)).sum()
    return correct / valid.sum().clamp(min=1)
