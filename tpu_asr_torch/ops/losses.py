"""Sequence losses: label-smoothed cross-entropy, masked row mean and token
accuracy (port of tpu_asr/ops/losses.py).

All three take the decoder's logits in the compute dtype (bf16 on the
card) and work in float32.

Each takes an optional `n_total`, the count it divides by. A data-
parallel rank holds a shard of the batch, but the reference normalizes
over the global batch (GSPMD computes its means there), so a rank passes
the global count (`loss_counts` of the whole host batch): its term is
then its shard's sum over that count, and the sum of the ranks' terms is
the global mean. A shard of dummy rows only gives 0.
"""

from __future__ import annotations

import torch

from tpu_asr_torch import IGNORE_ID


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.1,
                         ignore_id: int = IGNORE_ID,
                         n_total: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Label-smoothed CE. logits [B, U, V]; targets [B, U] with ignore_id
    padding. Returns (loss normalized by #real tokens, or by n_total, and
    #real tokens).

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
    n = n_tokens if n_total is None else n_total
    loss = torch.where(valid, nll, 0.0).sum() / n.clamp(min=1)
    return loss, n_tokens


def masked_row_mean(per_row: torch.Tensor, row_valid: torch.Tensor,
                    n_total: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of per-row losses over valid rows only (or over n_total
    rows): batches are padded with dummy rows (feat_lengths == 0) that
    must carry no loss."""
    n = (row_valid.sum() if n_total is None else n_total).clamp(min=1)
    return torch.where(row_valid, per_row, 0.0).sum() / n


def token_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                   ignore_id: int = IGNORE_ID,
                   n_total: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of non-ignored positions (or of n_total) predicted
    correctly."""
    valid = targets != ignore_id
    pred = logits.float().argmax(dim=-1)
    correct = (valid & (pred == targets)).sum()
    return correct / (valid.sum() if n_total is None else n_total
                      ).clamp(min=1)


def loss_counts(feat_lengths: torch.Tensor, targets: torch.Tensor,
                target_lengths: torch.Tensor,
                ignore_id: int = IGNORE_ID) -> dict[str, torch.Tensor]:
    """The counts the losses divide by, over a whole batch: "rows", its
    real rows (feat_lengths > 0), and "tokens", the real positions of
    its decoder targets, targets + eos (models.transformer.add_sos_eos)
    on the real rows."""
    row_valid = feat_lengths > 0
    b, u = targets.shape
    pos = torch.arange(u + 1, device=targets.device)[None, :]
    real = torch.cat([targets != ignore_id,
                      torch.zeros((b, 1), dtype=torch.bool,
                                  device=targets.device)], dim=1)
    real = (real | (pos == target_lengths[:, None])) & row_valid[:, None]
    return {"rows": row_valid.sum(), "tokens": real.sum()}
