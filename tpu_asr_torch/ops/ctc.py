"""CTC lattice, loss reductions and greedy collapse (port of
tpu_asr/ops/ctc.py).

Conventions: logits [B, T, V] unnormalized; labels [B, U] padded with any
id (masked by label_lengths); blank defaults to 0. Lattice positions are
S = 2U + 1: blank, l1, blank, l2, ..., blank. Log-space values use the
finite NEG_INF = -1e30, never -inf.

The loss itself is tpu_asr_torch.ops.ctc_loss.ctc_loss_kernel: its alpha
and beta recursions run as CUDA kernels on the card and as plain torch
loops on the CPU. This module supplies the lattice pieces it uses.

The reference gathers emissions with a one-hot matrix product because
gathers along V are slow on a TPU. Here it is `torch.gather`, whose
backward is the scatter-add into the logits' gradient.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _interleave_blanks(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, U] -> [B, 2U+1] lattice symbols: blank, l1, blank, ..., blank."""
    b, u = labels.shape
    z = torch.full((b, 2 * u + 1), blank, dtype=labels.dtype,
                   device=labels.device)
    z[:, 1::2] = labels
    return z


def lattice_masks(z: torch.Tensor, label_lengths: torch.Tensor,
                  blank: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(allow_skip, valid) [B, S] booleans for lattice symbols z.

    allow_skip[s]: the s-2 -> s transition is legal (z_s is a label and
    differs from z_{s-2}); valid[s]: s <= 2 * label_length."""
    b, s = z.shape
    z_shift2 = torch.cat([torch.full((b, 2), blank, dtype=z.dtype,
                                     device=z.device), z[:, :-2]],
                         dim=1)[:, :s]                # S = 1: no labels
    allow_skip = (z != blank) & (z != z_shift2)
    allow_skip[:, :2] = False
    s_pos = torch.arange(s, device=z.device)[None, :]
    valid = s_pos <= 2 * label_lengths[:, None]
    return allow_skip, valid


def lattice_emissions(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """E[b,t,s] = log_softmax(logits)[b,t,z_s] in float32, without
    materializing the [B, T, V] log-probabilities: gather the S lattice
    symbols and subtract the per-frame logsumexp (taken in float32).

    The gather reads the float32 copy that the logsumexp needs anyway: the
    values equal a bf16 gather cast to float32, and the backward's
    scatter-add (U+1 blank positions land on the same logit) accumulates
    in float32 before the single cast back to the logits' dtype."""
    lf = logits.float()
    b, t, _ = lf.shape
    idx = z[:, None, :].expand(b, t, z.shape[1]).long()
    return (torch.gather(lf, 2, idx)
            - torch.logsumexp(lf, dim=-1, keepdim=True))


def reduce_nll(nll: torch.Tensor, logit_lengths: torch.Tensor,
               label_lengths: torch.Tensor, reduction: str) -> torch.Tensor:
    """zero_infinity (infeasible utterances get loss 0), then reduce:
    'mean_label' = mean of nll / label_length (torch.nn.CTCLoss's 'mean'),
    'sum' or 'none'."""
    feasible = logit_lengths >= label_lengths
    nll = torch.where(feasible & (nll < -NEG_INF / 2), nll, 0.0)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean_label":
        return (nll / label_lengths.clamp(min=1)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_greedy_collapse(ids: torch.Tensor, lengths: torch.Tensor,
                        blank: int = 0, pad_id: int = -1,
                        return_times: bool = False):
    """Greedy CTC collapse, vectorized: collapse repeats, drop blanks,
    left-pack the survivors.

    ids: [B, T] argmax frame labels; lengths: [B] valid frames. Returns
    (tokens [B, T] pad_id-padded, token_lengths [B]) and, with
    return_times, the emission frame of each token (first frame of its
    run, -1 padded)."""
    b, t = ids.shape
    prev = torch.cat([torch.full((b, 1), -12345, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    frame = torch.arange(t, device=ids.device)[None, :]
    valid = (ids != blank) & (ids != prev) & (frame < lengths[:, None])
    # left-pack: key = frame index where valid else T, stable sort
    pos = torch.where(valid, frame, t)
    order = torch.argsort(pos, dim=1, stable=True)
    packed = torch.gather(ids, 1, order)
    n = valid.sum(dim=1)
    keep = frame < n[:, None]
    packed = torch.where(keep, packed, pad_id)
    if not return_times:
        return packed, n
    times = torch.where(keep, torch.gather(pos, 1, order), -1)
    return packed, n, times
