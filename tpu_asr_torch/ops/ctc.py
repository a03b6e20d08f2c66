"""CTC lattice, loss reductions and greedy collapse (port of
tpu_asr/ops/ctc.py).

Conventions: logits [B, T, V] unnormalized; labels [B, U] padded with any
id (masked by label_lengths); blank defaults to 0. Lattice positions are
S = 2U + 1: blank, l1, blank, l2, ..., blank. Log-space values use the
finite NEG_INF = -1e30, never -inf.

The loss itself is tpu_asr_torch.ops.ctc_loss.ctc_loss_kernel: its alpha
and beta recursions run as CUDA kernels on the card and as plain torch
loops on the CPU. This module supplies the lattice pieces it uses, and
the forced alignment (ctc_viterbi_align: the max-product recursion on
the device, the backtrace on the host, as the reference's).

The reference gathers emissions with a one-hot matrix product because
gathers along V are slow on a TPU. Here it is `torch.gather`, whose
backward is the scatter-add into the logits' gradient.
"""

from __future__ import annotations

import numpy as np
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


def lattice_emissions(logits: torch.Tensor, z: torch.Tensor,
                      log_input: bool = False) -> torch.Tensor:
    """E[b,t,s] = log_softmax(logits)[b,t,z_s] in float32, without
    materializing the [B, T, V] log-probabilities: gather the S lattice
    symbols and subtract the per-frame logsumexp (taken in float32). With
    log_input the inputs are log-probabilities already: E is their
    float32 gather.

    The gather reads the float32 copy that the logsumexp needs anyway: the
    values equal a bf16 gather cast to float32, and the backward's
    scatter-add (U+1 blank positions land on the same logit) accumulates
    in float32 before the single cast back to the logits' dtype."""
    lf = logits.float()
    b, t, _ = lf.shape
    idx = z[:, None, :].expand(b, t, z.shape[1]).long()
    gathered = torch.gather(lf, 2, idx)
    if log_input:
        return gathered
    return gathered - torch.logsumexp(lf, dim=-1, keepdim=True)


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


def ctc_viterbi_align(logits: torch.Tensor, labels: torch.Tensor,
                      logit_lengths: torch.Tensor,
                      label_lengths: torch.Tensor, blank: int = 0,
                      log_input: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """CTC forced alignment: the Viterbi (best) path through the
    blank/label lattice, as per-token frame spans.

    -> (starts [B, U], ends [B, U]) int32 on the host: the first and last
    frame the best path spends on each label state (inclusive; -1 past
    label_lengths, and on rows with no frames or no labels). The
    max-product recursion runs a frame at a time on the logits' device
    (ties to the first of stay, prev, skip, as jnp.argmax over the
    stacked three); its int8 backpointers [T-1, B, S] come to the host
    in one copy, and the backtrace is the reference's host loop."""
    b, t, _ = logits.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = logits.device
    z = _interleave_blanks(labels, blank)
    allow_skip, valid_s = lattice_masks(z, label_lengths, blank)
    emissions = lattice_emissions(logits, z, log_input)        # [B, T, S]
    has_labels = label_lengths > 0
    delta = torch.full((b, s), NEG_INF, device=dev)
    delta[:, 0] = emissions[:, 0, 0]
    if s > 1:
        delta[:, 1] = torch.where(has_labels, emissions[:, 0, 1], NEG_INF)
    pad1 = torch.full((b, 1), NEG_INF, device=dev)
    pad2 = torch.full((b, 2), NEG_INF, device=dev)
    bps = torch.zeros((max(t - 1, 0), b, s), dtype=torch.int8, device=dev)
    for t_idx in range(1, t):
        d_prev = torch.cat([pad1, delta[:, :-1]], dim=1)
        d_skip = torch.cat([pad2, delta[:, :-2]], dim=1)[:, :s]
        d_skip = torch.where(allow_skip, d_skip, NEG_INF)
        new, best = torch.max(torch.stack([delta, d_prev, d_skip]), dim=0)
        new = torch.where(valid_s, new + emissions[:, t_idx], NEG_INF)
        active = (t_idx < logit_lengths)[:, None]
        delta = torch.where(active, new, delta)
        bps[t_idx - 1] = torch.where(active, best, 0)
    # the terminal state: the better of the final blank and final label
    end_s = 2 * label_lengths.long()
    end_m1 = torch.clamp(end_s - 1, min=0)
    d_end = delta.gather(1, end_s[:, None])[:, 0]
    d_end_m1 = torch.where(has_labels, delta.gather(1, end_m1[:, None])[:, 0],
                           NEG_INF)
    last_state = torch.where(d_end >= d_end_m1, end_s, end_m1)

    bps_np, last_np, tl, ul = (x.cpu().numpy() for x in (
        bps, last_state, logit_lengths, label_lengths))
    starts = np.full((b, u), -1, np.int32)
    ends = np.full((b, u), -1, np.int32)
    for i in range(b):
        if tl[i] <= 0 or ul[i] <= 0:
            continue
        s_cur = int(last_np[i])
        for t_idx in range(int(tl[i]) - 1, -1, -1):
            if s_cur % 2 == 1:                       # a label state
                tok = (s_cur - 1) // 2
                starts[i, tok] = t_idx
                if ends[i, tok] < 0:
                    ends[i, tok] = t_idx
            if t_idx > 0:
                s_cur -= int(bps_np[t_idx - 1, i, s_cur])
    return torch.from_numpy(starts), torch.from_numpy(ends)
