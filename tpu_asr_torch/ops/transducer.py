"""RNN-T (transducer) loss in plain PyTorch (port of
tpu_asr/ops/transducer.py).

* `transducer_forward` — the alpha recursion over the (T, U) lattice
  from per-node blank/emit log-probs. Within a frame the recurrence
  ``a[u] = logaddexp(below[u], a[u-1] + emit[u-1])`` is a linear
  recurrence in the log semiring; `_row_scan` solves it with a
  Hillis-Steele doubling scan over the reference's combine (log2(U+1)
  vector steps a frame, not a loop over U), and a Python loop walks the
  frames. The reference's closed alternative, cumsum + logcumsumexp,
  subtracts sums of log-probs and breaks on the -1e30 masks, so it is
  not used.

* `transducer_loss` — the memory-critical path. The joint network
  ``logits = tanh(f_t + g) @ w_out + b_out`` over all T frames would be
  [B, T, U+1, V] float32 (2 GB at 16 x 240 x 31 x 4233, and as much again
  for its log-softmax). Its blank/emit log-probs do not depend on the
  alpha recursion, so `transducer_forward_fused` computes them a chunk of
  frames at a time under `torch.utils.checkpoint`: the backward rebuilds
  each chunk's logits instead of keeping T frames of them, and a chunk
  holds at most JOINT_CHUNK_BYTES of float32 logits (one frame at the
  least). The recursion then runs on the [B, T, U+1] log-probs.

Conventions as the reference's: blank id 0, NEG_INF = -1e30 (never
-inf), lengths mask padded frames and labels, a float32 lattice, dummy
rows (logit_lengths == 0) give 0, reductions none | sum | mean |
mean_label (torch's reduction='mean' semantics).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
JOINT_CHUNK_BYTES = 256 << 20    # float32 logits a checkpointed chunk holds


def _row_scan(below: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Solve a[u] = logaddexp(below[u], a[u-1] + emit[u-1]) over u.

    below: [B, U1]; emit: [B, U] (emit[u] joins row position u -> u+1).
    Element (c, b) stands for the map a -> logaddexp(b, a + c); (c1, b1)
    then (c2, b2) composes to (c1 + c2, logaddexp(b2, b1 + c2)). The
    inclusive scan of these maps, with a[-1] = -inf, leaves a in the b
    slots."""
    u1 = below.shape[1]
    c = torch.cat([torch.full_like(below[:, :1], NEG_INF), emit], dim=1)
    a = below
    shift = 1
    while shift < u1:
        a = torch.cat([a[:, :shift], torch.logaddexp(
            a[:, shift:], a[:, :-shift] + c[:, shift:])], dim=1)
        if shift * 2 < u1:
            c = torch.cat([c[:, :shift], c[:, :-shift] + c[:, shift:]], dim=1)
        shift *= 2
    return a


def transducer_forward(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                       logit_lengths: torch.Tensor,
                       label_lengths: torch.Tensor) -> torch.Tensor:
    """Alpha recursion from per-node log-probs -> per-utterance NLL [B].

    blank_lp [B, T, U1] log P(blank | t, u); emit_lp [B, T, U] log
    P(y_{u+1} | t, u). alpha[t, u] = logaddexp(alpha[t-1, u] +
    blank[t-1, u], alpha[t, u-1] + emit[t, u-1]); the log-likelihood is
    alpha[T-1, U] + blank[T-1, U] at each row's own lengths (NEG_INF past
    them: a dummy row's NLL is -NEG_INF)."""
    b, t, u1 = blank_lp.shape
    dev = blank_lp.device
    label_lengths = label_lengths.long()
    logit_lengths = logit_lengths.long()
    u_pos = torch.arange(u1, device=dev)
    # labels beyond the true length can never be consumed
    label_valid = u_pos[None, : u1 - 1] < label_lengths[:, None]   # [B, U]
    emit_lp = torch.where(label_valid[:, None, :], emit_lp, NEG_INF)
    below = torch.where(u_pos == 0, 0.0, NEG_INF).to(torch.float32)
    below = below[None, :].expand(b, u1)
    ll = torch.full((b,), NEG_INF, device=dev)
    last = logit_lengths - 1
    terminal = label_lengths[:, None]
    for t_idx in range(t):
        top = _row_scan(below, emit_lp[:, t_idx]) + blank_lp[:, t_idx]
        # the terminal node, read on each utterance's last frame
        ll = torch.where(last == t_idx, torch.gather(top, 1, terminal)[:, 0],
                         ll)
        # rows past their last frame keep their row (no-ops)
        below = torch.where((last > t_idx)[:, None], top, below)
    return -ll


def joint_log_probs(f, g, w_out, b_out, labels, blank: int = 0,
                    act=torch.tanh):
    """The joint network's blank/emit log-probs of one frame or a chunk.

    f: [B, H] (one frame) or [B, F, H] (F frames), the encoder-side
    projection; g: [B, U1, H] predictor projections; w_out [H, V], b_out
    [V]; labels [B, U]. -> (blank_lp [B, (F,) U1], emit_lp [B, (F,) U])
    in float32. The emit gather is exact (the reference's one-hot einsum
    at HIGHEST gives the same bits)."""
    one = f.dim() == 2
    if one:
        f = f[:, None]
    joint = act(f[:, :, None, :] + g[:, None, :, :])           # [B,F,U1,H]
    logits = (joint @ w_out + b_out).float()                   # [B,F,U1,V]
    lse = torch.logsumexp(logits, dim=-1)
    blank_lp = logits[..., blank] - lse
    b, n_f, u1, _ = logits.shape
    idx = labels.long()[:, None, :, None].expand(b, n_f, u1 - 1, 1)
    emit = torch.gather(logits[:, :, :-1], 3, idx)[..., 0] - lse[..., :-1]
    return (blank_lp[:, 0], emit[:, 0]) if one else (blank_lp, emit)


def transducer_forward_fused(f, g, w_out, b_out, labels, logit_lengths,
                             label_lengths, blank: int = 0,
                             act=torch.tanh) -> torch.Tensor:
    """NLL [B] with the joint network computed chunk by chunk of frames.

    f: [B, T, H] (encoder side, pre-activation); g: [B, U1, H] (row u =
    history y_1..y_u); w_out/b_out: the joint output projection. While
    autograd records, each chunk's joint runs under a checkpoint, so the
    backward keeps one chunk's logits at a time (module docstring)."""
    b, t, _ = f.shape
    per_frame = b * g.shape[1] * w_out.shape[1] * 4
    frames = max(1, min(t, JOINT_CHUNK_BYTES // max(per_frame, 1)))
    record = torch.is_grad_enabled() and any(
        x.requires_grad for x in (f, g, w_out, b_out))
    blanks, emits = [], []
    for s in range(0, t, frames):
        args = (f[:, s: s + frames], g, w_out, b_out, labels, blank, act)
        out = (checkpoint(joint_log_probs, *args, use_reentrant=False)
               if record else joint_log_probs(*args))
        blanks.append(out[0])
        emits.append(out[1])
    return transducer_forward(torch.cat(blanks, 1), torch.cat(emits, 1),
                              logit_lengths, label_lengths)


def _reduce(nll, logit_lengths, label_lengths, reduction: str):
    """Dummy rows (logit_lengths == 0, the loader's padding) and
    infeasible ones contribute 0, as ops/ctc.py's zero_infinity."""
    feasible = logit_lengths > 0
    nll = torch.where(feasible & (nll < -NEG_INF / 2), nll, 0.0)
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.mean()
    if reduction == "mean_label":
        return (nll / label_lengths.clamp(min=1)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def transducer_loss(f, g, w_out, b_out, labels, logit_lengths,
                    label_lengths, blank: int = 0,
                    reduction: str = "mean_label",
                    act=torch.tanh) -> torch.Tensor:
    """Transducer NLL with reductions (see transducer_forward_fused)."""
    nll = transducer_forward_fused(f, g, w_out, b_out, labels,
                                   logit_lengths, label_lengths, blank, act)
    return _reduce(nll, logit_lengths, label_lengths, reduction)


def transducer_loss_from_logits(logits, labels, logit_lengths,
                                label_lengths, blank: int = 0,
                                reduction: str = "none") -> torch.Tensor:
    """NLL from fully materialized joint logits [B, T, U1, V]: the test
    and small-model path, on the same recursion as the fused one."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    b, t, u1, _ = lp.shape
    idx = labels.long()[:, None, :, None].expand(b, t, u1 - 1, 1)
    emit_lp = torch.gather(lp[:, :, : u1 - 1], 3, idx)[..., 0]
    nll = transducer_forward(lp[..., blank], emit_lp, logit_lengths,
                             label_lengths)
    return _reduce(nll, logit_lengths, label_lengths, reduction)
