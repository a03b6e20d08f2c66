"""CTC helpers (port of tpu_asr/ops/ctc.py, decode side).

Only the greedy collapse is ported in this slice; the CTC loss (lattice
and kernel) comes with training.
"""

from __future__ import annotations

import torch


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
