"""Padding helpers (host-side, numpy) + mask builders (tensors).

Port of tpu_asr/utils/padding.py. Batches are padded to static bucket
shapes; masks are boolean with True at VALID (or allowed) positions.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_list(arrays, pad_value, target_len: int | None = None) -> np.ndarray:
    """Stack variable-length numpy arrays, padding the first axis.

    target_len pins a static padded length (bucket boundary); default is the
    batch max.
    """
    arrays = [np.asarray(a) for a in arrays]
    max_len = max(a.shape[0] for a in arrays)
    tlen = target_len if target_len is not None else max_len
    if tlen < max_len:
        raise ValueError(f"target_len {tlen} < longest array {max_len}")
    out = np.full((len(arrays), tlen, *arrays[0].shape[1:]), pad_value,
                  dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] boolean, True at VALID positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def make_causal_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] boolean, True where attention is ALLOWED (lower tri)."""
    return torch.ones((size, size), dtype=torch.bool, device=device).tril()
