"""SpecAugment on the device: frequency and time masks, optional time warp
(port of tpu_asr/augment.py).

The random draws are split from their application:
`draw_spec_augment(gen, feat_lengths, num_bins, cfg)` draws mask widths
and starts and the warp's centre and shift from an explicit
torch.Generator, on the device of the lengths; `apply_spec_augment(feats,
feat_lengths, draws, cfg)` applies them. Given the same draws the output
equals the reference's for its key, so the tests feed the port the draws
that jax.random makes. The formulas (starts = uniform * max(room, 1),
truncated; widths capped per utterance) are the reference's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    num_freq_masks: int = 2
    freq_mask_width: int = 27       # F in the SpecAugment paper
    num_time_masks: int = 2
    time_mask_width: int = 40       # T in the paper (frames)
    time_mask_max_ratio: float = 1.0  # cap widths at ratio * utt length
    mask_value: float = 0.0
    # W in the paper: warp a random interior frame by up to +-W frames
    # (0 = off, masking only)
    time_warp_window: int = 0


def draw_spec_augment(gen: torch.Generator, feat_lengths: torch.Tensor,
                      num_bins: int, cfg: SpecAugmentConfig) -> dict:
    """Random draws for one batch, on feat_lengths' device (gen must live
    there too). Returns int32 [B, M] freq_widths/freq_starts and
    time_widths/time_starts, and float32 [B] w0/dist (the warp's centre
    and shift; absent when time_warp_window is 0)."""
    b, dev = feat_lengths.shape[0], feat_lengths.device
    lens = feat_lengths.to(torch.int32)

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev)

    nf, nt = cfg.num_freq_masks, cfg.num_time_masks
    f_w = randint(0, cfg.freq_mask_width + 1, (b, nf))
    f_s = (uniform((b, nf)) * torch.clamp(num_bins - f_w, min=1)).int()
    t_cap = torch.clamp((lens.float() * cfg.time_mask_max_ratio).int(),
                        max=cfg.time_mask_width)
    t_w = torch.minimum(randint(0, cfg.time_mask_width + 1, (b, nt)),
                        t_cap[:, None])
    t_s = (uniform((b, nt)) * torch.clamp(lens[:, None] - t_w, min=1)).int()
    draws = dict(freq_widths=f_w, freq_starts=f_s, time_widths=t_w,
                 time_starts=t_s)
    w = cfg.time_warp_window
    if w > 0:
        room = torch.clamp(lens.float() - 2 * w, min=1.0)
        draws["w0"] = torch.floor(w + uniform((b,)) * room)
        draws["dist"] = randint(-w, w + 1, (b,)).float()
    return draws


def _time_warp(feats, feat_lengths, w0, dist, window: int):
    """Move frame w0 to w0 + dist and re-index time piecewise-linearly
    around it, sampling with linear interpolation. Frames past the valid
    length are untouched; utterances of 2W+1 frames or fewer are
    returned unwarped."""
    b, t, d = feats.shape
    lens = feat_lengths.float()
    can_warp = feat_lengths > 2 * window + 1
    w0_new = torch.clamp(w0 + dist, min=torch.ones_like(lens),
                         max=torch.clamp(lens - 2.0, min=1.0))
    last = torch.clamp(lens - 1.0, min=2.0)                  # map endpoint
    pos = torch.arange(t, device=feats.device, dtype=torch.float32)[None]
    left = pos * (w0 / w0_new)[:, None]
    right = (w0[:, None] + (pos - w0_new[:, None])
             * ((last - w0) / torch.clamp(last - w0_new, min=1e-6))[:, None])
    src = torch.where(pos <= w0_new[:, None], left, right)
    ident = (~can_warp)[:, None] | (pos >= lens[:, None])
    src = torch.where(ident, pos, torch.clamp(
        src, min=torch.zeros_like(src), max=last[:, None].expand_as(src)))
    lo = torch.floor(src)
    frac = (src - lo)[:, :, None]
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=t - 1)
    f_lo = torch.gather(feats, 1, lo[:, :, None].expand(b, t, d))
    f_hi = torch.gather(feats, 1, hi[:, :, None].expand(b, t, d))
    return (f_lo * (1.0 - frac) + f_hi * frac).to(feats.dtype)


def _range_mask(starts, widths, size: int):
    """[B, M] starts/widths -> [B, size] boolean, True where masked."""
    pos = torch.arange(size, device=starts.device)[None, None, :]
    m = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return m.any(dim=1)


def apply_spec_augment(feats: torch.Tensor, feat_lengths: torch.Tensor,
                       draws: dict, cfg: SpecAugmentConfig) -> torch.Tensor:
    """Apply drawn masks (and the warp) to a padded batch [B, T, D]."""
    b, t, d = feats.shape
    if cfg.time_warp_window > 0:
        feats = _time_warp(feats, feat_lengths, draws["w0"], draws["dist"],
                           cfg.time_warp_window)
    freq_mask = _range_mask(draws["freq_starts"], draws["freq_widths"], d)
    time_mask = _range_mask(draws["time_starts"], draws["time_widths"], t)
    masked = torch.where(freq_mask[:, None, :], cfg.mask_value, feats)
    return torch.where(time_mask[:, :, None], cfg.mask_value, masked)


def spec_augment(gen: torch.Generator, feats: torch.Tensor,
                 feat_lengths: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()
                 ) -> torch.Tensor:
    """Draw and apply SpecAugment for a padded batch [B, T, D]."""
    draws = draw_spec_augment(gen, feat_lengths, feats.shape[-1], cfg)
    return apply_spec_augment(feats, feat_lengths, draws, cfg)
