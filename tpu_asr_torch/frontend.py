"""Acoustic frontend: waveform -> 80-dim log-mel fbank + CMVN (port of
tpu_asr/frontend.py).

Conventions follow Kaldi fbank defaults (dither off): 25 ms window / 10 ms
hop @ 16 kHz, remove-DC-offset per frame, preemphasis 0.97, povey window,
512-point FFT, 80 mel bins from 20 Hz to Nyquist, natural log, snip-edges.
The DFT (window folded in) and the mel projection are three matrix
products; the constants are built in numpy float64 and stored as float32.

Ported: `cmvn_mode` "utterance", "global" and "none". Global CMVN reads
the train set's mean and istd from an .npz (python -m
tpu_asr_torch.compute_cmvn, or the reference's bin/compute_cmvn.py:
both write the same keys and the same fingerprint). Pitch and LFR
stacking raise NotImplementedError until a later slice ports them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0       # <= 0 means offset from Nyquist (Kaldi style)
    preemphasis: float = 0.97
    window: str = "povey"        # povey | hann | hamming
    use_log: bool = True
    log_floor: float = 1e-10
    remove_dc: bool = True
    dtype: torch.dtype = torch.float32
    # CMVN policy: per-utterance online stats (the default), "global"
    # train-set mean/istd loaded from cmvn_stats_path (an .npz written by
    # compute_cmvn; the causal choice for streaming), or none
    cmvn_mode: str = "utterance"  # utterance | global | none
    cmvn_stats_path: str = ""
    add_pitch: bool = False       # not ported
    pitch_min_f0: float = 60.0
    pitch_max_f0: float = 400.0
    pitch_smooth_weight: float = 0.0

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.frame_length:
            n *= 2
        return n

    def num_frames(self, num_samples: int) -> int:
        """Snip-edges frame count for a given number of samples."""
        if num_samples < self.frame_length:
            return 0
        return 1 + (num_samples - self.frame_length) // self.frame_shift

    @property
    def feature_dim(self) -> int:
        return self.num_mel_bins + (3 if self.add_pitch else 0)


def _window_coeffs(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window == "hann":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    else:
        raise ValueError(f"unknown window {cfg.window!r}")
    return w.astype(np.float64)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """[fft_size//2+1, num_mel_bins] triangular mel filterbank (Kaldi-style)."""
    def hz_to_mel(hz):
        return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)

    nyquist = cfg.sample_rate / 2.0
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    n_bins = cfg.fft_size // 2 + 1
    mel_lo, mel_hi = hz_to_mel(cfg.low_freq), hz_to_mel(high)
    mel_pts = np.linspace(mel_lo, mel_hi, cfg.num_mel_bins + 2)
    fft_freqs = (np.arange(n_bins, dtype=np.float64) * cfg.sample_rate
                 / cfg.fft_size)
    fft_mels = hz_to_mel(fft_freqs)
    left, center, right = mel_pts[:-2], mel_pts[1:-1], mel_pts[2:]
    up = (fft_mels[:, None] - left[None, :]) / (center - left)[None, :]
    down = (right[None, :] - fft_mels[:, None]) / (right - center)[None, :]
    fb = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float64)


def _dft_basis(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases [frame_length, fft_size//2+1] (zero-padded DFT)."""
    n_fft = cfg.fft_size
    n_bins = n_fft // 2 + 1
    t = np.arange(cfg.frame_length, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = -2.0 * math.pi * t[:, None] * k[None, :] / n_fft
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=8)
def _frontend_constants(cfg: FrontendConfig):
    """(cos basis, sin basis, mel) float32 numpy; window folded into the
    DFT bases so one product does window + DFT."""
    win = _window_coeffs(cfg)
    cos_b, sin_b = _dft_basis(cfg)
    cos_b = cos_b * win[:, None]
    sin_b = sin_b * win[:, None]
    mel = mel_filterbank(cfg)
    f32 = np.float32
    return cos_b.astype(f32), sin_b.astype(f32), mel.astype(f32)


@functools.lru_cache(maxsize=8)
def _device_constants(cfg: FrontendConfig, device: torch.device):
    """_frontend_constants as tensors on `device`, copied there once."""
    return tuple(torch.from_numpy(c).to(device)
                 for c in _frontend_constants(cfg))


def frame_signal(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[..., S] waveform -> [..., T, frame_length] frames (snip-edges),
    T = cfg.num_frames(S). A strided view, no copy."""
    t = cfg.num_frames(wav.shape[-1])
    if t == 0:
        return wav.new_zeros((*wav.shape[:-1], 0, cfg.frame_length))
    return wav.unfold(-1, cfg.frame_length, cfg.frame_shift)


@contextlib.contextmanager
def _full_fp32_matmul():
    """The reference runs the three spectral products at
    Precision.HIGHEST: spectral magnitudes at TF32-class precision lose too
    much before the log. Force full float32 (TF32 off) around them and
    restore the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def log_mel_spectrogram(wav: torch.Tensor,
                        cfg: FrontendConfig = FrontendConfig()
                        ) -> torch.Tensor:
    """Batched waveform [..., S] -> log-mel features [..., T, num_mel_bins].

    Padding samples produce garbage frames past the true frame count; mask
    with `frame_lengths` (see `wav_to_features`)."""
    cos_b, sin_b, mel = _device_constants(cfg, wav.device)
    frames = frame_signal(wav.float(), cfg)                   # [..., T, L]
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis > 0.0:
        # Kaldi: first sample preemphasized against itself.
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * prev
    with _full_fp32_matmul():
        re = frames @ cos_b
        im = frames @ sin_b
        power = re * re + im * im
        melspec = power @ mel
    if cfg.use_log:
        melspec = torch.log(torch.clamp(melspec, min=cfg.log_floor))
    return melspec.to(cfg.dtype)


def cmvn(feats: torch.Tensor, lengths: torch.Tensor | None = None,
         norm_var: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """Per-utterance cepstral mean (and variance) normalization.

    feats: [..., T, D]; lengths: [...] valid frame counts (None = all valid).
    """
    if lengths is None:
        mean = feats.mean(dim=-2, keepdim=True)
        var = (feats - mean).square().mean(dim=-2, keepdim=True)
    else:
        t = feats.shape[-2]
        pos = torch.arange(t, device=feats.device)
        mask = (pos < lengths[..., None]).to(feats.dtype)[..., None]
        denom = torch.clamp(mask.sum(dim=-2, keepdim=True), min=1.0)
        mean = (feats * mask).sum(dim=-2, keepdim=True) / denom
        var = ((feats - mean).square() * mask).sum(dim=-2,
                                                   keepdim=True) / denom
    out = feats - mean
    if norm_var:
        out = out * torch.rsqrt(var + eps)
    return out


def feature_fingerprint(cfg: FrontendConfig) -> str:
    """Canonical string of every FrontendConfig field that changes the
    feature space, stored in CMVN-stats .npz files so that stats of one
    frontend cannot normalize the features of another. Character for
    character the reference's, so a stats file written by either package
    loads in the other (the pitch part included, though pitch is not
    ported)."""
    pitch = (f";pitch={cfg.pitch_min_f0}-{cfg.pitch_max_f0}"
             f";psmooth={cfg.pitch_smooth_weight}"
             if cfg.add_pitch else "")
    return (f"sr={cfg.sample_rate};flen={cfg.frame_length_ms};"
            f"fshift={cfg.frame_shift_ms};mels={cfg.num_mel_bins};"
            f"lo={cfg.low_freq};hi={cfg.high_freq};"
            f"preemph={cfg.preemphasis};win={cfg.window};"
            f"log={cfg.use_log};floor={cfg.log_floor};dc={cfg.remove_dc}"
            + pitch)


@functools.lru_cache(maxsize=8)
def load_cmvn_stats(
        path: str) -> tuple[np.ndarray, np.ndarray, str | None]:
    """(mean [D], istd [D], fingerprint or None) from a CMVN-stats .npz
    (no fingerprint in files written before the reference stored one).
    Cached as numpy: the tensors are made on the features' device at
    each use, so the cache holds no device memory."""
    with np.load(path) as z:
        fp = str(z["fingerprint"]) if "fingerprint" in z else None
        return (np.asarray(z["mean"], np.float32),
                np.asarray(z["istd"], np.float32), fp)


def global_cmvn_tensors(cfg: FrontendConfig, device: torch.device | str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean [D], istd [D]) of cfg's stats file on `device`. Raises
    ValueError when there is no stats path or the stats' fingerprint is
    not the active frontend's. A caller that normalizes many batches
    (TrainStep, EvalStep, Recognizer) makes the pair once and passes it
    to wav_to_features, so the stats cross to the device once."""
    if not cfg.cmvn_stats_path:
        raise ValueError("cmvn_mode='global' needs cmvn_stats_path")
    mean, istd, fp = load_cmvn_stats(cfg.cmvn_stats_path)
    want = feature_fingerprint(cfg)
    if fp is not None and fp != want:
        raise ValueError(
            f"CMVN stats {cfg.cmvn_stats_path} were computed under a "
            f"different frontend:\n  stats:  {fp}\n  active: {want}\n"
            f"recompute them with python -m tpu_asr_torch.compute_cmvn "
            f"and the matching frontend (--frontend-json)")
    return (torch.from_numpy(mean).to(device),
            torch.from_numpy(istd).to(device))


def cmvn_stats_for(cfg: FrontendConfig, device: torch.device | str
                   ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """global_cmvn_tensors under cmvn_mode "global", else None."""
    return (global_cmvn_tensors(cfg, device) if cfg.cmvn_mode == "global"
            else None)


def apply_global_cmvn(feats: torch.Tensor, cfg: FrontendConfig,
                      stats: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> torch.Tensor:
    """(feats - mean) * istd with the train set's stats (Kaldi
    apply-cmvn): `stats` from global_cmvn_tensors on feats' device, or,
    without it, cfg's stats file read here (ValueError as there)."""
    mean, istd = stats if stats is not None else global_cmvn_tensors(
        cfg, feats.device)
    return (feats - mean) * istd


def wav_to_features(wav: torch.Tensor, wav_lengths: torch.Tensor,
                    cfg: FrontendConfig = FrontendConfig(),
                    apply_cmvn: bool = True,
                    cmvn_stats: tuple[torch.Tensor, torch.Tensor] | None
                    = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded waveforms [B, S] + lengths [B] -> (feats [B, T, D],
    frame_lengths [B]). Frames past frame_lengths[b] are zeroed.
    `cmvn_stats`: global CMVN's (mean, istd) on the device
    (cmvn_stats_for), else read from cfg's stats file at each call."""
    if cfg.add_pitch:
        raise NotImplementedError("pitch features are not ported yet")
    feats = log_mel_spectrogram(wav, cfg)
    num = 1 + torch.clamp(wav_lengths - cfg.frame_length, min=0) \
        // cfg.frame_shift
    frame_lengths = torch.where(wav_lengths < cfg.frame_length,
                                torch.zeros_like(num), num)
    if apply_cmvn and cfg.cmvn_mode == "utterance":
        feats = cmvn(feats, frame_lengths)
    elif apply_cmvn and cfg.cmvn_mode == "global":
        feats = apply_global_cmvn(feats, cfg, cmvn_stats)
    elif apply_cmvn and cfg.cmvn_mode != "none":
        raise ValueError(f"unknown cmvn_mode {cfg.cmvn_mode!r}")
    t = feats.shape[-2]
    valid = torch.arange(t, device=feats.device)[None, :] \
        < frame_lengths[:, None]
    return feats.masked_fill(~valid[..., None], 0.0), frame_lengths
