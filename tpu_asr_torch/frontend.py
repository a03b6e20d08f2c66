"""Acoustic frontend: waveform -> 80-dim log-mel fbank (+ 3 pitch dims)
+ CMVN, and LFR frame stacking (port of tpu_asr/frontend.py).

Conventions follow Kaldi fbank defaults (dither off): 25 ms window / 10 ms
hop @ 16 kHz, remove-DC-offset per frame, preemphasis 0.97, povey window,
512-point FFT, 80 mel bins from 20 Hz to Nyquist, natural log, snip-edges.
The DFT (window folded in) and the mel projection are three matrix
products; the constants are built in numpy float64 and stored as float32.

Ported: `cmvn_mode` "utterance", "global" and "none". Global CMVN reads
the train set's mean and istd from an .npz (python -m
tpu_asr_torch.compute_cmvn, or the reference's bin/compute_cmvn.py:
both write the same keys and the same fingerprint).

Pitch (`add_pitch`, Kaldi's "fbank+pitch" of the AISHELL recipe) pastes
POV, normalized log-pitch and delta-pitch onto the fbank, before CMVN:
a per-frame NCCF from three float32 DFT products and an inverse
projection (TF32 off), the shortest lag within 0.025 of the peak or,
with `pitch_smooth_weight` > 0, a Viterbi lag track, then a parabolic
refinement. `build_lfr_features` stacks frames for the linear input
layer (the reference lineage's LFR(4, 3)).

Whisper's log-mel (`WhisperFrontendConfig`, `whisper_log_mel`; openai/
whisper audio.py, which the reference has no counterpart of) is another
feature space: the waveform zero-padded (or cut) to the 30 s window,
a centred, reflect-padded STFT of n_fft 400 and hop 160 under a periodic
Hann window, its power with the last frame dropped, 128 Slaney mel
filters (librosa's filters.mel, htk False) from 0 to 8 kHz, log10 over a
1e-10 floor, clamped to the utterance's maximum minus 8, then (x + 4) /
4; no pre-emphasis, DC removal or CMVN. `wav_to_features` takes it when
given a WhisperFrontendConfig.
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
    # pitch: 3 dims (POV, normalized log-pitch, delta) pasted onto the
    # fbank; pitch_smooth_weight > 0 tracks lags by Viterbi (see
    # pitch_features)
    add_pitch: bool = False
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


@dataclasses.dataclass(frozen=True)
class WhisperFrontendConfig:
    """openai/whisper audio.py: SAMPLE_RATE 16000, N_FFT 400 (the 25 ms
    frame_length, no zero padding), HOP_LENGTH 160, n_mels 128 (80 before
    large-v3) over 0-8000 Hz, the window of CHUNK_LENGTH 30 s. Only what
    whisper_log_mel reads: Whisper has no pre-emphasis, DC removal,
    dither, pitch or CMVN to set."""
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 128
    low_freq: float = 0.0
    high_freq: float = 8000.0
    log_floor: float = 1e-10
    chunk_s: float = 30.0
    dtype: torch.dtype = torch.float32

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        return self.frame_length

    @property
    def feature_dim(self) -> int:
        return self.num_mel_bins

    @property
    def window_samples(self) -> int:
        """N_SAMPLES: the window every waveform is padded or cut to."""
        return int(round(self.chunk_s * self.sample_rate))

    @property
    def window_frames(self) -> int:
        """N_FRAMES: the mel frames of the window (3000 for 30 s)."""
        return self.window_samples // self.frame_shift


def slaney_mel_filters(cfg: WhisperFrontendConfig) -> np.ndarray:
    """[fft_size//2+1, num_mel_bins] float64: librosa's filters.mel with
    htk=False and norm "slaney" (Whisper's mel_filters.npz): triangles on
    the Slaney scale (linear to 1 kHz, logarithmic above) between
    low_freq and high_freq, each scaled by 2 / its width in Hz."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(
            np.maximum(f, min_log_hz) / min_log_hz) / logstep, f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(
            logstep * (m - min_log_mel)), f_sp * m)

    n_bins = cfg.fft_size // 2 + 1
    fft_freqs = np.arange(n_bins, dtype=np.float64) * cfg.sample_rate \
        / cfg.fft_size
    mel_f = mel_to_hz(np.linspace(hz_to_mel(cfg.low_freq),
                                  hz_to_mel(cfg.high_freq),
                                  cfg.num_mel_bins + 2))
    ramps = mel_f[:, None] - fft_freqs[None, :]
    fdiff = np.diff(mel_f)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.T


@functools.lru_cache(maxsize=8)
def _whisper_constants(cfg: WhisperFrontendConfig, device: torch.device):
    """(periodic Hann window [n_fft], mel filters [n_mels, bins]) float32
    on `device`, made there once."""
    window = torch.hann_window(cfg.fft_size, periodic=True,
                               dtype=torch.float32)
    mel = torch.from_numpy(slaney_mel_filters(cfg).T.astype(np.float32))
    return window.to(device), mel.to(device)


def whisper_log_mel(wav: torch.Tensor,
                    cfg: WhisperFrontendConfig = WhisperFrontendConfig()
                    ) -> torch.Tensor:
    """Waveforms [B, S] (zeros past each one's end) -> Whisper's log-mel
    [B, window_frames, num_mel_bins] of each one's 30 s window (the
    module docstring's steps; the maximum is each row's own)."""
    window, mel = _whisper_constants(cfg, wav.device)
    n = cfg.window_samples
    x = wav.float()[..., :n]
    x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    spec = torch.stft(x, cfg.fft_size, cfg.frame_shift, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = torch.view_as_real(spec[..., :-1]).square().sum(-1)
    with _full_fp32_matmul():
        melspec = mel @ power                          # [B, n_mels, T]
    log_spec = torch.clamp(melspec, min=cfg.log_floor).log10()
    top = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, top - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(-1, -2).to(cfg.dtype)


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


@functools.lru_cache(maxsize=8)
def _pitch_constants(cfg: FrontendConfig):
    """(min_lag, max_lag, frame DFT cos/sin [n, K], segment DFT cos/sin
    [seg, K], inverse cos/sin [K, max_lag + 2]) as float32 numpy, built
    in float64 as the reference builds them. The correlation r[l] =
    sum_i x[i] x[i + l] at every lag comes from the DFT of the n-sample
    frame, the DFT of the (n + max_lag + 2)-sample segment and an
    inverse projection onto the lags 0 .. max_lag + 1."""
    min_lag = max(2, int(cfg.sample_rate / cfg.pitch_max_f0))
    max_lag = int(math.ceil(cfg.sample_rate / cfg.pitch_min_f0))
    n = cfg.frame_length
    seg = n + max_lag + 2          # +2: parabolic neighbour at max_lag + 1
    k = seg // 2 + 1
    i = np.arange(seg, dtype=np.float64)
    kk = np.arange(k, dtype=np.float64)
    ang = 2.0 * math.pi * i[:, None] * kk[None, :] / seg
    cos_b, sin_b = np.cos(ang), np.sin(ang)
    # real-part weights of the inverse: 1 for bin 0 (and the Nyquist bin
    # of an even seg), else 2
    w = np.full(k, 2.0)
    w[0] = 1.0
    if seg % 2 == 0:
        w[-1] = 1.0
    lags = np.arange(max_lag + 2, dtype=np.float64)
    lang = 2.0 * math.pi * lags[:, None] * kk[None, :] / seg
    inv_cos = (np.cos(lang) * w[None, :] / seg).T   # [K, n_lags]
    inv_sin = (np.sin(lang) * w[None, :] / seg).T
    f32 = np.float32
    return (min_lag, max_lag,
            cos_b[:n].astype(f32), sin_b[:n].astype(f32),
            cos_b.astype(f32), sin_b.astype(f32),
            inv_cos.astype(f32), inv_sin.astype(f32))


@functools.lru_cache(maxsize=8)
def _pitch_device_constants(cfg: FrontendConfig, device: torch.device):
    """_pitch_constants' six bases as tensors on `device`, copied once."""
    return tuple(torch.from_numpy(c).to(device)
                 for c in _pitch_constants(cfg)[2:])


def _viterbi_lags(band: torch.Tensor, min_lag: int, max_lag: int,
                  weight: float) -> torch.Tensor:
    """Smoothed lag track over band [..., T, L] (the NCCF at lags min_lag
    .. max_lag): the path maximizing sum_t band[t, lag_t] - weight *
    sum_t (log lag_t - log lag_{t-1})^2, by a max-product pass over the
    frames (a [..., L, L] max a frame; ties to the first, lower lag, as
    jnp.argmax) and a backtrace. Runs over every frame of the padded T,
    as the reference's scan does. The backpointers stay on band's device
    and the backtrace runs there: no host copy. -> lags [..., T]."""
    lags = np.arange(min_lag, max_lag + 1, dtype=np.float64)
    ll = np.log(lags)
    trans = torch.from_numpy((-weight * (ll[:, None] - ll[None, :]) ** 2)
                             .astype(np.float32)).to(band.device)
    t = band.shape[-2]
    carry = band[..., 0, :]
    bptrs = torch.empty((t - 1, *carry.shape), dtype=torch.long,
                        device=band.device)
    for i in range(1, t):
        best, _ = torch.max(carry[..., :, None] + trans, dim=-2,
                            out=(torch.empty_like(carry), bptrs[i - 1]))
        carry = best + band[..., i, :]
    state = torch.argmax(carry, dim=-1)
    path = torch.empty((*carry.shape[:-1], t), dtype=torch.long,
                       device=band.device)
    path[..., t - 1] = state
    for i in range(t - 2, -1, -1):
        state = bptrs[i].gather(-1, state[..., None])[..., 0]
        path[..., i] = state
    return path + min_lag


def pitch_track(wav: torch.Tensor, cfg: FrontendConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., S] waveform -> (nccf [..., T, max_lag + 2], the picked
    integer lags [..., T]): the part of pitch_features whose decisions
    (the lag picks) a rounding can flip."""
    fcos, fsin, scos, ssin, icos, isin = _pitch_device_constants(
        cfg, wav.device)
    min_lag, max_lag = _pitch_constants(cfg)[:2]
    n, shift = cfg.frame_length, cfg.frame_shift
    seg_len = scos.shape[0]
    s = wav.shape[-1]
    t = cfg.num_frames(s)
    if t == 0:
        return (wav.new_zeros((*wav.shape[:-1], 0, max_lag + 2)),
                torch.zeros(wav.shape[:-1] + (0,), dtype=torch.long,
                            device=wav.device))
    # the segment of each frame (n + max_lag + 2 samples) as a view of the
    # wave padded past its end; the part past the signal is zeroed below,
    # so it equals the reference's edge-clamped gather after the masking
    padded = torch.nn.functional.pad(wav.float(), (0, seg_len - n))
    seg = padded.unfold(-1, seg_len, shift)[..., :t, :]
    seg = seg - seg[..., :n].mean(dim=-1, keepdim=True)
    # zero (do not edge-repeat) the tail past the signal: a constant tail
    # fakes long-lag periodicity on the last frames
    raw = np.arange(t)[:, None] * shift + np.arange(seg_len)[None, :]
    seg = seg * torch.from_numpy((raw < s).astype(np.float32)).to(
        wav.device)
    frame = seg[..., :n]
    with _full_fp32_matmul():
        a_re, a_im = frame @ fcos, frame @ fsin
        b_re, b_im = seg @ scos, seg @ ssin
        # conj(A) B (both bases positive-angle), then the inverse DFT's
        # real part at the lags 0 .. max_lag + 1
        c_re = a_re * b_re + a_im * b_im
        c_im = a_re * b_im - a_im * b_re
        r = c_re @ icos + c_im @ isin
    # the energy of every lag-shifted window, from a cumsum of squares
    csum = torch.cumsum(seg * seg, dim=-1)
    n_lags = max_lag + 2
    ends = torch.arange(n_lags, device=wav.device) + n - 1
    lo = torch.clamp(torch.arange(n_lags, device=wav.device) - 1, min=0)
    e2 = csum[..., ends] - torch.where(
        torch.arange(n_lags, device=wav.device) == 0, 0.0, csum[..., lo])
    e1 = e2[..., :1]
    nccf = r / (torch.sqrt(torch.clamp(e1 * e2, min=0.0)) + 1e-4 * n)
    band = nccf[..., min_lag:max_lag + 1]
    if cfg.pitch_smooth_weight > 0.0:
        best = _viterbi_lags(band, min_lag, max_lag, cfg.pitch_smooth_weight)
    else:
        # a periodic signal scores about equally at every multiple of its
        # period: take the SHORTEST lag within 0.025 of the peak (argmax
        # of a 0/1 tensor: the first, as jnp.argmax of the bool)
        peak = band.max(dim=-1, keepdim=True).values
        best = torch.argmax((band >= peak - 0.025).to(torch.uint8),
                            dim=-1) + min_lag
    return nccf, best


def pitch_features(wav: torch.Tensor, frame_lengths: torch.Tensor | None,
                   cfg: FrontendConfig) -> torch.Tensor:
    """[..., S] waveform -> [..., T, 3] pitch features: POV, normalized
    log-pitch and delta-pitch, the dims Kaldi's
    compute-and-process-kaldi-pitch-feats pastes onto the fbank
    (pitch_track, then pitch_from_track). Offline: the normalization
    reads the whole utterance."""
    nccf, best = pitch_track(wav, cfg)
    return pitch_from_track(nccf, best, frame_lengths, cfg)


def pitch_from_track(nccf: torch.Tensor, best: torch.Tensor,
                     frame_lengths: torch.Tensor | None,
                     cfg: FrontendConfig) -> torch.Tensor:
    """pitch_track's (nccf, lags) -> [..., T, 3] features, as the
    reference: the lag refined parabolically, POV = the NCCF there
    clipped to [0, 1], the log-pitch less its utterance-level
    POV^2-weighted mean over the valid frames, delta a central
    difference; frames past frame_lengths are 0."""
    t = nccf.shape[-2]
    y0 = nccf.gather(-1, best[..., None])[..., 0]
    ym = nccf.gather(-1, best[..., None] - 1)[..., 0]
    yp = nccf.gather(-1, best[..., None] + 1)[..., 0]
    denom = ym - 2.0 * y0 + yp
    off = torch.where(denom.abs() > 1e-12, 0.5 * (ym - yp) / denom, 0.0)
    off = torch.clamp(off, -0.5, 0.5)
    lag = best.float() + off
    pov = torch.clamp(y0, 0.0, 1.0)
    log_f0 = torch.log(cfg.sample_rate / lag)
    if frame_lengths is not None:
        valid = (torch.arange(t, device=nccf.device)
                 < frame_lengths[..., None]).float()
    else:
        valid = torch.ones_like(log_f0)
    w = pov * pov * valid + 1e-8
    mean_lp = ((w * log_f0).sum(dim=-1, keepdim=True)
               / w.sum(dim=-1, keepdim=True))
    norm_lp = (log_f0 - mean_lp) * valid
    nxt = torch.cat([log_f0[..., 1:], log_f0[..., -1:]], dim=-1)
    prv = torch.cat([log_f0[..., :1], log_f0[..., :-1]], dim=-1)
    delta = 0.5 * (nxt - prv) * valid
    return torch.stack([pov * valid, norm_lp, delta], dim=-1).to(cfg.dtype)


def build_lfr_features(feats: torch.Tensor, m: int = 4, n: int = 3
                       ) -> torch.Tensor:
    """Low frame rate: stack m consecutive frames, keep every n-th.
    [..., T, D] -> [..., ceil(T / n), m * D]. Frames past the end repeat
    frame T - 1 of the PADDED batch, as the reference's: in a padded
    batch a short row's last stacks take its zero padding, not copies of
    its own last frame."""
    t = feats.shape[-2]
    t_out = (t + n - 1) // n
    idx = np.minimum(np.arange(t_out)[:, None] * n + np.arange(m)[None, :],
                     t - 1)
    stacked = feats[..., torch.from_numpy(idx).to(feats.device), :]
    return stacked.reshape(*stacked.shape[:-2], m * feats.shape[-1])


def lfr_length(t, n: int = 3):
    """Valid frames after LFR subsampling by n (an int or a tensor)."""
    return (t + n - 1) // n


def feature_fingerprint(cfg: FrontendConfig) -> str:
    """Canonical string of every FrontendConfig field that changes the
    feature space, stored in CMVN-stats .npz files so that stats of one
    frontend cannot normalize the features of another. Character for
    character the reference's, so a stats file written by either package
    loads in the other."""
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


def cmvn_stats_for(cfg: FrontendConfig | WhisperFrontendConfig,
                   device: torch.device | str
                   ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """global_cmvn_tensors under cmvn_mode "global", else None (also
    for a WhisperFrontendConfig, which has no CMVN)."""
    return (global_cmvn_tensors(cfg, device)
            if isinstance(cfg, FrontendConfig) and cfg.cmvn_mode == "global"
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


def frame_lengths_of(wav_lengths: torch.Tensor,
                     cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Valid frames of each waveform (0 below one frame's length)."""
    num = 1 + torch.clamp(wav_lengths - cfg.frame_length, min=0) \
        // cfg.frame_shift
    return torch.where(wav_lengths < cfg.frame_length,
                       torch.zeros_like(num), num)


def wav_to_features(wav: torch.Tensor, wav_lengths: torch.Tensor,
                    cfg: FrontendConfig | WhisperFrontendConfig
                    = FrontendConfig(),
                    apply_cmvn: bool = True,
                    cmvn_stats: tuple[torch.Tensor, torch.Tensor] | None
                    = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded waveforms [B, S] + lengths [B] -> (feats [B, T, D],
    frame_lengths [B]); D = cfg.feature_dim (83 with add_pitch). Frames
    past frame_lengths[b] are zeroed.
    `cmvn_stats`: global CMVN's (mean, istd) on the device
    (cmvn_stats_for), else read from cfg's stats file at each call.
    A WhisperFrontendConfig gives whisper_log_mel's whole window
    (window_frames frames, none zeroed) and the frames that carry speech
    (samples // hop, at most the window's)."""
    if isinstance(cfg, WhisperFrontendConfig):
        return whisper_log_mel(wav, cfg), torch.clamp(
            wav_lengths // cfg.frame_shift, max=cfg.window_frames)
    feats = log_mel_spectrogram(wav, cfg)
    frame_lengths = frame_lengths_of(wav_lengths, cfg)
    if cfg.add_pitch:
        # Kaldi paste-feats order: the fbank, then the 3 pitch dims; CMVN
        # below normalizes the pasted feature as apply-cmvn does
        feats = torch.cat([feats, pitch_features(wav, frame_lengths, cfg)],
                          dim=-1)
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
