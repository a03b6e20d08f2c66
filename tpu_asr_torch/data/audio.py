"""WAV file reading (PCM) without external tools (copy of
tpu_asr/data/audio.py).

The reference's recipe shells out to Kaldi/sox for audio IO; here a small
stdlib `wave` + numpy reader covers AISHELL-1 (16 kHz 16-bit mono PCM).
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str, expected_rate: int | None = 16000) -> np.ndarray:
    """Returns float32 mono samples in [-1, 1]."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        if expected_rate is not None and rate != expected_rate:
            raise ValueError(f"{path}: sample rate {rate} != {expected_rate}")
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        channels = w.getnchannels()
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x


def wav_num_samples(path: str) -> int:
    with wave.open(path, "rb") as w:
        return w.getnframes()
