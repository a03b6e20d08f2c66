"""Synthetic learnable ASR dataset (tests, benchmarks, demos; copy of
tpu_asr/data/synthetic.py).

No AISHELL audio ships with this machine, so integration tests and the
benchmark harness use a synthetic task with the same interface: each token
maps to a distinct tone burst, so waveform -> token-sequence is genuinely
learnable end-to-end through the real frontend + model stack.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_asr_torch.data.manifest import Utterance, save_manifest


def token_wave(token: int, num_tokens: int, dur: int, sr: int,
               rng: np.random.Generator) -> np.ndarray:
    """A tone burst whose frequency encodes the token id."""
    f0 = 200.0 + 3000.0 * (token / max(num_tokens, 1))
    t = np.arange(dur) / sr
    env = np.hanning(dur)
    wave = np.sin(2 * np.pi * f0 * t) + 0.3 * np.sin(2 * np.pi * 2 * f0 * t)
    return (env * wave).astype(np.float32)


def markov_transitions(vocab_size: int, text_seed: int = 1234,
                       alpha: float = 0.15) -> np.ndarray:
    """Fixed sparse bigram transition matrix over the usable token range
    [2, vocab_size-2). Seeded independently of the corpus seed so
    train/dev corpora drawn with different seeds share ONE language —
    which is what makes an external LM learnable and shallow fusion
    measurable on held-out data."""
    rng = np.random.default_rng(text_seed)
    n = vocab_size - 4
    trans = rng.dirichlet(np.full(n, alpha), size=n)
    init = rng.dirichlet(np.full(n, alpha))
    return init, trans


def make_synthetic_dataset(
    n_utts: int,
    vocab_size: int,
    min_tokens: int = 3,
    max_tokens: int = 10,
    tone_ms: int = 120,
    sample_rate: int = 16000,
    seed: int = 0,
    noise: float = 0.01,
    text: str = "uniform",
    text_seed: int = 1234,
    out_dir: str | None = None,
):
    """Returns (utterances, waves dict id->float32 wav). Token ids are drawn
    from [2, vocab_size-2) (0=blank, 1=unk, last two sos/eos); with
    text="markov" they follow the fixed bigram language of
    ``markov_transitions(vocab_size, text_seed)``."""
    rng = np.random.default_rng(seed)
    dur = int(tone_ms * sample_rate / 1000)
    if text == "markov":
        init, trans = markov_transitions(vocab_size, text_seed)
    else:
        assert text == "uniform", text
    utts, waves = [], {}
    for i in range(n_utts):
        n = int(rng.integers(min_tokens, max_tokens + 1))
        if text == "markov":
            tok = int(rng.choice(len(init), p=init))
            tokens = [tok + 2]
            for _ in range(n - 1):
                tok = int(rng.choice(len(init), p=trans[tok]))
                tokens.append(tok + 2)
        else:
            tokens = rng.integers(2, vocab_size - 2, n).tolist()
        wav = np.concatenate(
            [token_wave(t, vocab_size, dur, sample_rate, rng)
             for t in tokens])
        wav = wav + noise * rng.standard_normal(len(wav)).astype(np.float32)
        uid = f"synth{i:06d}"
        path = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, uid + ".npy")
            np.save(path, wav)
        utts.append(Utterance(
            id=uid, tokens=tokens, text=" ".join(map(str, tokens)),
            wav=path, num_samples=len(wav)))
        waves[uid] = wav
    return utts, waves


def write_synthetic_manifest(path: str, n_utts: int, vocab_size: int,
                             **kw) -> list[Utterance]:
    out_dir = os.path.join(os.path.dirname(os.path.abspath(path)), "wavs")
    utts, _ = make_synthetic_dataset(n_utts, vocab_size, out_dir=out_dir,
                                     **kw)
    save_manifest(utts, path)
    return utts
