"""The one generator of the benchmark's traffic: every mix is a JSON file
of parameters under benchmark/traffic/, and everything drawn comes from
the run's seed (numpy for lengths and tokens, a generator of the device
for the features).

Utterance lengths follow an AISHELL-1-like draw: lognormal around
`median` frames of 10 ms with sigma `sigma`, clipped to [min, max] (a
copy of chip_smoke.request_lengths). The lengths are drawn once from the
mix's `length_seed` and only their order from the run's seed, so every
seed carries the same work in another order. Each utterance carries one token
per `ms_per_token` of audio, ids uniform over [2, vocab - 2) (0 blank,
1 unk, the last two sos and eos).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FRAME_MS = 10


@dataclasses.dataclass
class Corpus:
    ids: list[str]
    frames: np.ndarray          # [N] feature frames
    tokens: list[np.ndarray]    # N int arrays
    feats: dict                 # id -> [frames, D] float32 (host)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of the run's seed, one stream per use."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def draw_frames(n: int, spec: dict, rng: np.random.Generator) -> np.ndarray:
    f = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    return np.clip(f, spec["min"], spec["max"]).astype(np.int64)


def draw_tokens(frames: np.ndarray, ms_per_token: int, vocab: int,
                rng: np.random.Generator) -> list[np.ndarray]:
    counts = np.maximum(frames * FRAME_MS // ms_per_token, 1)
    return [rng.integers(2, vocab - 2, int(c)).astype(np.int32)
            for c in counts]


def make_train_corpus(mix: dict, vocab: int, seed: int, device) -> Corpus:
    """The training mix's corpus: `utterances` of `feat_dim`-dim features
    (unit normal, as after per-utterance CMVN), drawn on the device in one
    call and held on the host."""
    rng = rng_for(seed, 1)
    n = mix["utterances"]
    frames = rng.permutation(draw_frames(n, mix["frames"], rng_for(
        mix["length_seed"], 1)))
    tokens = draw_tokens(frames, mix["ms_per_token"], vocab, rng)
    gen = torch.Generator(device=device).manual_seed(
        (seed * 2 + 1) % 2 ** 63)
    flat = torch.randn((int(frames.sum()), mix["feat_dim"]), generator=gen,
                       device=device).cpu().numpy()
    ids = [f"utt{i:05d}" for i in range(n)]
    parts = np.split(flat, np.cumsum(frames)[:-1])
    return Corpus(ids, frames, tokens, dict(zip(ids, parts)))


def pad_batch(corpus: Corpus, ids: list[str], rows: int, t_pad: int,
              u_pad: int) -> dict:
    """The utterances `ids` as a padded batch of `rows` rows (the rest
    length-0 rows) at [rows, t_pad] frames and [rows, u_pad] targets
    (-1 padded), as torch tensors on the host."""
    d = next(iter(corpus.feats.values())).shape[1]
    feats = np.zeros((rows, t_pad, d), np.float32)
    flens = np.zeros(rows, np.int64)
    targets = np.full((rows, u_pad), -1, np.int64)
    tlens = np.zeros(rows, np.int64)
    at = {u: i for i, u in enumerate(corpus.ids)}
    for r, u in enumerate(ids):
        x = corpus.feats[u]
        tok = corpus.tokens[at[u]]
        feats[r, :len(x)] = x
        flens[r] = len(x)
        targets[r, :len(tok)] = tok
        tlens[r] = len(tok)
    return {"feats": torch.from_numpy(feats),
            "feat_lengths": torch.from_numpy(flens),
            "targets": torch.from_numpy(targets),
            "target_lengths": torch.from_numpy(tlens)}


@dataclasses.dataclass
class Requests:
    wavs: list[np.ndarray]      # float32 samples at 16 kHz
    samples: np.ndarray         # [N]

    def audio_s(self, i: int) -> float:
        return float(self.samples[i]) / SAMPLE_RATE


SAMPLE_RATE = 16000


def make_requests(mix: dict, seed: int, device) -> Requests:
    """The serving mix's pool of `requests` waveforms: lengths drawn as
    the corpus's (frames of 10 ms), each a tone of a random pitch in
    100-300 Hz (amplitude 0.3) under white noise (0.05), drawn on the
    device in one call and held on the host."""
    rng = rng_for(seed, 2)
    n = mix["requests"]
    samples = rng.permutation(draw_frames(n, mix["frames"], rng_for(
        mix["length_seed"], 2))) * (SAMPLE_RATE // 100)
    f0 = torch.from_numpy(rng.uniform(100.0, 300.0, n)).to(device)
    lens = torch.from_numpy(samples).to(device)
    gen = torch.Generator(device=device).manual_seed((seed * 2 + 3) % 2 ** 63)
    total = int(samples.sum())
    noise = torch.randn(total, generator=gen, device=device)
    starts = torch.cumsum(lens, 0) - lens
    idx = torch.arange(total, device=device)
    which = torch.repeat_interleave(torch.arange(n, device=device), lens)
    t = (idx - starts[which]).double() / SAMPLE_RATE
    wav = (0.3 * torch.sin(2 * np.pi * f0[which] * t) + 0.05 * noise.double())
    flat = wav.float().cpu().numpy()
    return Requests(np.split(flat, np.cumsum(samples)[:-1]), samples)
