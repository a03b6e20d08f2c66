"""Length-bucketed, statically-shaped batch planning (copy of
tpu_asr/data/bucketing.py).

Utterances are sorted by input length and grouped against a small fixed
set of (max_frames, max_tokens) buckets chosen from the length histogram;
every batch pads to its bucket's shape, so a step sees a handful of
shapes (the reference needed that for XLA; here it keeps the allocator's
blocks reusable and the step times comparable across batches).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_asr_torch.data.manifest import Utterance


@dataclasses.dataclass(frozen=True)
class Bucket:
    max_frames: int      # padded input length (feature frames or samples)
    max_tokens: int      # padded target length
    batch_size: int      # utterances per batch (static)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_buckets(
    utts: list[Utterance],
    num_buckets: int = 4,
    batch_frames: int = 16000,
    max_frames_cap: int = 3000,
    max_tokens_cap: int = 200,
    frame_multiple: int = 32,
    token_multiple: int = 8,
    min_batch: int = 1,
    batch_multiple: int = 1,
    length_key: str = "num_frames",
    batch_size: int | None = None,
) -> list[Bucket]:
    """Choose bucket boundaries from the length distribution.

    batch_frames is the per-batch input budget (reference --batch_frames);
    each bucket's batch_size = batch_frames // max_frames, so step cost is
    roughly constant across buckets. Passing batch_size instead fixes the
    utterance count per batch across every bucket (reference --batch_size
    mode). Either way batch_size is capped by the bucket's population
    (batches are PADDED to batch_size — see DataLoader) and rounded to
    batch_multiple so batch dims divide the data-parallel mesh axis.
    """
    lens = np.asarray([getattr(u, length_key) for u in utts])
    toks = np.asarray([u.num_tokens for u in utts])
    keep = (lens <= max_frames_cap) & (toks <= max_tokens_cap)
    lens, toks = lens[keep], toks[keep]
    if len(lens) == 0:
        raise ValueError("no utterances within caps")
    qs = np.linspace(0, 100, num_buckets + 1)[1:]
    frame_bounds = sorted({
        _round_up(int(np.percentile(lens, q)), frame_multiple) for q in qs})
    buckets = []
    prev_fb = -1
    for fb in frame_bounds:
        sel = lens <= fb
        tb = _round_up(int(np.percentile(toks[sel], 97)) if sel.any() else
                       max_tokens_cap, token_multiple)
        tb = min(tb, _round_up(max_tokens_cap, token_multiple))
        bs = (batch_size if batch_size is not None
              else max(batch_frames // fb, min_batch))
        population = int(((lens > prev_fb) & sel).sum())
        bs = min(bs, max(population, 1))
        if batch_multiple > 1:
            bs = max(bs // batch_multiple * batch_multiple, batch_multiple)
        buckets.append(Bucket(fb, tb, bs))
        prev_fb = fb
    return buckets


def assign_bucket(u: Utterance, buckets: list[Bucket],
                  length_key: str = "num_frames") -> int | None:
    l, t = getattr(u, length_key), u.num_tokens
    for i, b in enumerate(buckets):
        if l <= b.max_frames and t <= b.max_tokens:
            return i
    return None


def plan_batches(
    utts: list[Utterance],
    buckets: list[Bucket],
    shuffle: bool = True,
    sort_by_length: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    length_key: str = "num_frames",
) -> list[tuple[int, list[int]]]:
    """Group utterance indices into (bucket_idx, [utt_idx...]) batches.

    sort_by_length reproduces the reference's sorted batching (similar
    lengths batch together -> minimal padding waste); shuffle permutes the
    BATCH order each epoch (reference shuffles batches, not utterances).
    """
    per_bucket: dict[int, list[int]] = {i: [] for i in range(len(buckets))}
    for idx, u in enumerate(utts):
        bi = assign_bucket(u, buckets, length_key)
        if bi is not None:
            per_bucket[bi].append(idx)
    batches = []
    for bi, idxs in per_bucket.items():
        if sort_by_length:
            idxs = sorted(idxs, key=lambda i: getattr(utts[i], length_key))
        bs = buckets[bi].batch_size
        for s in range(0, len(idxs), bs):
            chunk = idxs[s: s + bs]
            if drop_last and len(chunk) < bs:
                continue
            batches.append((bi, chunk))
    if shuffle:
        np.random.default_rng(seed).shuffle(batches)
    return batches
