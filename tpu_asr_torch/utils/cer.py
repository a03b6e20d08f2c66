"""Host-side character/word error rate scoring (port of
tpu_asr/utils/cer.py and of tpu_asr.native.batch_edit_distance).

Pure-Python Levenshtein over token sequences, with the substitution,
insertion and deletion breakdown; the reference's threaded C scorer is
replaced by the same dynamic program in Python (it is not on a device
path). Ties between equal-cost moves resolve substitution first, then
insertion, then deletion, as both of the reference's scorers do, so the
breakdown is the same.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> dict:
    """Levenshtein distance with substitution/insertion/deletion breakdown."""
    n, m = len(ref), len(hyp)
    # prev[j] = (cost, subs, ins, dels) of aligning ref[:i-1] with hyp[:j]
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
                continue
            sub, ins, dele = prev[j - 1], cur[j - 1], prev[j]
            if sub[0] <= ins[0] and sub[0] <= dele[0]:
                cur[j] = (sub[0] + 1, sub[1] + 1, sub[2], sub[3])
            elif ins[0] <= dele[0]:
                cur[j] = (ins[0] + 1, ins[1], ins[2] + 1, ins[3])
            else:
                cur[j] = (dele[0] + 1, dele[1], dele[2], dele[3] + 1)
        prev = cur
    cost, subs, ins, dels = prev[m]
    return {"distance": cost, "sub": subs, "ins": ins, "del": dels,
            "ref_len": n}


def batch_edit_distance(refs: Sequence[Sequence],
                        hyps: Sequence[Sequence]) -> np.ndarray:
    """[N, 4] int64: (distance, sub, ins, del) per (ref, hyp) pair."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} refs for {len(hyps)} hyps")
    out = np.zeros((len(refs), 4), np.int64)
    for i, (r, h) in enumerate(zip(refs, hyps)):
        d = edit_distance(list(r), list(h))
        out[i] = (d["distance"], d["sub"], d["ins"], d["del"])
    return out


def cer(refs: Sequence[Sequence], hyps: Sequence[Sequence]) -> dict:
    """Corpus-level error rate over parallel ref/hyp token sequences:
    summed distance, sub, ins, del and ref_len, and cer = distance /
    ref_len."""
    per = batch_edit_distance(refs, hyps)
    tot = {key: int(per[:, j].sum())
           for j, key in enumerate(("distance", "sub", "ins", "del"))}
    tot["ref_len"] = sum(len(r) for r in refs)
    tot["cer"] = tot["distance"] / max(tot["ref_len"], 1)
    return tot
