"""Batched data loader: bucket-padded numpy batches with thread prefetch
(port of tpu_asr/data/loader.py).

The collate pads to the bucket's static shape with numpy (the reference
calls its native C++ helper); feature extraction runs on the device (wav
mode), and one background thread keeps the next batches ready while the
step runs. Inputs are wavs (.wav or .npy) or features (.npy, or a
Kaldi ark record "x.ark:offset" as an espnet data.json names it; read by
data/kaldi_io.py, where the reference calls its native C++ reader).
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from tpu_asr_torch import IGNORE_ID
from tpu_asr_torch.data.bucketing import Bucket, plan_batches
from tpu_asr_torch.data.kaldi_io import read_mat
from tpu_asr_torch.data.manifest import Utterance
from tpu_asr_torch.utils.padding import pad_list


def load_features(path: str) -> np.ndarray:
    """[T, D] features of one utterance: an .npy file, or a Kaldi ark
    matrix ("x.ark:offset" or an ark file holding one record)."""
    return np.load(path) if path.endswith(".npy") else read_mat(path)


class DataLoader:
    def __init__(
        self,
        utts: list[Utterance],
        buckets: list[Bucket],
        mode: str = "wav",                 # wav | feat
        waves: dict | None = None,         # in-memory wavs (tests/bench)
        feats: dict | None = None,         # in-memory features
        shuffle: bool = True,
        sort_by_length: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        epoch: int = 0,
        pad_to_batch_size: bool = True,
    ):
        if mode not in ("wav", "feat"):
            raise ValueError(f"mode must be wav or feat, got {mode!r}")
        self.utts = utts
        self.buckets = buckets
        self.mode = mode
        self.waves = waves or {}
        self.feats = feats or {}
        self.shuffle = shuffle
        self.sort_by_length = sort_by_length
        self.drop_last = drop_last
        self.pad_to_batch_size = pad_to_batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = epoch
        self.length_key = "num_samples" if mode == "wav" else "num_frames"

    def load_input(self, u: Utterance) -> np.ndarray:
        if self.mode == "wav":
            if u.id in self.waves:
                return self.waves[u.id]
            if not u.wav:
                raise ValueError(f"no wav for {u.id}")
            if u.wav.endswith(".npy"):
                return np.load(u.wav)
            from tpu_asr_torch.data.audio import read_wav
            return read_wav(u.wav)
        if u.id in self.feats:
            return self.feats[u.id]
        if not u.feat:
            raise ValueError(f"no feat for {u.id}")
        return load_features(u.feat)

    def _make_batch(self, bucket: Bucket, idxs: list[int]) -> dict:
        """Collate one batch, padded to the bucket's STATIC shape.

        A partial final chunk is padded with dummy rows (all-zero input,
        length 0, IGNORE targets) up to bucket.batch_size. The models mask
        rows with feat_lengths == 0 out of every loss; `ids` lists only the
        real utterances."""
        n_real = len(idxs)
        n = bucket.batch_size if self.pad_to_batch_size else n_real
        us = [self.utts[i] for i in idxs]
        targets = np.full((n, bucket.max_tokens), IGNORE_ID, np.int32)
        tlens = np.zeros((n,), np.int32)
        for j, u in enumerate(us):
            targets[j, : len(u.tokens)] = u.tokens
            tlens[j] = len(u.tokens)
        xs = [np.asarray(self.load_input(u), np.float32) for u in us]
        lens = np.zeros((n,), np.int32)
        lens[:n_real] = [x.shape[0] for x in xs]
        padded = pad_list(xs, 0.0, bucket.max_frames)
        if n > n_real:
            pad_rows = np.zeros((n - n_real,) + padded.shape[1:],
                                padded.dtype)
            padded = np.concatenate([padded, pad_rows], axis=0)
        ids = [u.id for u in us]
        if self.mode == "wav":
            return {"wav": padded, "wav_lengths": lens, "targets": targets,
                    "target_lengths": tlens, "ids": ids}
        return {"feats": padded, "feat_lengths": lens, "targets": targets,
                "target_lengths": tlens, "ids": ids}

    def __len__(self):
        return len(plan_batches(self.utts, self.buckets, shuffle=False,
                                sort_by_length=self.sort_by_length,
                                drop_last=self.drop_last,
                                length_key=self.length_key))

    def __iter__(self):
        plan = plan_batches(
            self.utts, self.buckets, shuffle=self.shuffle,
            sort_by_length=self.sort_by_length, drop_last=self.drop_last,
            seed=self.seed + self.epoch, length_key=self.length_key)
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()
        errors: list[BaseException] = []

        def producer():
            try:
                for bi, idxs in plan:
                    if closed.is_set():
                        break
                    q.put(self._make_batch(self.buckets[bi], idxs))
            except Exception as e:          # re-raised on the consumer side
                errors.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (item := q.get()) is not stop:
                yield item
        finally:                 # also when the consumer stops early:
            closed.set()         # drain so a blocked put returns
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if errors:
            raise errors[0]
