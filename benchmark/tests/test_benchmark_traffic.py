"""The traffic is drawn the same from a seed and differently from
another; the weights likewise."""

import numpy as np
import torch

from benchmark import traffic
from benchmark.weights import make_weights

MIX = {"utterances": 12, "length_seed": 0,
       "frames": {"median": 430, "sigma": 0.35, "min": 250, "max": 1000},
       "ms_per_token": 320, "feat_dim": 8, "requests": 6}
BIG = 2 ** 31 + 12345


def test_corpus_same_seed_same_draw():
    a = traffic.make_train_corpus(MIX, 4233, BIG, "cpu")
    b = traffic.make_train_corpus(MIX, 4233, BIG, "cpu")
    assert a.ids == b.ids and np.array_equal(a.frames, b.frames)
    for u in a.ids:
        assert np.array_equal(a.feats[u], b.feats[u])
    for x, y in zip(a.tokens, b.tokens):
        assert np.array_equal(x, y)


def test_corpus_other_seed_other_draw_of_the_same_lengths():
    a = traffic.make_train_corpus(MIX, 4233, BIG, "cpu")
    b = traffic.make_train_corpus(MIX, 4233, BIG + 1, "cpu")
    assert not np.array_equal(a.frames, b.frames)
    assert np.array_equal(np.sort(a.frames), np.sort(b.frames))
    assert not np.array_equal(a.feats[a.ids[0]][:10], b.feats[b.ids[0]][:10])


def test_corpus_ranges():
    c = traffic.make_train_corpus(MIX, 4233, 3, "cpu")
    assert c.frames.min() >= 250 and c.frames.max() <= 1000
    for f, t, u in zip(c.frames, c.tokens, c.ids):
        assert len(t) == max(f * 10 // 320, 1)
        assert t.min() >= 2 and t.max() < 4231
        assert c.feats[u].shape == (f, 8)


def test_pad_batch_puts_each_utterance_in_its_row():
    c = traffic.make_train_corpus(MIX, 4233, 5, "cpu")
    ids = c.ids[:3]
    b = traffic.pad_batch(c, ids, rows=5, t_pad=1024, u_pad=40)
    assert b["feats"].shape == (5, 1024, 8)
    for r, u in enumerate(ids):
        n = c.feats[u].shape[0]
        assert np.array_equal(b["feats"][r, :n].numpy(), c.feats[u])
        assert float(b["feats"][r, n:].abs().sum()) == 0.0
    assert b["feat_lengths"][3:].tolist() == [0, 0]
    assert (b["targets"][3:] == -1).all()


def test_requests_same_seed_same_waves():
    a = traffic.make_requests(MIX, BIG, "cpu")
    b = traffic.make_requests(MIX, BIG, "cpu")
    c = traffic.make_requests(MIX, BIG + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.wavs, b.wavs))
    assert not np.array_equal(a.samples, c.samples)
    assert np.array_equal(np.sort(a.samples), np.sort(c.samples))
    assert all(len(w) == n for w, n in zip(a.wavs, a.samples))
    assert a.samples.min() >= 250 * 160


def test_weights_from_the_seed():
    spec = [("a.weight", (3, 4), "fan_in"), ("a.bias", (3,), "zeros"),
            ("n.weight", (4,), "ones"), ("e.weight", (5, 4), "embed")]
    w1 = make_weights(spec, BIG, "cpu", 4)
    w2 = make_weights(spec, BIG, "cpu", 4)
    w3 = make_weights(spec, BIG + 1, "cpu", 4)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.weight"], w3["a.weight"])
    assert float(w1["a.bias"].abs().sum()) == 0.0
    assert torch.equal(w1["n.weight"], torch.ones(4))


def test_training_loader_opens_with_the_longest_bucket():
    """Every seed's first batch comes from the longest bucket, so the
    checked first gradient is taken at one size; the rest of the order
    still differs by seed."""
    from benchmark.drivers.train import longest_first_seed
    from tpu_asr_torch.data.bucketing import make_buckets, plan_batches
    from tpu_asr_torch.data.loader import DataLoader
    from tpu_asr_torch.data.manifest import Utterance
    mix = dict(MIX, utterances=300, feat_dim=1)
    orders, moved = set(), 0
    for seed in range(BIG, BIG + 8):
        c = traffic.make_train_corpus(mix, 4233, seed, "cpu")
        utts = [Utterance(id=u, tokens=t.tolist(), num_frames=int(f))
                for u, t, f in zip(c.ids, c.tokens, c.frames)]
        buckets = make_buckets(utts, num_buckets=4, batch_frames=12800,
                               max_frames_cap=3000, max_tokens_cap=200)
        loader = DataLoader(utts, buckets, mode="feat", feats=c.feats,
                            seed=seed % 2 ** 32)
        s = longest_first_seed(loader)
        moved += s != loader.seed
        plan = plan_batches(utts, buckets, seed=s)
        longest = max(range(len(buckets)),
                      key=lambda i: buckets[i].max_frames)
        assert plan[0][0] == longest
        orders.add(tuple(bi for bi, _ in plan))
    assert moved and len(orders) > 1
