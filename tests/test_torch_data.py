"""Port data pipeline (tpu_asr_torch.data) vs tpu_asr.data: the same
synthetic corpus, bucket boundaries, batch plans and padded batches
(exactly equal: both are numpy on the same inputs)."""

import numpy as np
import pytest

from tpu_asr.data import DataLoader as JaxLoader
from tpu_asr.data import make_buckets as jax_make_buckets
from tpu_asr.data import plan_batches as jax_plan_batches
from tpu_asr.data.synthetic import make_synthetic_dataset as jax_synthetic
from tpu_asr_torch.data import (DataLoader, Utterance, load_manifest,
                                make_buckets, plan_batches, save_manifest)
from tpu_asr_torch.data.synthetic import make_synthetic_dataset


@pytest.fixture(scope="module")
def corpus():
    kw = dict(min_tokens=2, max_tokens=12, tone_ms=60, seed=3)
    utts, waves = make_synthetic_dataset(40, 32, **kw)
    j_utts, j_waves = jax_synthetic(40, 32, **kw)
    return utts, waves, j_utts, j_waves


def test_synthetic_corpus_is_the_reference_one(corpus):
    utts, waves, j_utts, j_waves = corpus
    assert [u.tokens for u in utts] == [u.tokens for u in j_utts]
    assert [u.num_samples for u in utts] == [u.num_samples for u in j_utts]
    for u in utts:
        np.testing.assert_array_equal(waves[u.id], j_waves[u.id])


@pytest.mark.parametrize("kw", [
    dict(num_buckets=3, batch_frames=96000),
    dict(num_buckets=2, batch_frames=50000, batch_multiple=2),
    dict(num_buckets=4, batch_size=5),
])
def test_buckets_and_plans_match(corpus, kw):
    utts, _, j_utts, _ = corpus
    kw = dict(kw, length_key="num_samples", max_frames_cap=480000)
    got = make_buckets(utts, **kw)
    want = jax_make_buckets(j_utts, **kw)
    assert [tuple(vars(b).values()) for b in got] == \
        [tuple(vars(b).values()) for b in want]
    for shuffle in (False, True):
        assert plan_batches(utts, got, shuffle=shuffle, seed=5,
                            length_key="num_samples") == jax_plan_batches(
            j_utts, want, shuffle=shuffle, seed=5, length_key="num_samples")


def test_batches_match_reference_loader(corpus):
    utts, waves, j_utts, j_waves = corpus
    buckets = make_buckets(utts, num_buckets=3, batch_frames=96000,
                           length_key="num_samples", max_frames_cap=480000)
    j_buckets = jax_make_buckets(j_utts, num_buckets=3, batch_frames=96000,
                                 length_key="num_samples",
                                 max_frames_cap=480000)
    got = list(DataLoader(utts, buckets, mode="wav", waves=waves, seed=1))
    want = list(JaxLoader(j_utts, j_buckets, mode="wav", waves=j_waves,
                          seed=1))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["ids"] == w["ids"]
        for k in ("wav", "wav_lengths", "targets", "target_lengths"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_feature_mode_npy_and_manifest_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    utts = []
    for i, n in enumerate((50, 31, 77)):
        path = str(tmp_path / f"f{i}.npy")
        np.save(path, rng.standard_normal((n, 80)).astype(np.float32))
        utts.append(Utterance(id=f"u{i}", tokens=[2, 3, 4][: i + 1],
                              feat=path, num_frames=n))
    save_manifest(utts, str(tmp_path / "m.jsonl"))
    loaded = load_manifest(str(tmp_path / "m.jsonl"))
    assert loaded == utts
    buckets = make_buckets(loaded, num_buckets=1, batch_size=4)
    (batch,) = list(DataLoader(loaded, buckets, mode="feat", shuffle=False))
    assert batch["feats"].shape == (3, 96, 80)     # 77 -> bucket of 96
    np.testing.assert_array_equal(batch["feat_lengths"], [31, 50, 77])
    np.testing.assert_array_equal(batch["feats"][0, :31],
                                  np.load(loaded[1].feat))
    assert not batch["feats"][0, 31:].any()


def test_ark_features_are_refused(tmp_path):
    """Kaldi ark features are read (tests/test_torch_kaldi_io.py); a
    compressed ark record is refused, as the reference refuses it."""
    ark = tmp_path / "feats.ark"
    ark.write_bytes(b"a \x00BCM \x04\x0a\x00\x00\x00")
    u = Utterance(id="a", tokens=[2], feat=f"{ark}:2", num_frames=10)
    loader = DataLoader([u], make_buckets([u], num_buckets=1), mode="feat")
    with pytest.raises(ValueError, match="compressed"):
        list(loader)
