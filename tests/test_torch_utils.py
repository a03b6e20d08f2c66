"""Port utils (vocab, CER, results) and the new presets vs tpu_asr: the
same inputs give equal outputs."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_asr import native
from tpu_asr.configs.presets import get_preset as jax_preset
from tpu_asr.utils import results as jax_results
from tpu_asr.utils.cer import cer as jax_corpus_cer
from tpu_asr.utils.cer import edit_distance as jax_edit_distance
from tpu_asr.utils.vocab import Vocab as JaxVocab
from tpu_asr_torch.configs.presets import PORT_ONLY, PRESETS, get_preset
from tpu_asr_torch.utils import results
from tpu_asr_torch.utils.cer import batch_edit_distance, cer, edit_distance
from tpu_asr_torch.utils.vocab import Vocab


def _pairs(n=200, seed=0):
    """Random ref/hyp id sequences (0-14 tokens over 6 ids, so matches,
    ties between moves and empty sides all occur)."""
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 6, rng.integers(0, 15)).tolist()
            for _ in range(n)]
    hyps = [rng.integers(0, 6, rng.integers(0, 15)).tolist()
            for _ in range(n)]
    return refs, hyps


def test_batch_edit_distance_matches_native():
    refs, hyps = _pairs()
    got = batch_edit_distance(refs, hyps)
    assert got.dtype == np.int64 and got.shape == (200, 4)
    np.testing.assert_array_equal(got,
                                  native.batch_edit_distance(refs, hyps))
    for r, h, row in zip(refs[:50], hyps[:50], got):
        d = jax_edit_distance(r, h)
        assert tuple(row) == (d["distance"], d["sub"], d["ins"], d["del"])
        assert edit_distance(r, h) == d


def test_cer_matches_jax():
    refs, hyps = _pairs(seed=1)
    assert cer(refs, hyps) == jax_corpus_cer(refs, hyps)
    words = (["ni", "hao", "ma"], ["ni", "ma"])
    assert cer([words[0]], [words[1]]) == \
        jax_corpus_cer([words[0]], [words[1]])
    assert cer([], [])["cer"] == 0.0
    with pytest.raises(ValueError):
        batch_edit_distance([[1]], [])


@pytest.fixture
def dict_file(tmp_path):
    path = tmp_path / "dict.txt"
    vocab = JaxVocab.build("我们今天天气很好")
    vocab.save(str(path))
    return str(path)


def test_vocab_matches_jax(dict_file, tmp_path):
    v, jv = Vocab.load(dict_file), JaxVocab.load(dict_file)
    assert v.tokens == jv.tokens
    assert (v.blank_id, v.unk_id, v.sos_id, v.eos_id) == \
        (jv.blank_id, jv.unk_id, jv.sos_id, jv.eos_id) == \
        (0, 1, len(v) - 2, len(v) - 1)
    text = "今天天气不好"
    assert v.encode(text) == jv.encode(text)
    ids = v.encode(text) + [v.eos_id, -1, len(v) + 3]
    assert v.decode(ids) == jv.decode(ids)
    assert v.decode(ids, strip_special=False) == \
        jv.decode(ids, strip_special=False)
    assert Vocab.build("天气很好").tokens == JaxVocab.build("天气很好").tokens
    v.save(str(tmp_path / "again.txt"))
    assert open(tmp_path / "again.txt").read() == open(dict_file).read()


def test_results_match_jax(dict_file):
    chars = Vocab.load(dict_file).tokens
    nbest = [{"yseq": [2, 5, 3], "score": -1.5}, {"yseq": [4], "score": -3.0}]
    utt = {"input": [], "output": [{"name": "target1", "text": "x",
                                    "tokenid": "2 5"}]}
    assert results.parse_hypothesis(nbest[0], chars) == \
        jax_results.parse_hypothesis(nbest[0], chars)
    assert results.add_results_to_json(utt, nbest, chars) == \
        jax_results.add_results_to_json(utt, nbest, chars)
    assert results.ids_to_text([2, 5, 1, 9], Vocab.load(dict_file)) == \
        jax_results.ids_to_text([2, 5, 1, 9], JaxVocab.load(dict_file))


def _plain(x):
    """A config as nested dicts, dtypes by name (jnp or torch)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).rsplit(".", 1)[-1]
    if isinstance(x, type):                      # jnp.float32 and the like
        return np.dtype(x).name
    return x


@pytest.mark.parametrize("name", ["ctc_dev", "attention", "hybrid"])
def test_new_presets_match_jax(name):
    assert _plain(get_preset(name)) == _plain(jax_preset(name))


def test_every_port_preset_matches_jax():
    """Every preset equals the reference's, but those of the models the
    reference does not have (PORT_ONLY: Whisper), which it lacks."""
    for name in PRESETS:
        if name in PORT_ONLY:
            with pytest.raises(KeyError):
                jax_preset(name)
        else:
            assert _plain(get_preset(name)) == _plain(jax_preset(name)), name
    assert set(PORT_ONLY) < set(PRESETS)
