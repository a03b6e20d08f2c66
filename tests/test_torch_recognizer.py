"""Port Recognizer vs tpu_asr.decode.recognizer.Recognizer on the CPU:
the same flax params and the same wav batch give the same tokens, with
scores within 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_cfg, cif_torch_model, flax_params,
                             jax_cfg, torch_cfg, torch_model, wav_batch)

# a short row, a longer row and a length-0 dummy row, padded to 0.6 s
BATCH = wav_batch([9600, 6400, 3000, 0], seed=5)


def _decode_both(mode, use_pallas=False, **beam_kw):
    jrec = JaxRecognizer(cfg=jax_cfg(use_pallas=use_pallas),
                         params=flax_params(), mode=mode,
                         beam=JaxBeam(**beam_kw))
    trec = Recognizer(torch_cfg(use_pallas=use_pallas),
                      torch_model(use_pallas=use_pallas), mode=mode,
                      device="cpu", beam=BeamConfig(**beam_kw))
    return jrec.decode_batch_nbest(BATCH), trec.decode_batch_nbest(BATCH)


def _assert_same(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(w) == len(g)
        for j, (hw, hg) in enumerate(zip(w, g)):
            assert hg["yseq"] == hw["yseq"], (i, j)
            assert abs(hg["score"] - hw["score"]) <= 1e-4, (i, j)


@pytest.mark.parametrize("two_pass", [False, True])
def test_joint_matches_jax(two_pass):
    want, got = _decode_both("joint", beam=3, max_len=8, ctc_weight=0.3,
                             ctc_two_pass=two_pass, nbest=3)
    _assert_same(want, got)
    assert any(h[0]["yseq"] for h in got)


def test_beam_matches_jax():
    want, got = _decode_both("beam", beam=3, max_len=8, nbest=3)
    _assert_same(want, got)


def test_length_control_matches_jax():
    want, got = _decode_both("joint", beam=2, max_len=8, ctc_weight=0.5,
                             maxlenratio=0.5, minlenratio=0.2, nbest=2)
    _assert_same(want, got)


def test_greedy_ctc_matches_jax():
    want, got = _decode_both("greedy_ctc")
    _assert_same(want, got)
    for w, g in zip(want, got):
        assert g[0]["times"] == w[0]["times"]
        np.testing.assert_allclose(g[0]["confidence"], w[0]["confidence"],
                                   atol=1e-4)


def test_feats_input_matches_wav_input():
    from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
    feats, flens = wav_to_features(torch.from_numpy(BATCH["wav"]),
                                   torch.from_numpy(BATCH["wav_lengths"]),
                                   FrontendConfig())
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=6, ctc_weight=0.3))
    assert rec.decode_batch_nbest({"feats": feats.numpy(),
                                   "feat_lengths": flens.numpy()}) == \
        rec.decode_batch_nbest(BATCH)
    assert rec.decode_steps > 0


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["ctc_beam", "attn_rescore"])
def test_nbest_modes_match_jax(mode, use_pallas):
    """The CTC prefix beam n-best, and that n-best rescored by one
    teacher-forced decoder pass, with use_pallas off (attend, LayerNorm)
    and on (flash attention, fused LN) on both sides."""
    want, got = _decode_both(mode, use_pallas=use_pallas, beam=3, max_len=8,
                             ctc_weight=0.3, nbest=3)
    _assert_same(want, got)
    assert any(h[0]["yseq"] for h in got)
    assert got[3][0]["yseq"] == []                    # the length-0 row


def test_cif_greedy_with_use_pallas_matches_jax():
    """The CIF model shares the encoder layers, so use_pallas reaches its
    encoder and its decoder's full passes; its cached steps stay on
    attend."""
    wavs = wav_batch([12000, 9600, 4800, 0], seed=7)
    jrec = JaxRecognizer(cfg=cif_jax_cfg(use_pallas=True),
                         params=cif_flax_params(), mode="cif_greedy",
                         beam=JaxBeam(beam=1, max_len=10))
    trec = Recognizer(cif_torch_cfg(use_pallas=True),
                      cif_torch_model(use_pallas=True), mode="cif_greedy",
                      device="cpu", beam=BeamConfig(beam=1, max_len=10))
    want = jrec.decode_batch_nbest(wavs)
    got = trec.decode_batch_nbest(wavs)
    assert [h[0]["yseq"] for h in got] == [h[0]["yseq"] for h in want]
    assert any(h[0]["yseq"] for h in got)


@pytest.mark.parametrize("mode", ["transducer_greedy", "transducer_beam",
                                  "transducer_rescore"])
def test_transducer_modes_need_a_transducer(mode):
    """The transducer modes raise ValueError on a hybrid model."""
    with pytest.raises(ValueError, match="transducer"):
        Recognizer(torch_cfg(), torch_model(), mode=mode, device="cpu")


def test_mode_needs_matching_heads():
    cfg = dataclasses.replace(torch_cfg(), model_type="transformer")
    from tpu_asr_torch.models.transformer import Transformer
    with pytest.raises(ValueError):
        Recognizer(cfg, Transformer(cfg), mode="joint", device="cpu")
    for mode in ("ctc_beam", "attn_rescore"):
        with pytest.raises(ValueError):
            Recognizer(cfg, Transformer(cfg), mode=mode, device="cpu")
    ctc = dataclasses.replace(torch_cfg(), model_type="ctc")
    with pytest.raises(ValueError):
        Recognizer(ctc, Transformer(ctc), mode="attn_rescore", device="cpu")
    # lm_weight > 0 with no LM decodes as lm_weight 0, as the reference's
    # Recognizer does (its use_lm needs both)
    for mode in ("beam", "ctc_beam", "attn_rescore"):
        beam = dict(beam=2, max_len=6, nbest=2)
        with_weight = Recognizer(torch_cfg(), torch_model(), mode=mode,
                                 device="cpu",
                                 beam=BeamConfig(lm_weight=0.5, **beam))
        assert with_weight.decode_batch_nbest(BATCH) == Recognizer(
            torch_cfg(), torch_model(), mode=mode, device="cpu",
            beam=BeamConfig(**beam)).decode_batch_nbest(BATCH)
    assert VOCAB == torch_cfg().vocab_size
