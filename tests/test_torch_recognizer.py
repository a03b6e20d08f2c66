"""Port Recognizer vs tpu_asr.decode.recognizer.Recognizer on the CPU:
the same flax params and the same wav batch give the same tokens, with
scores within 1e-4. And the beam's static step, which the card replays
as a CUDA graph: its state keeps its storage and its position stays on
the device."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr_torch.decode.beam import (BeamConfig, BeamSearch,
                                       attention_beam_search)
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.lm import TransformerLM
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_cfg, cif_torch_model, flax_params,
                             jax_cfg, lm_pair, torch_cfg, torch_model,
                             wav_batch)

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


# ---- the beam's static step (what the card captures and replays) ----

def _state(search: BeamSearch) -> dict:
    """Every tensor of the search that a step reads or writes."""
    out = {k: getattr(search, k) for k in (
        "pos", "y_prev", "scores", "finished", "lengths", "tokens", "done",
        "enc_lengths", "utt_maxlen", "utt_minlen")}
    for prefix, cache in (("cache", search.cache), ("cross", search.cross_kv),
                          ("lm", search.lm_cache or {})):
        out.update({f"{prefix}_{k}": x for k, x in cache.items()})
    if search.scorer is not None:
        out.update(ctc_r=search.ctc_r, ctc_psi=search.ctc_psi,
                   ctc_logp=search.ctc_logp, x_blank=search.scorer.x_blank)
    return out


@pytest.mark.parametrize("branch,kw", [
    ("joint one-pass", dict(ctc_weight=0.3, ctc_two_pass=False)),
    ("joint two-pass", dict(ctc_weight=0.3, ctc_two_pass=True)),
    ("beam", dict()),
    ("LM-fused joint", dict(ctc_weight=0.3, lm_weight=0.4))])
def test_beam_step_keeps_its_storage_and_its_position_on_the_device(
        branch, kw, monkeypatch):
    """Across every step of one search each state tensor keeps its
    storage, the position reaches the decoder (and the LM) as a device
    tensor and never as a Python int, and the result is in new tensors:
    what lets the card replay one captured step for all of them."""
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.standard_normal((3, 14, 64)).astype(
        np.float32))
    lens = torch.tensor([14, 9, 5])
    lg = torch.from_numpy((2.0 * rng.standard_normal((3, 14, VOCAB))).astype(
        np.float32))
    seen, positions = [], []
    step = BeamSearch.step

    def spy(search):
        before = {k: x.data_ptr() for k, x in _state(search).items()}
        step(search)
        seen.append((before, {k: x.data_ptr()
                              for k, x in _state(search).items()}))

    def device_step(real):
        def at(self, y_prev, pos, *a, **kw):
            positions.append(pos)
            return real(self, y_prev, pos, *a, **kw)
        return at
    monkeypatch.setattr(BeamSearch, "step", spy)
    monkeypatch.setattr(Decoder, "step_at", device_step(Decoder.step_at))
    monkeypatch.setattr(TransformerLM, "step_at",
                        device_step(TransformerLM.step_at))
    lm = lm_pair()[2] if "lm_weight" in kw else None
    with torch.no_grad():
        out = attention_beam_search(
            torch_model().decoder, enc, lens, VOCAB - 2, VOCAB - 1,
            BeamConfig(beam=3, max_len=8, **kw),
            ctc_logp=torch.log_softmax(lg, -1), lm=lm)
    steps = out["steps"]
    assert steps > 2 and len(seen) == steps and out["graph_steps"] == 0
    first = seen[0][0]
    assert all(a == first and b == first for a, b in seen), branch
    assert len(positions) == steps * (2 if lm is not None else 1)
    assert all(isinstance(p, torch.Tensor) and p.device == enc.device
               and p.dtype == torch.long for p in positions)
    assert not {out[k].data_ptr() for k in ("tokens", "scores", "lengths")} \
        & set(first.values())
