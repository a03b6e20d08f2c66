"""Port external LM (models/lm.py) and its shallow fusion vs tpu_asr on
the CPU: the same flax LM params give the same logits (atol 1e-4); the
cached steps equal the teacher-forced pass (atol 1e-5); the fused beam,
joint beam, CTC prefix beam and attn_rescore give the tokens of
tpu_asr's with scores within 1e-4; the Recognizer with an LM equals
tpu_asr's Recognizer."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.beam import attention_beam_search as jax_beam_search
from tpu_asr.decode.ctc_beam import \
    ctc_prefix_beam_search as jax_ctc_prefix_beam_search
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr.decode.rescore import attention_rescore as jax_attention_rescore
from tpu_asr.models.decoder import Decoder as JaxDecoder
from tpu_asr.models.lm import load_lm_config as jax_load_lm_config
from tpu_asr.models.lm import save_lm_config as jax_save_lm_config
from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
from tpu_asr_torch.decode.ctc_beam import (beam_advance, beam_finalize,
                                           beam_init, ctc_prefix_beam_search)
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.decode.rescore import attention_rescore
from tpu_asr_torch.models.lm import (LMConfig, TransformerLM, load_lm_config,
                                     save_lm_config)
from tpu_asr_torch.weights import init_random
from torch_port_util import (VOCAB, flax_params, jax_cfg, lm_cfgs, lm_pair,
                             torch_cfg, torch_model, wav_batch)

SOS, EOS = VOCAB - 2, VOCAB - 1
LM_VOCAB = 12                     # the module tests' LM (tests/unit/test_lm)
ATOL = 1e-4
BATCH = wav_batch([9600, 6400, 3000, 0], seed=5)


def _tokens(b, u, vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, u)).astype(np.int32)


def _logits(b, t, v, scale, seed):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, t, v))).astype(np.float32)


# ---- the LM module ----

@pytest.mark.parametrize("tie", [True, False])
def test_logits_match_jax(tie):
    jlm, v, lm = lm_pair(LM_VOCAB, tie_embedding=tie)
    ys = _tokens(3, 9, LM_VOCAB, 1)
    want = np.asarray(jlm.apply(v, jnp.asarray(ys)))
    got = lm(torch.from_numpy(ys).long()).detach().numpy()
    assert got.shape == (3, 9, LM_VOCAB)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_step_and_step_at_equal_teacher_forced():
    """The cached step with all rows at one position gives the
    teacher-forced logits at that position."""
    _, _, lm = lm_pair(LM_VOCAB)
    ys = torch.from_numpy(_tokens(4, 8, LM_VOCAB, 2)).long()
    with torch.no_grad():
        full = lm(ys)
        cache = lm.init_cache(4, 8)
        for pos in range(8):
            at, cache = lm.step_at(ys[:, pos], torch.full((4,), pos), cache)
            torch.testing.assert_close(at, full[:, pos], atol=1e-5, rtol=0)


def test_step_at_ragged_positions():
    """Rows at their own positions: row n fed its prefix one token at a
    time, with the other rows held at earlier positions, gives the
    teacher-forced logits of its own sequence."""
    _, _, lm = lm_pair(LM_VOCAB)
    ys = torch.from_numpy(_tokens(3, 6, LM_VOCAB, 3)).long()
    lengths = [6, 2, 4]
    with torch.no_grad():
        full = lm(ys)
        cache = lm.init_cache(3, 6)
        for step in range(6):
            pos = torch.tensor([min(step, n - 1) for n in lengths])
            logits, cache = lm.step_at(ys[torch.arange(3), pos], pos, cache)
            for r in range(3):
                torch.testing.assert_close(logits[r], full[r, pos[r]],
                                           atol=1e-5, rtol=0)


def test_causal():
    """Changing token j leaves the logits of positions < j unchanged."""
    _, _, lm = lm_pair(LM_VOCAB)
    ys = torch.from_numpy(_tokens(2, 7, LM_VOCAB, 4)).long()
    ys2 = ys.clone()
    ys2[:, 4] = (ys2[:, 4] + 1) % LM_VOCAB
    with torch.no_grad():
        a, b = lm(ys), lm(ys2)
    assert torch.equal(a[:, :4], b[:, :4])
    assert not torch.allclose(a[:, 4:], b[:, 4:])


def test_config_round_trip_with_jax(tmp_path):
    cfg = LMConfig(vocab_size=LM_VOCAB, d_model=32, d_inner=64, num_heads=2,
                   num_layers=2, tie_embedding=False,
                   dtype=torch.bfloat16)
    save_lm_config(str(tmp_path / "port"), cfg)
    assert load_lm_config(str(tmp_path / "port")) == cfg
    jc = jax_load_lm_config(str(tmp_path / "port"))
    assert jc.dtype == jnp.bfloat16 and jc.param_dtype == jnp.float32
    assert {k: getattr(jc, k) for k in ("vocab_size", "d_model", "d_inner",
                                        "num_heads", "num_layers", "dropout",
                                        "pe_maxlen", "tie_embedding")} == \
        {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in ("dtype", "param_dtype")}
    jax_save_lm_config(str(tmp_path / "jax"), jc)
    assert load_lm_config(str(tmp_path / "jax")) == cfg
    with open(tmp_path / "jax" / "lm_config.json") as f:
        assert json.load(f)["dtype"] == "bfloat16"


def test_defaults_are_the_references():
    from tpu_asr.models.lm import LMConfig as JaxLMConfig
    jc, c = JaxLMConfig(), LMConfig()
    for f in dataclasses.fields(c):
        if f.name not in ("dtype", "param_dtype"):
            assert getattr(c, f.name) == getattr(jc, f.name), f.name
    assert (c.vocab_size, c.d_model, c.d_inner, c.num_heads,
            c.num_layers) == (4233, 256, 1024, 4, 4)
    assert c.dtype == c.param_dtype == torch.float32


def test_init_random_is_seeded_with_flax_shapes():
    _, v, _ = lm_pair(LM_VOCAB)
    _, cfg = lm_cfgs(LM_VOCAB)
    a = init_random(TransformerLM(cfg), 5).state_dict()
    b = init_random(TransformerLM(cfg), 5).state_dict()
    emb = a["embed.weight"]
    assert emb.shape == v["params"]["embed"]["embedding"].shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(emb.std()) - 32 ** -0.5) < 0.05


# ---- shallow fusion ----

def _enc(b=3, t=14, lens=(14, 9, 5), seed=3):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, 64)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    enc[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    return enc, lens


def _jax_dec():
    params = {"params": flax_params()["params"]["decoder"]}
    return JaxDecoder(jax_cfg()), params


@pytest.mark.parametrize("ctc_weight,beam", [(0.0, 3), (0.0, 1), (0.3, 3)])
def test_fused_beam_matches_jax(ctc_weight, beam):
    """beam (ctc_weight 0) and joint beam with lm_weight 0.4: the LM's
    caches ride the beam reorder beside the decoder's."""
    enc, lens = _enc()
    ctc_logp = None
    if ctc_weight:
        lg = _logits(3, 14, VOCAB, 2.0, 9)
        ctc_logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
    kw = dict(beam=beam, max_len=8, ctc_weight=ctc_weight, lm_weight=0.4)
    jlm, v, lm = lm_pair()
    jdec, dp = _jax_dec()
    want = jax_beam_search(jdec, dp, jnp.asarray(enc), jnp.asarray(lens),
                           SOS, EOS, JaxBeam(**kw),
                           ctc_logp=None if ctc_logp is None
                           else jnp.asarray(ctc_logp), lm=jlm, lm_params=v)
    with torch.no_grad():
        got = attention_beam_search(
            torch_model().decoder, torch.from_numpy(enc),
            torch.from_numpy(lens), SOS, EOS, BeamConfig(**kw),
            ctc_logp=None if ctc_logp is None
            else torch.from_numpy(ctc_logp), lm=lm)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=ATOL)


def _seq_logp(logits, toks, length, with_eos):
    lp = torch.log_softmax(logits.float(), -1)[0]
    tgts = [int(t) for t in toks[:length]] + ([EOS] if with_eos else [])
    return sum(float(lp[i, t]) for i, t in enumerate(tgts))


@pytest.mark.parametrize("beam", [1, 3])
def test_fused_scores_decompose(beam):
    """ctc_weight 0, lm_weight b: each returned score equals the
    teacher-forced attention score + b * the teacher-forced LM score of
    its sequence (eos scored unless the hypothesis hit max_len)."""
    enc, lens = _enc()
    _, _, lm = lm_pair()
    model = torch_model()
    max_len, lw = 8, 0.4
    enc_t, lens_t = torch.from_numpy(enc), torch.from_numpy(lens)
    with torch.no_grad():
        out = attention_beam_search(model.decoder, enc_t, lens_t, SOS, EOS,
                                    BeamConfig(beam=beam, max_len=max_len,
                                               lm_weight=lw), lm=lm)
        for b in range(3):
            for k in range(beam):
                n = int(out["lengths"][b, k])
                toks = out["tokens"][b, k]
                ys_in = torch.cat([torch.tensor([SOS]), toks[:n]])[None]
                eos = n < max_len
                att = _seq_logp(model.decoder(enc_t[b:b + 1],
                                              lens_t[b:b + 1], ys_in),
                                toks, n, eos)
                lm_s = _seq_logp(lm(ys_in), toks, n, eos)
                assert abs(float(out["scores"][b, k])
                           - (att + lw * lm_s)) <= 1e-4 + 1e-3 * abs(att)


@pytest.mark.parametrize("v,beam,topk,max_len,lw", [
    (VOCAB, 4, 4, 6, 0.5),        # a tight cap
    (VOCAB, 5, 8, 20, 0.3),
    (VOCAB, 3, 2, 10, 1.0),
])
def test_fused_prefix_beam_matches_jax(v, beam, topk, max_len, lw):
    """Ragged lengths with a length-0 row: frames past a row's length
    leave its LM state alone."""
    logits = _logits(4, 24, v, 2.0, beam + max_len)
    lens = np.array([24, 13, 0, 6], np.int32)
    jlm, params, lm = lm_pair()
    want = jax_ctc_prefix_beam_search(
        jnp.asarray(logits), jnp.asarray(lens), beam=beam, topk=topk,
        max_len=max_len, lm=jlm, lm_params=params, lm_weight=lw, sos=SOS)
    with torch.no_grad():
        got = ctc_prefix_beam_search(
            torch.from_numpy(logits), torch.from_numpy(lens), beam=beam,
            topk=topk, max_len=max_len, lm=lm, lm_weight=lw, sos=SOS)
    w_toks, w_lens, w_scores = (np.asarray(x) for x in want)
    g_toks, g_lens, g_scores = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_toks, w_toks)
    np.testing.assert_array_equal(g_lens, w_lens)
    np.testing.assert_allclose(np.maximum(g_scores, -1e31),
                               np.maximum(w_scores, -1e31), atol=ATOL)
    plain = ctc_prefix_beam_search(torch.from_numpy(logits),
                                   torch.from_numpy(lens), beam=beam,
                                   topk=topk, max_len=max_len)
    assert not torch.equal(plain[2], got[2])      # the LM did weigh in


def test_fused_prefix_beam_chunked_equals_full():
    logits = torch.from_numpy(_logits(3, 20, VOCAB, 2.0, 5))
    lens = torch.tensor([20, 11, 4])
    _, _, lm = lm_pair()
    logp = torch.log_softmax(logits, -1)
    valid = torch.arange(20)[None, :] < lens[:, None]
    kw = dict(lm=lm, lm_weight=0.5, sos=SOS)
    with torch.no_grad():
        state = beam_init(3, 4, 8, **kw)
        for s in range(0, 20, 6):
            state = beam_advance(state, logp[:, s:s + 6], valid[:, s:s + 6],
                                 topk=4)
        chunked = beam_finalize(state)
        full = ctc_prefix_beam_search(logits, lens, beam=4, max_len=8,
                                      topk=4, **kw)
    for a, b in zip(chunked, full):
        assert torch.equal(a, b)
    assert state[5].lm is lm and state[5].weight == 0.5
    assert beam_init(3, 4, 8, lm=lm, lm_weight=0.0, sos=SOS)[5] is None
    with pytest.raises(ValueError):
        beam_init(3, 4, 8, lm=lm, lm_weight=0.5)       # no sos id


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lm_rescore_matches_jax(use_pallas):
    enc, lens = _enc(3, 14, (14, 9, 0))
    logits = _logits(3, 14, VOCAB, 2.0, 4)
    kw = dict(beam=4, max_len=6, ctc_weight=0.3, lm_weight=0.7)
    jlm, params, lm = lm_pair()
    dp = {"params": flax_params()["params"]["decoder"]}
    want = jax_attention_rescore(
        JaxDecoder(jax_cfg(use_pallas=use_pallas)), dp, jnp.asarray(enc),
        jnp.asarray(lens), jnp.asarray(logits), SOS, EOS, lm=jlm,
        lm_params=params, **kw)
    with torch.no_grad():
        got = attention_rescore(
            torch_model(use_pallas=use_pallas).decoder,
            torch.from_numpy(enc), torch.from_numpy(lens),
            torch.from_numpy(logits), SOS, EOS, lm=lm, **kw)
    for key in ("tokens", "lengths"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for key in ("scores", "att_scores", "ctc_scores"):
        np.testing.assert_allclose(np.maximum(got[key].numpy(), -1e31),
                                   np.maximum(np.asarray(want[key]), -1e31),
                                   atol=ATOL)


# ---- the Recognizer with an LM ----

def _recognizers(mode, use_pallas=False, **beam_kw):
    jlm, params, lm = lm_pair()
    jcfg, tcfg = lm_cfgs()
    jrec = JaxRecognizer(cfg=jax_cfg(use_pallas=use_pallas),
                         params=flax_params(), mode=mode,
                         beam=JaxBeam(**beam_kw), lm_cfg=jcfg,
                         lm_params=params)
    trec = Recognizer(torch_cfg(use_pallas=use_pallas),
                      torch_model(use_pallas=use_pallas), mode=mode,
                      device="cpu", beam=BeamConfig(**beam_kw), lm_cfg=tcfg,
                      lm=lm)
    return jrec, trec


@pytest.mark.parametrize("mode,use_pallas", [
    ("beam", False), ("joint", False), ("ctc_beam", False),
    ("attn_rescore", False), ("attn_rescore", True)])
def test_recognizer_with_lm_matches_jax(mode, use_pallas):
    jrec, trec = _recognizers(mode, use_pallas, beam=3, max_len=8,
                              ctc_weight=0.3 if mode in ("joint",
                                                         "attn_rescore")
                              else 0.0, lm_weight=0.3, nbest=3)
    want = jrec.decode_batch_nbest(BATCH)
    got = trec.decode_batch_nbest(BATCH)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        for hw, hg in zip(w, g):
            assert hg["yseq"] == hw["yseq"]
            assert abs(hg["score"] - hw["score"]) <= ATOL
    assert trec.lm.cfg.dtype == torch.float32


def test_decode_batches_nbest_equals_per_batch():
    _, trec = _recognizers("joint", beam=2, max_len=6, ctc_weight=0.3,
                           lm_weight=0.3, nbest=2)
    batches = [wav_batch(lens, seed=s) for s, lens in enumerate(
        ([9600, 3000], [6400, 6400, 0], [12000], [4000, 8000]))]
    want = [trec.decode_batch_nbest(b) for b in batches]
    for window in (1, 3, 8):
        assert trec.decode_batches_nbest(iter(batches), window=window) == \
            want


def test_lm_validation():
    _, tcfg = lm_cfgs()
    _, _, lm = lm_pair()
    with pytest.raises(ValueError, match="not supported"):
        Recognizer(torch_cfg(), torch_model(), mode="greedy_ctc",
                   device="cpu", beam=BeamConfig(lm_weight=0.3),
                   lm_cfg=tcfg, lm=lm)
    small = dataclasses.replace(tcfg, vocab_size=12)
    with pytest.raises(ValueError, match="vocab"):
        Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                   beam=BeamConfig(lm_weight=0.3), lm_cfg=small,
                   lm=TransformerLM(small))
    with pytest.raises(ValueError, match="together"):
        Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                   lm_cfg=tcfg)
    # no weight: the LM is not used (greedy_ctc accepts it then)
    rec = Recognizer(torch_cfg(), torch_model(), mode="greedy_ctc",
                     device="cpu", lm_cfg=tcfg, lm=lm)
    assert rec.lm is None
