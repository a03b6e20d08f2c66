"""Whisper in the port (models/whisper.py, frontend.whisper_log_mel, the
beam's forced prompt) on the CPU at whisper_dev's size, on seeded weights
that the port and the benchmark's plain reference (benchmark/reference/
whisper.py) share, and against a second, independent implementation:
transformers' WhisperFeatureExtractor and WhisperForConditionalGeneration
with the same weights copied in (transformers is imported inside these
tests alone). And the Speech-Transformer's beam search, which the forced
prompt shares, held bit for bit to its outputs from before the prompt.

Tolerances, each with its reason:
- FEAT_ATOL 2e-6 on log-mel ((log10 + 4) / 4 units): float32 STFTs of
  two FFT libraries, |X|^2 taken two ways, round differently in the
  last bits; the clamp to max - 8 keeps every power within eight
  decades of the largest, so a relative power error of 1e-6 moves a
  feature by under 1e-6 (1.2e-7 read at this size);
- ATOL 2e-5 on encoder outputs and logits (of magnitude ~3): float32 on
  both sides, with another order of the same sums (scores scaled once
  by 1/sqrt(dh) here, q and k by dh^-1/4 each there; GEMMs against
  broadcast or cached operands): 2e-6 read. The same model computed in
  bfloat16 misses it by three orders (test_a_lower_precision_fails_the_
  tolerance);
- SCORE_ATOL 1e-4 on beam scores: the sum of a dozen such log-
  probabilities.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import whisper as REF
from benchmark.trace import Stretch
from benchmark.weights import make_weights
from tpu_asr_torch.configs.presets import get_preset
from tpu_asr_torch.decode.beam import (BeamConfig, BeamSearch,
                                       attention_beam_search)
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.frontend import (WhisperFrontendConfig, wav_to_features,
                                    whisper_log_mel)
from tpu_asr_torch.models import Whisper, build_model
from tpu_asr_torch.models.config import WhisperConfig
from tpu_asr_torch.train.checkpoints import (Checkpointer, config_to_json,
                                             model_config_from_json)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_ATOL = 2e-6
ATOL = 2e-5
SCORE_ATOL = 1e-4
PRESET = get_preset("whisper_dev")
CFG = PRESET.model
FE = PRESET.frontend



def _cfg_dict(cfg=CFG) -> dict:
    return config_to_json(cfg)


def _fe_dict(fe=FE) -> dict:
    return {f.name: getattr(fe, f.name) for f in dataclasses.fields(fe)}


@pytest.fixture(scope="module")
def weights():
    return make_weights(REF.param_spec(_cfg_dict()), 7, "cpu", CFG.d_model)


def port_model(weights, cfg=CFG):
    model = build_model(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def ref_model(weights, kind="f32"):
    return REF.Model(_cfg_dict(), weights, REF.Precision(kind),
                     REF.Dropout(0.0, torch.float32, False))


def _wavs(lengths, seed=1, pad=None):
    """Tones of random pitch under noise (as the benchmark's traffic),
    zero past each length, padded to `pad` samples."""
    rng = np.random.default_rng(seed)
    pad = pad or max(lengths)
    out = np.zeros((len(lengths), pad), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        out[i, :n] = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
            + 0.05 * rng.standard_normal(n)
    return out, np.asarray(lengths, np.int64)


def _features(lengths, seed=1):
    wav, lens = _wavs(lengths, seed)
    return wav_to_features(torch.from_numpy(wav), torch.from_numpy(lens),
                           FE)


# ---- the frontend ----

def test_log_mel_matches_the_reference_on_each_wav():
    wav, lens = _wavs([16000, 9000, 3000], pad=20000)
    feats, flens = wav_to_features(torch.from_numpy(wav),
                                   torch.from_numpy(lens), FE)
    assert feats.shape == (3, FE.window_frames, 128)
    assert flens.tolist() == [100, 56, 18]
    for i, n in enumerate(lens):
        want, frames = REF.log_mel(torch.from_numpy(wav[i, :n]), _fe_dict())
        assert frames == flens[i]
        np.testing.assert_allclose(feats[i].numpy(), want.numpy(),
                                   atol=FEAT_ATOL, rtol=0)


@pytest.mark.parametrize("n_mels,chunk_s", [(128, 30.0), (80, 1.0)])
def test_log_mel_matches_transformers(n_mels, chunk_s):
    from transformers import WhisperFeatureExtractor
    fe = WhisperFrontendConfig(num_mel_bins=n_mels, chunk_s=chunk_s)
    hf = WhisperFeatureExtractor(feature_size=n_mels, sampling_rate=16000,
                                 hop_length=160, chunk_length=int(chunk_s),
                                 n_fft=400)
    wav, _ = _wavs([12345], seed=4)
    want = hf(wav[0].astype(np.float64), sampling_rate=16000,
              return_tensors="np")["input_features"][0].T
    got = whisper_log_mel(torch.from_numpy(wav), fe)[0].numpy()
    assert got.shape == want.shape == (fe.window_frames, n_mels)
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL, rtol=0)


@pytest.mark.parametrize("kaldi_field", [
    dict(preemphasis=0.97), dict(window="povey"), dict(remove_dc=True),
    dict(cmvn_mode="utterance"), dict(add_pitch=True)])
def test_the_frontend_takes_only_what_whisper_reads(kaldi_field):
    """A Kaldi fbank setting that whisper_log_mel would ignore is refused
    where it is set, not silently dropped."""
    with pytest.raises(TypeError):
        WhisperFrontendConfig(**kaldi_field)
    assert FE.feature_dim == 128 and FE.fft_size == FE.frame_length == 400


def test_longer_than_the_window_is_cut():
    wav, _ = _wavs([20000], seed=2)
    got = whisper_log_mel(torch.from_numpy(wav), FE)
    cut = whisper_log_mel(torch.from_numpy(wav[:, :16000]), FE)
    torch.testing.assert_close(got, cut, atol=0, rtol=0)


# ---- the model against the reference and against transformers ----

def _hf_model(weights, cfg=CFG):
    """transformers' Whisper at cfg's sizes with the port's weights."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration
    hc = HFConfig(vocab_size=cfg.vocab_size, num_mel_bins=cfg.d_input,
                  encoder_layers=cfg.num_enc_layers,
                  decoder_layers=cfg.num_dec_layers,
                  encoder_attention_heads=cfg.num_heads,
                  decoder_attention_heads=cfg.num_heads,
                  encoder_ffn_dim=cfg.d_inner, decoder_ffn_dim=cfg.d_inner,
                  d_model=cfg.d_model, max_source_positions=cfg.audio_ctx,
                  max_target_positions=cfg.pe_maxlen, dropout=0.0,
                  activation_function="gelu",
                  decoder_start_token_id=cfg.sos_id, eos_token_id=cfg.eot,
                  pad_token_id=cfg.eot, bos_token_id=cfg.eot)
    hf = WhisperForConditionalGeneration(hc).eval()
    names = {"slf_attn": "self_attn", "crs_attn": "encoder_attn",
             "attn_ln": "self_attn_layer_norm",
             "crs_ln": "encoder_attn_layer_norm",
             "ffn_ln": "final_layer_norm", "ffn.w_1": "fc1",
             "ffn.w_2": "fc2", "embed": "embed_tokens",
             "pe": "embed_positions", "ln_post": "layer_norm",
             "ln": "layer_norm"}
    state = {}
    for name, x in weights.items():
        parts = name.split(".")
        key = ".".join(parts)
        for a, b in names.items():
            key = key.replace(f".{a}.", f".{b}.")
        state["model." + key] = x
    pe = build_model(cfg).encoder.pe
    state["model.encoder.embed_positions.weight"] = pe
    state["proj_out.weight"] = weights["decoder.embed.weight"]
    missing, unexpected = hf.load_state_dict(state, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    return hf


def _ys(n=3, u=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    body = torch.randint(0, CFG.eot, (n, u - len(CFG.sot_sequence)),
                         generator=g)
    return torch.cat([torch.tensor(CFG.sot_sequence).expand(n, -1), body],
                     1)


def test_encoder_and_logits_match_reference_and_transformers(weights):
    feats, flens = _features([16000, 7000, 0])
    ys = _ys()
    model = port_model(weights)
    with torch.no_grad():
        enc, elens = model.encode(feats, flens)
        logits = model.decode_logits(enc, elens, ys)
        ref = ref_model(weights)
        r_enc = ref.encode(feats)
        r_logits = torch.stack([ref.decode(ys[i:i + 1], ref.cross_kv(
            r_enc[i:i + 1]))[0] for i in range(3)])
        hf = _hf_model(weights)
        h_enc = hf.model.encoder(feats.transpose(1, 2)).last_hidden_state
        h_logits = hf(input_features=feats.transpose(1, 2),
                      decoder_input_ids=ys).logits
    assert elens.tolist() == [50, 22, 0]      # ceil(frames / 2)
    for want in (r_enc, h_enc):
        np.testing.assert_allclose(enc.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)
    for want in (r_logits, h_logits):
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


def test_a_lower_precision_fails_the_tolerance(weights):
    """The same model computed in bfloat16 where the configuration
    states float32 misses ATOL on the logits."""
    feats, flens = _features([16000])
    ys = _ys(n=1)
    low = port_model(weights, dataclasses.replace(CFG,
                                                  dtype=torch.bfloat16))
    with torch.no_grad():
        got = low.decode_logits(*low.encode(feats, flens), ys).float()
        ref = ref_model(weights)
        want = ref.decode(ys, ref.cross_kv(ref.encode(feats)))
    assert (got - want).abs().max() > 10 * ATOL


def _cached_logits(model, enc, ys, beams):
    """ys [B * beams, U] through write_cross_kv and step_at, one
    position a call -> logits [B * beams, U, V]."""
    dec = model.decoder
    n, u = ys.shape
    cross = {k: torch.zeros(dec.cross_kv_shape(enc.shape[0], enc.shape[1]))
             for k in ("k", "v")}
    dec.write_cross_kv(enc, cross)
    cache = dec.init_cache(n, u + 3)
    out = []
    for i in range(u):
        logits, cache = dec.step_at(ys[:, i], torch.tensor([i]), cache,
                                    cross, None, beams=beams)
        out.append(logits)
    return torch.stack(out, 1)


def test_cached_steps_match_the_full_forward(weights):
    """Prefill (the prompt's positions) and cached steps, each
    utterance's beams against its one cross K/V row, give the
    teacher-forced logits at every position, for the port and the
    reference's full forward."""
    feats, flens = _features([16000, 7000])
    model = port_model(weights)
    ys = _ys(n=6, u=10, seed=3)                  # 2 utterances x 3 beams
    with torch.no_grad():
        enc, elens = model.encode(feats, flens)
        got = _cached_logits(model, enc, ys, beams=3)
        full = model.decode_logits(enc.repeat_interleave(3, 0),
                                   elens.repeat_interleave(3), ys)
        ref = ref_model(weights)
        r_enc = ref.encode(feats)
        want = torch.cat([ref.decode(ys[3 * b: 3 * b + 3], ref.cross_kv(
            r_enc[b:b + 1])) for b in range(2)])
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# ---- the beam: prompt, cap and scores ----

BEAM = {"mode": "beam", "beam": 3, "max_len": 12, "ctc_weight": 0.0,
        "maxlenratio": 0.25}


def test_beam_scores_match_the_reference(weights):
    """The Recognizer's served path on the CPU (the eager static step):
    each 1-best's reported score against the reference's score of those
    tokens after the prompt, and the reference's own beam's 1-best."""
    wav, lens = _wavs([16000, 11000, 5000, 0], seed=6)
    rec = Recognizer(CFG, port_model(weights), mode="beam", frontend=FE,
                     device="cpu",
                     beam=BeamConfig(beam=3, max_len=12, maxlenratio=0.25))
    got = rec.decode_batch_nbest({"wav": wav, "wav_lengths": lens})
    assert rec.decode_steps > 0 and rec.graph_steps == 0
    ref = ref_model(weights)
    for i, n in enumerate(lens[:3]):
        dec = REF.Decoded(ref, REF.log_mel(torch.from_numpy(wav[i, :n]),
                                           _fe_dict()))
        y, score = got[i][0]["yseq"], got[i][0]["score"]
        assert CFG.eot not in y and len(y) <= REF.maxlen_of(dec.t, BEAM)
        assert abs(score - REF.score_hypothesis(dec, y, BEAM)) < SCORE_ATOL
        best, best_score = REF.joint_beam(dec, BEAM)
        assert best == y and abs(best_score - score) < SCORE_ATOL


def test_prompt_is_written_before_the_first_scored_step(weights):
    """write_prompt feeds sos and the prompt but its last id at
    positions 0 .. P - 1 of every row's cache; the first scored step
    feeds the last id at position P and gives the teacher-forced logits
    after the whole sot_sequence."""
    feats, flens = _features([16000, 9000])
    model = port_model(weights)
    p = len(CFG.sot_sequence)
    with torch.no_grad():
        enc, elens = model.encode(feats, flens)
        search = BeamSearch(model.decoder, None, BeamConfig(beam=2,
                                                            max_len=5),
                            2, enc.shape[1], CFG.sos_id, CFG.eos_id, None,
                            "cpu", prompt=CFG.prompt_ids)
        search.load(enc, elens)
        assert search.cache["k"].shape[2] == 5 + p - 1
        search.write_prompt()
        assert search.y_prev.tolist() == [CFG.sot_sequence[-1]] * 4
        assert search.dec_pos.item() == p - 1 and search.pos.item() == 0
        rows = search.cache["k"].abs().sum(dim=(0, 3, 4))   # [N, U]
        assert bool((rows[:, :p - 1] > 0).all())
        assert bool((rows[:, p - 1:] == 0).all())
        first, _ = model.decoder.step_at(
            search.y_prev, search.dec_pos, search.cache, search.cross_kv,
            None, beams=2)
        full = model.decode_logits(
            enc, elens, torch.tensor([CFG.sot_sequence] * 2))[:, -1]
    np.testing.assert_allclose(first.numpy(),
                               full.repeat_interleave(2, 0).numpy(),
                               atol=ATOL, rtol=0)


def test_cap_from_speech_frames_while_the_window_is_attended(weights):
    """The length cap reads the frames that carry speech; the decoder
    attends every frame of the window: a change past an utterance's
    speech moves its logits, and not its cap."""
    feats, flens = _features([16000, 6000])
    model = port_model(weights)
    cfg = BeamConfig(beam=2, max_len=12, maxlenratio=0.25)
    with torch.no_grad():
        enc, elens = model.encode(feats, flens)
        assert enc.shape[1] == CFG.audio_ctx and elens.tolist() == [50, 19]
        out = attention_beam_search(model.decoder, enc, elens, CFG.sos_id,
                                    CFG.eos_id, cfg,
                                    prompt=CFG.prompt_ids)
        caps = [int(0.25 * t) for t in elens.tolist()]           # 12, 4
        assert (out["lengths"][1] <= caps[1]).all()
        assert int(out["lengths"].max()) <= caps[0]
        search = BeamSearch(model.decoder, None, cfg, 2, enc.shape[1],
                            CFG.sos_id, CFG.eos_id, None, "cpu",
                            prompt=CFG.prompt_ids)
        logits = []
        for e in (enc, torch.cat([enc[:, :30], enc[:, 30:] + 1.0], 1)):
            search.load(e, elens)
            assert search.utt_maxlen.tolist() == caps
            search.write_prompt()
            logits.append(model.decoder.step_at(
                search.y_prev, search.dec_pos, search.cache,
                search.cross_kv, search.enc_lengths, beams=2)[0])
    assert (logits[0][2:] - logits[1][2:]).abs().max() > 1e-3


def test_spans_of_a_batch_and_their_readers(weights):
    """Under the benchmark's profiler a Whisper batch emits its phases in
    order, the cross K/V and the prompt once each, and encode_issue_ms and
    cross_kv_issue_ms read those spans."""
    wav, lens = _wavs([16000, 7000], seed=2)
    rec = Recognizer(CFG, port_model(weights), mode="beam", frontend=FE,
                     device="cpu", beam=BeamConfig(beam=2, max_len=6))
    st = Stretch("cpu")
    st.start()
    try:
        rec.decode_batch_nbest({"wav": wav, "wav_lengths": lens})
    finally:
        st.stop()
    marks = st.summary["marks"]
    names = [m[0] for m in marks]
    order = ["recognizer.features", "recognizer.encode", "decoder.cross_kv",
             "beam.prompt", "beam.sync", "beam.step", "recognizer.fetch"]
    firsts = [names.index(n) for n in order]
    assert firsts == sorted(firsts)
    for name in order[:4]:
        assert names.count(name) == 1, name
    ctx = {"kind": "serve", "trace": {"marks": marks}}
    for reader, span in (("encode_issue_ms", "recognizer.encode"),
                         ("cross_kv_issue_ms", "decoder.cross_kv")):
        mod = harness.load_module(
            os.path.join(harness.HERE, "metrics", reader + ".py"),
            "test_whisper_metric_" + reader)
        assert mod.read(ctx) == pytest.approx(
            next(m[2] for m in marks if m[0] == span) / 1e3)


def test_positions_past_the_learned_table_are_refused(weights):
    feats, flens = _features([16000])
    model = port_model(weights)
    with torch.no_grad():
        enc, elens = model.encode(feats, flens)
        with pytest.raises(ValueError, match="decoder positions"):
            attention_beam_search(model.decoder, enc, elens, CFG.sos_id,
                                  CFG.eos_id, BeamConfig(beam=2, max_len=126),
                                  prompt=CFG.prompt_ids)


def test_prompt_takes_no_lm():
    model = Whisper(CFG)
    with pytest.raises(ValueError, match="prompt"):
        BeamSearch(model.decoder, object(), BeamConfig(), 1, 50, CFG.sos_id,
                   CFG.eos_id, None, "cpu", prompt=CFG.prompt_ids)


def test_feats_batches_are_refused(weights):
    rec = Recognizer(CFG, port_model(weights), mode="beam", frontend=FE,
                     device="cpu")
    with pytest.raises(ValueError, match="waveforms"):
        rec.decode_batch({"feats": np.zeros((1, 100, 128), np.float32),
                          "feat_lengths": np.array([100])})


# ---- presets, configs and the CLIs ----

def test_presets_and_config_round_trip(tmp_path):
    big = get_preset("whisper_large_v3").model
    assert isinstance(big, WhisperConfig) and big.model_type == "transformer"
    assert (big.d_model, big.num_heads, big.num_enc_layers,
            big.num_dec_layers, big.d_inner, big.vocab_size, big.d_input,
            big.audio_ctx, big.pe_maxlen) == (1280, 20, 32, 32, 5120, 51866,
                                              128, 1500, 448)
    assert (big.sos_id, big.eos_id, big.prompt_ids) == \
        (50258, 50257, (50260, 50360, 50364))
    assert big.use_pallas and big.dtype == torch.bfloat16
    assert get_preset("whisper_large_v3").frontend.window_frames == 3000
    back = model_config_from_json(json.loads(json.dumps(config_to_json(
        big))))
    assert back == big
    ck = Checkpointer(str(tmp_path))
    ck.save_config(CFG)
    ck.save_frontend(FE)
    assert ck.load_config() == CFG and ck.load_frontend() == FE
    st = get_preset("aishell").model
    assert model_config_from_json(config_to_json(st)) == st
    assert (st.sos_id, st.eos_id, st.prompt_ids) == (4231, 4232, ())


def test_serve_cli_builds_the_preset(monkeypatch):
    from tpu_asr_torch import serve
    args = serve.parse_args(["--random-init", "--preset", "whisper_dev",
                             "--device", "cpu", "--bucket-frames", "100",
                             "--batch-size", "2", "--maxlenratio", "0.25",
                             "--inputs", "wav"])
    server = serve.build_server(args)
    assert isinstance(server.rec.model, Whisper)
    assert server.rec.mode == "beam" and server.rec.frontend == FE
    assert serve.build_streams(args, server) is None
    server.warmup(kinds=("wav",))
    server.start()
    try:
        wav, _ = _wavs([9000], seed=8)
        nbest = server.submit("wav", wav[0])
    finally:
        server.stop()
    assert 1 <= len(nbest[0]["yseq"]) <= int(0.25 * 28)


def test_recognize_cli_random_init(tmp_path):
    from tpu_asr_torch import recognize
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    manifest = tmp_path / "m.jsonl"
    write_synthetic_manifest(str(manifest), 2, 64)
    # no reference tokens: the buckets' token bounds then drop none
    lines = [dict(json.loads(x), tokens=[])
             for x in manifest.read_text().splitlines()]
    manifest.write_text("".join(json.dumps(x) + "\n" for x in lines))
    out = tmp_path / "hyp.jsonl"
    summary = recognize.main(["--random-init", "--preset", "whisper_dev",
                              "--manifest", str(manifest), "--beam", "3",
                              "--max-len", "12", "--maxlenratio", "0.25",
                              "--output", str(out), "--device", "cpu"])
    assert summary["n_utts"] == 2 and summary["mode"] == "beam"
    hyps = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(hyps) == 2
    assert all(len(h["hyp_tokens"]) <= 12 for h in hyps)


def test_train_cli_refuses_whisper():
    from tpu_asr_torch.train.__main__ import configure, parse_args
    with pytest.raises(SystemExit, match="does not train"):
        configure(parse_args(["--preset", "whisper_dev", "--synthetic", "4",
                              "--device", "cpu", "--save-folder", "/x"]))


# ---- the Speech-Transformer's beam, bit for bit as before the prompt ----

def test_speech_transformer_beam_is_unchanged():
    """hybrid_dev (vocabulary 40, init_random seed 0) and an LM (seed 1)
    on fixed encoder outputs and CTC log-probs: every branch's tokens,
    lengths, steps and scores (as float hex) equal those the search gave
    before it took a prompt (tests/st_beam_before_prompt.json)."""
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import init_random
    with open(os.path.join(ROOT, "tests", "st_beam_before_prompt.json")) as f:
        want = json.load(f)
    v = 40
    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=v)
    model = init_random(Transformer(cfg), 0).eval()
    lm = init_random(TransformerLM(LMConfig(
        vocab_size=v, d_model=32, d_inner=64, num_heads=2, num_layers=2,
        dropout=0.0)), 1).eval()
    rng = np.random.default_rng(3)
    enc = torch.from_numpy(rng.standard_normal((3, 14, 64)).astype(
        np.float32))
    lens = torch.tensor([14, 9, 5])
    logp = torch.log_softmax(torch.from_numpy((2.0 * rng.standard_normal(
        (3, 14, v))).astype(np.float32)), -1)
    branches = {"joint1": dict(ctc_weight=0.3, ctc_two_pass=False),
                "joint2": dict(ctc_weight=0.3, ctc_two_pass=True),
                "beam": {}, "lm": dict(ctc_weight=0.3, lm_weight=0.4),
                "len": dict(ctc_weight=0.5, maxlenratio=0.5,
                            minlenratio=0.2)}
    assert set(branches) == set(want)
    for name, kw in branches.items():
        with torch.no_grad():
            r = attention_beam_search(model.decoder, enc, lens, v - 2, v - 1,
                                      BeamConfig(beam=3, max_len=8, **kw),
                                      ctc_logp=logp, lm=lm)
        got = {"tokens": r["tokens"].tolist(),
               "lengths": r["lengths"].tolist(),
               "scores": [float(x).hex() for x in r["scores"].reshape(-1)],
               "steps": r["steps"]}
        assert got == want[name], name

