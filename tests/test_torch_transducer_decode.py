"""Port transducer decoding (tpu_asr_torch.decode.transducer_decode, the
Recognizer's transducer modes, recognize and serve) vs tpu_asr on the
CPU, from the same flax params at transducer_dev widths and the same
numpy inputs.

Tokens, lengths and times must be equal; confidences within 1e-5,
scores within 1e-4.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode import transducer_decode as jd
from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr.models import TransducerModel as JaxTransducer
from tpu_asr_torch.decode import transducer_decode as td
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from torch_port_util import (VOCAB, lm_pair, transducer_flax_params,
                             transducer_jax_cfg, transducer_torch_cfg,
                             transducer_torch_model, wav_batch)

SCORE_TOL = 1e-4
CONF_TOL = 1e-5


def _feats(seed=0, lengths=(120, 100, 61, 0), t=120):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((len(lengths), t, 80)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.fixture(scope="module")
def pair():
    """(jax module, its params, port model) with the same weights."""
    return (JaxTransducer(transducer_jax_cfg()), transducer_flax_params(),
            transducer_torch_model())


def _port_greedy(model, feats, flens, **kw):
    """The port's greedy decode, recording at each loop step which rows
    emitted (their predictor input is not <sos>)."""
    steps = []
    step = model.predictor_step

    def spy(y, pos, cache):
        steps.append(y != VOCAB - 2)
        return step(y, pos, cache)
    model.predictor_step = spy
    try:
        with torch.no_grad():
            out = td.transducer_greedy_decode(
                model, torch.from_numpy(feats), torch.from_numpy(flens), **kw)
    finally:
        del model.predictor_step
    return out, torch.stack(steps[1:])           # [steps, B], after init


@pytest.mark.parametrize("max_symbols", [4, 2])
def test_greedy_matches_reference(pair, max_symbols):
    """Tokens, lengths, times equal, confidences within 1e-5, on a batch
    where rows hold on a blank while others emit and the per-frame cap
    binds."""
    jm, params, model = pair
    feats, flens = _feats()
    want = jd.transducer_greedy_decode(
        jm, params, jnp.asarray(feats), jnp.asarray(flens), max_tokens=30,
        max_symbols_per_frame=max_symbols, return_times=True)
    (toks, lens, times, confs, steps), emitted = _port_greedy(
        model, feats, flens, max_tokens=30,
        max_symbols_per_frame=max_symbols)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(times.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(confs.numpy(), np.asarray(want[3]),
                               atol=CONF_TOL)
    live = emitted[:, :3]                        # the rows with frames
    assert (live.any(1) & ~live.all(1)).any()    # some emit, some hold
    per_frame = [np.bincount(times[i, :lens[i]].numpy()).max()
                 for i in range(3) if lens[i]]
    assert max(per_frame) == max_symbols         # the cap binds
    assert lens[3] == 0 and steps >= int(flens.max()) // 4


def test_greedy_init_and_advance_compose(pair):
    """Advancing chunk by chunk (frame_offset) equals one advance over
    the whole utterance: the streaming recognizer's use."""
    _, _, model = pair
    feats, flens = _feats(1, (120, 88))
    with torch.no_grad():
        enc, el = model.encode(*map(torch.from_numpy, (feats, flens)))
        f = model.enc_features(enc)
        whole, _ = td.greedy_advance(model, f, el,
                                     td.greedy_init(model, 2, 20))
        state = td.greedy_init(model, 2, 20)
        for s in range(0, f.shape[1], 8):
            state, _ = td.greedy_advance(
                model, f[:, s: s + 8], (el - s).clamp(0, 8), state,
                frame_offset=s)
    for k in ("u", "tokens", "times"):
        assert torch.equal(state[k], whole[k]), k
    torch.testing.assert_close(state["confs"], whole["confs"])


def _beam_both(pair, beam, lm=None, lm_weight=0.0, **kw):
    jm, params, model = pair
    feats, flens = _feats(2, (120, 97, 0))
    jlm, jlm_params, tlm = lm if lm else (None, None, None)
    want = jd.transducer_beam_search(
        jm, params, jnp.asarray(feats), jnp.asarray(flens), beam=beam,
        max_tokens=20, lm=jlm, lm_params=jlm_params, lm_weight=lm_weight,
        **kw)
    with torch.no_grad():
        got = td.transducer_beam_search(
            model, torch.from_numpy(feats), torch.from_numpy(flens),
            beam=beam, max_tokens=20, lm=tlm, lm_weight=lm_weight, **kw)
    return {k: np.asarray(v) for k, v in want.items()}, got


def _assert_beam_equal(want, got):
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    live = want["scores"] > -1e29
    np.testing.assert_allclose(got["scores"].numpy()[live],
                               want["scores"][live], atol=SCORE_TOL,
                               rtol=SCORE_TOL)
    assert (got["scores"].numpy()[~live] < -1e29).all()


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_matches_reference(pair, beam):
    want, got = _beam_both(pair, beam)
    _assert_beam_equal(want, got)
    assert got["steps"] > 0 and got["lengths"][0, 0] > 0


def test_beam_1_equals_greedy_when_the_cap_does_not_bind(pair):
    _, _, model = pair
    feats, flens = _feats(2, (120, 97, 0))
    _, got = _beam_both(pair, 1)
    (toks, lens, *_), _ = _port_greedy(model, feats, flens, max_tokens=20,
                                       max_symbols_per_frame=1000)
    assert torch.equal(got["lengths"][:, 0], lens)
    assert torch.equal(got["tokens"][:, 0], toks)


def test_beam_with_lm_matches_reference(pair):
    """Shallow fusion with a small seeded LM (lm 0.3): the LM moves the
    result, and the port equals the reference."""
    want, got = _beam_both(pair, 4, lm=lm_pair(VOCAB), lm_weight=0.3)
    _assert_beam_equal(want, got)
    plain, _ = _beam_both(pair, 4)
    assert not np.array_equal(plain["scores"], want["scores"])


def test_beam_length_penalty_and_label_cand(pair):
    want, got = _beam_both(pair, 3, label_cand=5, length_penalty=0.5)
    _assert_beam_equal(want, got)


def test_rescore_matches_reference(pair):
    jm, params, model = pair
    feats, flens = _feats(3, (120, 97, 61, 0))
    want = jd.transducer_rescore(jm, params, jnp.asarray(feats),
                                 jnp.asarray(flens), beam=5, max_len=12,
                                 ctc_weight=0.5)
    with torch.no_grad():
        got = td.transducer_rescore(model, torch.from_numpy(feats),
                                    torch.from_numpy(flens), beam=5,
                                    max_len=12, ctc_weight=0.5)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    for k in ("scores", "rnnt_scores", "ctc_scores"):
        w = np.asarray(want[k])
        live = np.asarray(want["scores"]) > -1e29
        np.testing.assert_allclose(got[k].numpy()[live], w[live],
                                   atol=SCORE_TOL, rtol=SCORE_TOL,
                                   err_msg=k)
    assert (got["lengths"][:3, 0] > 0).all()


# ---- the Recognizer ----

WAVS = wav_batch([12000, 9600, 4800, 0], seed=11)


@pytest.mark.parametrize("mode,beam_kw", [
    ("transducer_greedy", dict(beam=1, max_len=16)),
    ("transducer_beam", dict(beam=3, max_len=16, nbest=3)),
    ("transducer_rescore", dict(beam=4, max_len=16, nbest=4,
                                ctc_weight=0.5)),
    ("greedy_ctc", dict()),
    ("ctc_beam", dict(beam=3, max_len=16, nbest=3)),
])
def test_recognizer_modes_match_reference(pair, mode, beam_kw):
    """The three transducer modes, and the CTC modes on the transducer's
    aux head, give the reference's n-best (and greedy times and
    confidences)."""
    _, params, model = pair
    jrec = JaxRecognizer(cfg=transducer_jax_cfg(), params=params, mode=mode,
                         beam=JaxBeam(**beam_kw))
    trec = Recognizer(transducer_torch_cfg(), model, mode=mode, device="cpu",
                      beam=BeamConfig(**beam_kw))
    want, got = jrec.decode_batch_nbest(WAVS), trec.decode_batch_nbest(WAVS)
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert [h["yseq"] for h in g] == [h["yseq"] for h in w]
        for hw, hg in zip(w, g):
            if hw["score"] > -1e29:
                assert abs(hg["score"] - hw["score"]) <= SCORE_TOL
            for k in ("times", "confidence"):
                assert (k in hg) == (k in hw)
            if "times" in hw:
                assert hg["times"] == hw["times"]
                np.testing.assert_allclose(hg["confidence"],
                                           hw["confidence"], atol=1e-4)
    assert any(h[0]["yseq"] for h in got) and got[3][0]["yseq"] == []
    if mode.startswith("transducer_") and mode != "transducer_rescore":
        assert trec.decode_steps > 0


def test_transducer_mode_checks():
    """rescore needs the aux CTC head, the CTC modes too; joint and
    attn_rescore need a decoder; transducer_beam takes the LM."""
    no_ctc = transducer_torch_cfg(ctc_weight=0.0)
    model = transducer_torch_model(ctc_weight=0.0)
    for mode in ("transducer_rescore", "greedy_ctc", "ctc_beam"):
        with pytest.raises(ValueError):
            Recognizer(no_ctc, model, mode=mode, device="cpu")
    Recognizer(no_ctc, model, mode="transducer_beam", device="cpu")
    for mode in ("joint", "attn_rescore", "beam", "cif_greedy"):
        with pytest.raises(ValueError):
            Recognizer(transducer_torch_cfg(), transducer_torch_model(),
                       mode=mode, device="cpu")
    _, _, lm = lm_pair(VOCAB)
    rec = Recognizer(transducer_torch_cfg(), transducer_torch_model(),
                     mode="transducer_beam", device="cpu", lm_cfg=lm.cfg,
                     lm=lm, beam=BeamConfig(beam=2, max_len=8,
                                            lm_weight=0.3))
    assert rec.lm is lm
    with pytest.raises(ValueError, match="LM fusion"):
        Recognizer(transducer_torch_cfg(), transducer_torch_model(),
                   mode="transducer_greedy", device="cpu", lm_cfg=lm.cfg,
                   lm=lm, beam=BeamConfig(lm_weight=0.3))


# ---- the CLIs ----

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A transducer_dev checkpoint trained on the CPU for 2 epochs on 11
    synthetic utterances (5 held out), and a small LM."""
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.train.__main__ import main as train
    from tpu_asr_torch.train_lm import main as train_lm
    d = tmp_path_factory.mktemp("transducer_cli")
    write_synthetic_manifest(str(d / "all.jsonl"), 16, 64, seed=0)
    lines = open(d / "all.jsonl").read().splitlines()
    (d / "cv.jsonl").write_text("\n".join(lines[:5]) + "\n")
    (d / "train.jsonl").write_text("\n".join(lines[5:]) + "\n")
    data = ["--train-manifest", str(d / "train.jsonl"), "--cv-manifest",
            str(d / "cv.jsonl"), "--vocab-size", "64", "--device", "cpu"]
    train(["--preset", "transducer_dev", "--epochs", "2", "--save-folder",
           str(d / "exp")] + data)
    train_lm(["--d-model", "32", "--d-inner", "64", "--num-heads", "2",
              "--num-layers", "2", "--epochs", "1", "--batch-size", "4",
              "--save-folder", str(d / "lm")] + data)
    return d


def test_train_cli_writes_loss_rnnt(trained):
    from tpu_asr_torch.train.checkpoints import Checkpointer
    cfg = Checkpointer(str(trained / "exp")).load_config()
    assert cfg.model_type == "transducer" and cfg.num_pred_layers == 1
    lines = [json.loads(x) for x in open(trained / "exp" / "metrics.jsonl")]
    cv = [x for x in lines if x.get("phase") == "cv"]
    assert len(cv) == 2 and all(np.isfinite(x["loss"]) for x in cv)


@pytest.mark.parametrize("argv", [
    [],                                            # default: greedy
    ["--mode", "transducer_beam", "--beam", "3", "--nbest", "2"],
    ["--mode", "transducer_beam", "--beam", "3", "--lm-ckpt", "LM",
     "--lm-weight", "0.3"],
    ["--mode", "transducer_rescore", "--beam", "4", "--nbest", "2",
     "--ctc-weight", "0.5"],
])
def test_recognize_transducer_modes(trained, argv, capsys):
    from tpu_asr_torch.recognize import main as recognize
    argv = [str(trained / "lm") if a == "LM" else a for a in argv]
    hyp = trained / "hyp.jsonl"
    summary = recognize(["--ckpt", str(trained / "exp"), "--manifest",
                         str(trained / "cv.jsonl"), "--max-len", "12",
                         "--output", str(hyp), "--device", "cpu"] + argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary and summary["n_utts"] == 5
    assert summary["mode"] == (argv[1] if argv else "transducer_greedy")
    assert {"inverse_rtf", "wall_s", "cer"} <= set(summary)
    lines = [json.loads(x) for x in open(hyp)]
    assert len(lines) == 5
    if not argv:
        assert all(len(x["times"]) == len(x["hyp_tokens"]) for x in lines)
    if "--nbest" in argv:
        assert all(len(x["nbest"]) == 2 for x in lines)


def test_serve_transducer_checkpoint(trained):
    """serve --ckpt on a transducer checkpoint: the model type's default
    mode (transducer_greedy) and transducer_rescore with --ctc-weight;
    submit() answers with the Recognizer's tokens."""
    from tpu_asr_torch.serve import build_server, parse_args
    wav = np.load(json.loads(open(trained / "cv.jsonl").readline())["wav"])
    for argv, mode in (([], "transducer_greedy"),
                       (["--mode", "transducer_rescore", "--beam", "4",
                         "--ctc-weight", "0.5"], "transducer_rescore")):
        server = build_server(parse_args(
            ["--ckpt", str(trained / "exp"), "--device", "cpu",
             "--bucket-frames", "256", "--batch-size", "2",
             "--max-len", "12"] + argv))
        assert server.rec.mode == mode
        assert server.rec.beam.ctc_weight == (0.5 if argv else 0.0)
        server.start()
        try:
            got = server.submit("wav", wav, timeout=120.0)
        finally:
            server.stop()
        want = server.rec.decode_batch_nbest(
            {"wav": wav[None], "wav_lengths": np.array([len(wav)])})[0]
        assert got[0]["yseq"] == want[0]["yseq"]


def test_greedy_does_not_depend_on_the_host_check_interval(pair,
                                                           monkeypatch):
    """The greedy loop checks the host every GREEDY_SYNC_EVERY steps; the
    result does not depend on how often."""
    _, _, model = pair
    feats, flens = _feats()
    out = {}
    for every in (1, 8):
        monkeypatch.setattr(td, "GREEDY_SYNC_EVERY", every)
        out[every], _ = _port_greedy(model, feats, flens, max_tokens=30)
    for a, b in zip(out[1][:4], out[8][:4]):
        assert torch.equal(a, b)
    assert out[8][4] >= out[1][4] and out[8][4] % 8 == 0


def test_transducer_config_round_trips_through_the_checkpointer(tmp_path):
    from tpu_asr_torch.train.checkpoints import Checkpointer
    cfg = dataclasses.replace(transducer_torch_cfg("conformer_transducer"),
                              vocab_size=VOCAB)
    ck = Checkpointer(str(tmp_path))
    ck.save_config(cfg)
    assert ck.load_config() == cfg
