"""The port's aishell recipe (prepare_data -> compute_cmvn -> train --cmvn
global -> recognize / serve) against tpu_asr's bin/ CLIs on the CPU.

Tolerances: apply_global_cmvn within 1e-6 (float32, the same two ops);
compute_cmvn's stats within the known log-mel gap (see
test_compute_cmvn_matches_reference); manifests byte-equal; fingerprints
and frontend.json fields equal.
"""

import dataclasses
import json
import os
import runpy
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.frontend as jfe
import tpu_asr_torch.frontend as tfe
from tpu_asr.train.checkpoints import Checkpointer as JaxCheckpointer
from tpu_asr_torch import compute_cmvn, prepare_data, recognize, serve
from tpu_asr_torch.train.__main__ import build_solver, configure, parse_args
from tpu_asr_torch.train.__main__ import main as train_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# field overrides shared by both packages' FrontendConfig (dtype aside)
FRONTENDS = [
    {},
    {"num_mel_bins": 40, "window": "hann", "frame_shift_ms": 12.5},
    {"high_freq": -200.0, "low_freq": 40.0, "preemphasis": 0.0,
     "log_floor": 1e-8, "remove_dc": False, "use_log": False},
    {"add_pitch": True, "pitch_min_f0": 50.0, "pitch_max_f0": 500.0,
     "pitch_smooth_weight": 4.0, "sample_rate": 8000},
]


def run_reference(script, argv, monkeypatch):
    """bin/<script> in this process with `argv`."""
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    runpy.run_path(os.path.join(REPO, "bin", script), run_name="__main__")


def write_stats(path, cfg, seed=0, fingerprint=True):
    rng = np.random.default_rng(seed)
    d = cfg.num_mel_bins
    kw = {"mean": rng.normal(-5.0, 2.0, d).astype(np.float32),
          "istd": rng.uniform(0.2, 2.0, d).astype(np.float32),
          "frames": np.int64(1234)}
    if fingerprint:
        kw["fingerprint"] = np.str_(tfe.feature_fingerprint(cfg))
    np.savez(path, **kw)
    return str(path)


@pytest.mark.parametrize("fields", FRONTENDS)
def test_fingerprint_equals_reference(fields):
    got = tfe.feature_fingerprint(tfe.FrontendConfig(**fields))
    assert got == jfe.feature_fingerprint(jfe.FrontendConfig(**fields))
    if fields:
        assert got != tfe.feature_fingerprint(tfe.FrontendConfig())


def test_apply_global_cmvn_matches_reference(tmp_path):
    path = write_stats(tmp_path / "s.npz", tfe.FrontendConfig())
    feats = np.random.default_rng(1).normal(-4.0, 3.0, (3, 17, 80)).astype(
        np.float32)
    got = tfe.apply_global_cmvn(torch.from_numpy(feats), tfe.FrontendConfig(
        cmvn_mode="global", cmvn_stats_path=path))
    want = jfe.apply_global_cmvn(jnp.asarray(feats), jfe.FrontendConfig(
        cmvn_mode="global", cmvn_stats_path=path))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_wav_to_features_global_normalizes(tmp_path):
    """The global branch of wav_to_features: (features - mean) * istd on
    the valid frames, zeros past them."""
    path = write_stats(tmp_path / "s.npz", tfe.FrontendConfig())
    rng = np.random.default_rng(2)
    wav = torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    lens = torch.tensor([4000, 2500])
    raw, fl = tfe.wav_to_features(wav, lens, tfe.FrontendConfig(
        cmvn_mode="none"))
    got, fl2 = tfe.wav_to_features(wav, lens, tfe.FrontendConfig(
        cmvn_mode="global", cmvn_stats_path=path))
    mean, istd, _ = tfe.load_cmvn_stats(path)
    want = (raw - torch.from_numpy(mean)) * torch.from_numpy(istd)
    valid = torch.arange(raw.shape[1])[None, :] < fl[:, None]
    assert torch.equal(fl, fl2)
    assert torch.equal(got[valid], want[valid])
    assert not got[~valid].any()
    # the (mean, istd) pair made once on the device normalizes the same
    cfg = tfe.FrontendConfig(cmvn_mode="global", cmvn_stats_path=path)
    pair = tfe.cmvn_stats_for(cfg, "cpu")
    assert torch.equal(pair[0], torch.from_numpy(mean))
    assert torch.equal(tfe.wav_to_features(wav, lens, cfg,
                                           cmvn_stats=pair)[0], got)
    assert tfe.cmvn_stats_for(tfe.FrontendConfig(), "cpu") is None


def test_mismatched_fingerprint_raises(tmp_path):
    other = tfe.FrontendConfig(num_mel_bins=40)
    path = write_stats(tmp_path / "s.npz", other)
    feats = torch.zeros(1, 3, 40)
    tfe.apply_global_cmvn(feats, dataclasses.replace(
        other, cmvn_mode="global", cmvn_stats_path=path))
    with pytest.raises(ValueError, match="different frontend"):
        tfe.apply_global_cmvn(feats, tfe.FrontendConfig(
            num_mel_bins=40, window="hann", cmvn_mode="global",
            cmvn_stats_path=path))
    # files written before the fingerprint was stored still load
    old = write_stats(tmp_path / "old.npz", other, fingerprint=False)
    assert tfe.load_cmvn_stats(old)[2] is None
    tfe.apply_global_cmvn(feats, tfe.FrontendConfig(
        num_mel_bins=40, window="hann", cmvn_mode="global",
        cmvn_stats_path=old))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An 8-utterance synthetic wav manifest (its .npy waves beside it)."""
    d = tmp_path_factory.mktemp("corpus")
    out = str(d / "all.jsonl")
    prepare_data.main(["--synthetic", "8", "--vocab-size", "16", "--seed",
                       "3", "--out", out])
    return out


@pytest.fixture(scope="module")
def stats_both(corpus, tmp_path_factory):
    """(port's .npz, reference's .npz) of the same manifest."""
    d = tmp_path_factory.mktemp("stats")
    port, ref = str(d / "port.npz"), str(d / "ref.npz")
    compute_cmvn.main(["--manifest", corpus, "--out", port, "--device",
                       "cpu"])
    mp = pytest.MonkeyPatch()
    try:
        run_reference("compute_cmvn.py", [
            "--manifest", corpus, "--out", ref, "--platform", "cpu",
            "--compile-cache", "off"], mp)
    finally:
        mp.undo()
    return port, ref


def test_compute_cmvn_matches_reference(stats_both):
    """frames equal; mean within atol 2e-3 and istd within rtol 1e-3. The
    gap is the known log-mel one (ROADMAP Queue 3, "Log-mel bins"): bins
    holding ~1e-7 of a frame's power differ by up to ~1e-3 between the two
    packages (float32 cancellation in both, the port within 2e-3 of
    float64), and the stats average those differences over the frames."""
    with np.load(stats_both[0]) as p, np.load(stats_both[1]) as r:
        assert set(p.files) == set(r.files) == {"mean", "istd", "frames",
                                                 "fingerprint"}
        assert int(p["frames"]) == int(r["frames"]) > 0
        assert str(p["fingerprint"]) == str(r["fingerprint"])
        assert p["mean"].dtype == r["mean"].dtype == np.float32
        np.testing.assert_allclose(p["mean"], r["mean"], atol=2e-3)
        np.testing.assert_allclose(p["istd"], r["istd"], rtol=1e-3)


def test_stats_load_across_packages(stats_both):
    """The reference's .npz applies in the port; the port's loads in
    tpu_asr.frontend.load_cmvn_stats and applies there."""
    port, ref = stats_both
    feats = np.random.default_rng(4).normal(-4.0, 3.0, (2, 9, 80)).astype(
        np.float32)
    for path in (port, ref):
        got = tfe.apply_global_cmvn(torch.from_numpy(feats),
                                    tfe.FrontendConfig(cmvn_mode="global",
                                                       cmvn_stats_path=path))
        want = jfe.apply_global_cmvn(jnp.asarray(feats), jfe.FrontendConfig(
            cmvn_mode="global", cmvn_stats_path=path))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    mean, istd, fp = jfe.load_cmvn_stats(port)
    assert fp == jfe.feature_fingerprint(jfe.FrontendConfig())
    assert mean.shape == istd.shape == (80,)


def test_compute_cmvn_frontend_json(corpus, tmp_path):
    """--frontend-json (a checkpoint folder's sidecar) sets the features
    the stats are of, and its CMVN fields are ignored."""
    fcfg = tfe.FrontendConfig(num_mel_bins=40, cmvn_mode="global",
                              cmvn_stats_path="/nowhere.npz")
    from tpu_asr_torch.train.checkpoints import Checkpointer
    Checkpointer(str(tmp_path / "ck")).save_frontend(fcfg)
    out = compute_cmvn.main(["--manifest", corpus, "--out",
                             str(tmp_path / "s.npz"), "--frontend-json",
                             str(tmp_path / "ck"), "--limit", "3",
                             "--device", "cpu"])
    assert out["mean"].shape == (40,)
    assert str(out["fingerprint"]) == tfe.feature_fingerprint(fcfg)


# ---- prepare_data against bin/prepare_data.py ----

def write_wav(path, n, rng):
    x = (0.2 * rng.standard_normal(n) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x.tobytes())


@pytest.fixture
def kaldi_pair(tmp_path):
    rng = np.random.default_rng(5)
    lines_scp, lines_text = [], []
    texts = {"u1": "今 天 天气", "u2": "你好 世界", "u3": "天 下"}
    for i, (uid, text) in enumerate(texts.items()):
        path = tmp_path / f"{uid}.wav"
        write_wav(path, 4000 + 1000 * i, rng)
        lines_scp.append(f"{uid} {path}")
        lines_text.append(f"{uid} {text}")
    lines_scp.append(f"u9 {tmp_path / 'u9.wav'}")      # no transcript
    (tmp_path / "wav.scp").write_text("\n".join(lines_scp) + "\n",
                                      encoding="utf-8")
    (tmp_path / "text").write_text("\n".join(lines_text) + "\n",
                                   encoding="utf-8")
    return tmp_path


def _both(tmp_path, argv, monkeypatch, dict_flag=None):
    """prepare_data with argv through the reference and the port, into
    the same folder -> (reference manifest bytes, port's, and the dicts'
    bytes when dict_flag names an output)."""
    out = {}
    for who in ("ref", "port"):
        args = argv + ["--out", str(tmp_path / f"{who}.jsonl")]
        if dict_flag:
            args += [dict_flag, str(tmp_path / f"{who}_dict.txt")]
        if who == "ref":
            run_reference("prepare_data.py", args, monkeypatch)
        else:
            prepare_data.main(args)
        out[who] = (tmp_path / f"{who}.jsonl").read_bytes()
        if dict_flag:
            out[who + "_dict"] = (tmp_path / f"{who}_dict.txt").read_bytes()
    return out


def test_prepare_data_kaldi_pair_matches_reference(kaldi_pair, monkeypatch):
    d = kaldi_pair
    out = _both(d, ["--wav-scp", str(d / "wav.scp"), "--text",
                    str(d / "text")], monkeypatch, "--dict-out")
    assert out["port"] == out["ref"]
    assert out["port_dict"] == out["ref_dict"]
    lines = [json.loads(x) for x in out["port"].decode().splitlines()]
    assert [u["id"] for u in lines] == ["u1", "u2", "u3"]
    assert lines[0]["text"] == "今天天气"
    assert lines[0]["num_samples"] == 4000
    # an existing dict encodes the text
    with_dict = _both(d, ["--wav-scp", str(d / "wav.scp"), "--text",
                          str(d / "text"), "--dict",
                          str(d / "ref_dict.txt")], monkeypatch)
    assert with_dict["port"] == with_dict["ref"]


def test_prepare_data_espnet_json_matches_reference(tmp_path, monkeypatch):
    data = {"utts": {
        "BAC009S0002W0122": {
            "input": [{"feat": "/data/feats.ark:17", "shape": [598, 80]}],
            "output": [{"tokenid": "10 3 7", "text": "而对楼", "shape":
                        [3, 4233]}]},
        "BAC009S0002W0123": {
            "input": [{"feat": "/data/feats.ark:9001", "shape": [411, 80]}],
            "output": [{"tokenid": "4", "shape": [1, 4233]}]}}}
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    out = _both(tmp_path, ["--espnet-json", str(path)], monkeypatch)
    assert out["port"] == out["ref"]
    first = json.loads(out["port"].decode().splitlines()[0])
    assert first["tokens"] == [10, 3, 7] and first["num_frames"] == 598


def test_prepare_data_flags_equal_reference(monkeypatch):
    """The port's CLI takes the reference's flags, and no others."""
    import argparse
    import re
    with open(os.path.join(REPO, "bin", "prepare_data.py")) as f:
        want = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', f.read()))
    got = set()
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        got.update(o for act in self._actions for o in act.option_strings)
        return real(self, *a, **k)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    prepare_data.parse_args(["--out", "x"])
    assert want and got - {"-h", "--help"} == want


@pytest.mark.parametrize("text_dist", ["uniform", "markov"])
def test_prepare_data_synthetic_matches_reference(tmp_path, monkeypatch,
                                                  text_dist):
    out = _both(tmp_path, ["--synthetic", "5", "--vocab-size", "24",
                           "--seed", "7", "--noise", "0.02", "--text-dist",
                           text_dist], monkeypatch)
    assert out["port"] == out["ref"]
    assert len(out["port"].decode().splitlines()) == 5


# ---- the trainer's --cmvn / --cmvn-stats / --pallas-ctc ----

@pytest.mark.parametrize("flag,want", [("-1", True), ("0", False),
                                       ("1", True)])
def test_pallas_ctc_flag_sets_model_config(flag, want):
    """As bin/train.py: 0/1 set ModelConfig.pallas_ctc, -1 keeps the
    preset's (the conformer preset's is True; hybrid_dev's None)."""
    _, mc = configure(parse_args(["--preset", "conformer", "--save-folder",
                                  "x", "--pallas-ctc", flag]))
    assert mc.pallas_ctc is want
    _, dev = configure(parse_args(["--preset", "hybrid_dev", "--save-folder",
                                   "x", "--pallas-ctc", flag]))
    assert dev.pallas_ctc is (None if flag == "-1" else want)


def test_cmvn_global_needs_stats():
    with pytest.raises(SystemExit):
        configure(parse_args(["--preset", "hybrid_dev", "--save-folder",
                              "x", "--cmvn", "global"]))


def test_trainer_frontend_json_equals_reference(stats_both, tmp_path,
                                                monkeypatch):
    """The stats path is stored made absolute, and frontend.json holds
    the fields tpu_asr's Checkpointer.save_frontend writes."""
    port_stats = stats_both[0]
    monkeypatch.chdir(os.path.dirname(port_stats))
    build_solver(parse_args([
        "--preset", "conformer_dev", "--synthetic", "4", "--cmvn", "global",
        "--cmvn-stats", os.path.basename(port_stats), "--save-folder",
        str(tmp_path / "port"), "--device", "cpu"]))
    got = json.loads((tmp_path / "port" / "frontend.json").read_text())
    JaxCheckpointer(str(tmp_path / "ref")).save_frontend(jfe.FrontendConfig(
        cmvn_mode="global", cmvn_stats_path=os.path.abspath(port_stats)))
    want = json.loads((tmp_path / "ref" / "frontend.json").read_text())
    assert got == want
    assert got["cmvn_stats_path"] == port_stats
    assert os.path.isabs(got["cmvn_stats_path"])


@pytest.fixture(scope="module")
def global_ckpt(corpus, stats_both, tmp_path_factory):
    """A conformer_dev checkpoint trained one epoch with --cmvn global."""
    d = tmp_path_factory.mktemp("ckpt")
    train_main(["--preset", "conformer_dev", "--train-manifest", corpus,
                "--cv-manifest", corpus, "--vocab-size", "16", "--epochs",
                "1", "--cmvn", "global", "--cmvn-stats", stats_both[0],
                "--save-folder", str(d), "--device", "cpu"])
    return str(d), stats_both[0]


@pytest.fixture
def cmvn_calls(monkeypatch):
    """The stats paths apply_global_cmvn normalizes with, call by call."""
    calls = []
    fn = tfe.apply_global_cmvn

    def counted(feats, cfg, stats=None):
        calls.append(cfg.cmvn_stats_path)
        return fn(feats, cfg, stats)
    monkeypatch.setattr(tfe, "apply_global_cmvn", counted)
    return calls


def test_recognize_picks_up_global_cmvn(global_ckpt, corpus, tmp_path,
                                        cmvn_calls, capsys):
    ckpt, stats = global_ckpt
    summary = recognize.main(["--ckpt", ckpt, "--manifest", corpus,
                              "--mode", "joint", "--beam", "2", "--max-len",
                              "8", "--output", str(tmp_path / "hyp.jsonl"),
                              "--device", "cpu"])
    assert summary["n_utts"] == 8
    assert cmvn_calls and set(cmvn_calls) == {stats}


def test_recognize_moves_the_stats_once(global_ckpt, corpus, tmp_path,
                                        cmvn_calls, monkeypatch):
    """One host-to-device copy of mean and istd for the whole decode,
    whatever the number of batches."""
    ckpt, stats = global_ckpt
    made = []
    fn = tfe.global_cmvn_tensors

    def counted(cfg, device):
        made.append(cfg.cmvn_stats_path)
        return fn(cfg, device)
    monkeypatch.setattr(tfe, "global_cmvn_tensors", counted)
    recognize.main(["--ckpt", ckpt, "--manifest", corpus, "--mode",
                    "greedy_ctc", "--batch-frames", "200", "--output",
                    str(tmp_path / "hyp.jsonl"), "--device", "cpu"])
    assert len(cmvn_calls) > 1
    assert made == [stats]


def test_serve_picks_up_global_cmvn(global_ckpt, corpus, cmvn_calls):
    ckpt, stats = global_ckpt
    server = serve.build_server(serve.parse_args([
        "--ckpt", ckpt, "--mode", "attn_rescore", "--beam", "3",
        "--max-len", "8", "--bucket-frames", "128", "--batch-size", "2",
        "--device", "cpu"]))
    assert server.frontend.cmvn_mode == "global"
    assert server.frontend.cmvn_stats_path == stats
    mean, istd, _ = tfe.load_cmvn_stats(stats)
    assert torch.equal(server.rec.cmvn_stats[0], torch.from_numpy(mean))
    assert torch.equal(server.rec.cmvn_stats[1], torch.from_numpy(istd))
    from tpu_asr_torch.data import load_manifest
    wav = np.load(load_manifest(corpus)[0].wav)
    server.start()
    try:
        nbest = server.submit("wav", wav)
    finally:
        server.stop()
    assert nbest and "yseq" in nbest[0]
    assert cmvn_calls and set(cmvn_calls) == {stats}
