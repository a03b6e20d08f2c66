"""The port's streaming surfaces on the CPU: StreamSessions and HTTP
/stream (as tests/unit/test_serve_batcher.py and
tests/integration/test_serve.py hold tpu_asr's), serve's --stream-beam
and --no-streaming, python -m tpu_asr_torch.stream_demo on a checkpoint
of the port's trainer, the streaming presets against tpu_asr's, and the
trainer's --enc-chunk-size/--enc-left-chunks against bin/train.py's
rule."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.decode.streaming import (StreamingCTCBeamRecognizer,
                                            StreamingCTCRecognizer)
from tpu_asr_torch.serve import (AsrServer, SessionExpired, StreamSessions,
                                 build_streams, make_http_server, parse_args,
                                 streams_supported)
from torch_port_util import torch_cfg, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 4


def _feats(t=130, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, 80)) * 3).astype(np.float32)


class _Cfg:
    d_input = 8
    model_type = "ctc"


# ---- StreamSessions with stand-in recognizers ----

def test_stream_sessions_expired_and_concurrent():
    """A finished or idled-out id raises SessionExpired (no silent
    restart), and two sessions' decodes overlap (the decode runs outside
    the global lock)."""
    gate = threading.Barrier(2, timeout=5.0)

    class Rec:
        def __init__(self):
            self._tokens = []

        def push(self, feats):
            gate.wait()           # both sessions must be in here at once
            self._tokens.append(1)
            return [1]

        def finish(self):
            return list(self._tokens)

    ss = StreamSessions(_Cfg(), None, device="cpu")
    ss._new_recognizer = Rec
    outs = {}

    def run(sid):
        outs[sid] = ss.push(sid, np.ones((4, 8), np.float32))

    threads = [threading.Thread(target=run, args=(f"s{i}",))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert outs["s0"]["new_tokens"] == [1] == outs["s1"]["new_tokens"]
    assert ss.n_active == 2
    final = ss.push("s0", np.zeros((0, 8), np.float32), final=True)
    assert final["final"] and final["tokens"] == [1]
    with pytest.raises(SessionExpired, match="finished"):
        ss.push("s0", np.ones((4, 8), np.float32))
    ss.idle_timeout_s = 0.0
    time.sleep(0.01)
    with pytest.raises(SessionExpired, match="expired"):
        ss.push("s1", np.ones((4, 8), np.float32))
    assert ss.n_active == 0


def test_stream_sessions_closed_ring_is_bounded():
    ss = StreamSessions(_Cfg(), None, device="cpu")
    ss._closed_cap = 3

    class Rec:
        def push(self, feats):
            return []

        def finish(self):
            return []

    ss._new_recognizer = Rec
    for i in range(5):
        ss.push(f"s{i}", np.zeros((0, 8), np.float32), final=True)
    assert list(ss._closed) == ["s2", "s3", "s4"]
    ss.push("s0", np.ones((1, 8), np.float32))    # forgotten: a new session


def test_stream_sessions_final_race_raises_expired():
    """A push that took the session entry before a concurrent final push
    closed it gets SessionExpired once it holds the session lock, not an
    error from pushing into a finished recognizer."""
    class Rec:
        def __init__(self):
            self.finished = False

        def push(self, feats):
            assert not self.finished, "push after finish"
            return [1]

        def finish(self):
            self.finished = True
            return [1]

    ss = StreamSessions(_Cfg(), None, device="cpu")
    ss._new_recognizer = Rec
    ss.push("s0", np.ones((2, 8), np.float32))
    entry = ss._sessions["s0"]
    outcome = {}

    def late_push():
        with entry[1]:        # the final push must wait for this lock
            threading.Thread(target=lambda: ss.push(
                "s0", np.zeros((0, 8), np.float32), final=True)).start()
            time.sleep(0.1)
        time.sleep(0.3)       # the final push has finished and closed s0
        try:
            ss.push("s0", np.ones((2, 8), np.float32))
            outcome["late"] = "no error"
        except SessionExpired:
            outcome["late"] = "expired"

    t = threading.Thread(target=late_push)
    t.start()
    t.join(timeout=10)
    assert outcome == {"late": "expired"} and entry[3] is True
    # the tight window: the entry was looked up before the final push
    # closed it; the finished flag, read under the session lock, answers
    ss._closed.pop("s0")
    ss._sessions["s0"] = entry
    with pytest.raises(SessionExpired, match="already finished"):
        ss.push("s0", np.ones((2, 8), np.float32))


def test_stream_sessions_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamSessions(_Cfg(), None)


# ---- real sessions and HTTP ----

@pytest.fixture(scope="module")
def chunked():
    return torch_cfg(enc_chunk_size=CHUNK), torch_model(enc_chunk_size=CHUNK)


def _streamed(cfg, model, feats, step, beam=1):
    rec = (StreamingCTCBeamRecognizer(cfg, model, beam=beam,
                                      max_frames=3000, device="cpu")
           if beam > 1 else
           StreamingCTCRecognizer(cfg, model, max_frames=3000, device="cpu"))
    outs = [rec.push(feats[p:p + step]) for p in range(0, len(feats), step)]
    return outs, rec.finish(), rec


def test_sessions_equal_direct_recognizers(chunked):
    """Greedy sessions reply what StreamingCTCRecognizer returns, with
    the running hypothesis, times and confidences; beam sessions the
    beam's 1-best at every push."""
    cfg, model = chunked
    feats = _feats()
    for beam in (1, 3):
        outs, hyp, rec = _streamed(cfg, model, feats, 37, beam=beam)
        ss = StreamSessions(cfg, model, beam=beam, device="cpu")
        for i, p in enumerate(range(0, len(feats), 37)):
            r = ss.push("a", feats[p:p + 37])
            assert r["new_tokens"] == outs[i] and not r["final"]
        r = ss.push("a", [], final=True)
        assert r["final"] and r["tokens"] == hyp and r["new_tokens"] == []
        if beam == 1:
            assert r["times"] == rec.hypothesis_times
            assert r["confidence"] == rec.hypothesis_confidence
            assert len(hyp) >= 5
        else:
            assert "times" not in r


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(server, streams):
    httpd = make_http_server("127.0.0.1", 0, server, None, streams)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_http_stream_sessions(chunked):
    """Two concurrent /stream sessions answer what a direct recognizer
    returns (with times and confidence); a push after final answers 410,
    a push without a session 400; /healthz shows streaming and the
    active sessions."""
    cfg, model = chunked
    rec = Recognizer(cfg, model, mode="greedy_ctc", device="cpu",
                     beam=BeamConfig(beam=1))
    server = AsrServer(rec, bucket_frames=(256,), batch_size=2,
                       device="cpu")
    streams = StreamSessions(cfg, rec.model, device="cpu")
    httpd, thread, base = _serve(server, streams)
    feats = {sid: _feats(seed=s) for s, sid in enumerate(("a", "b"))}
    got = {}
    try:
        def session(sid):
            replies = [_post(base, "/stream", {
                "session": sid, "feats": feats[sid][p:p + 32].tolist()})
                for p in range(0, 130, 32)]
            replies.append(_post(base, "/stream", {"session": sid,
                                                   "final": True}))
            got[sid] = replies

        threads = [threading.Thread(target=session, args=(sid,))
                   for sid in feats]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        code, health = _post(base, "/stream", {"session": "c",
                                               "feats": feats["a"][:8]
                                               .tolist()})
        assert code == 200
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["streaming"] is True and health["active_streams"] == 1
        assert _post(base, "/stream", {"session": "a", "feats": []})[0] \
            == 410
        assert _post(base, "/stream", {"feats": []})[0] == 400
    finally:
        _stop(httpd, thread)
    for sid, replies in got.items():
        outs, hyp, direct = _streamed(cfg, model, feats[sid], 32)
        assert all(code == 200 for code, _ in replies), replies
        assert [b["new_tokens"] for _, b in replies[:-1]] == outs
        final = replies[-1][1]
        assert final["final"] and final["tokens"] == hyp
        assert final["times"] == direct.hypothesis_times
        assert final["confidence"] == direct.hypothesis_confidence
        assert final["text"] is None


def test_http_stream_disabled_answers_400(chunked):
    cfg, model = chunked
    rec = Recognizer(cfg, model, mode="greedy_ctc", device="cpu")
    server = AsrServer(rec, bucket_frames=(256,), batch_size=2,
                       device="cpu")
    httpd, thread, base = _serve(server, None)
    try:
        code, body = _post(base, "/stream", {"session": "a", "feats": []})
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        _stop(httpd, thread)
    assert code == 400 and "streaming disabled" in body["error"]
    assert health["streaming"] is False and health["active_streams"] == 0


def test_serve_cli_streams_by_the_reference_rule():
    """Streams on for conv2d ctc/hybrid and a chunked transducer (as
    bin/serve.py), off with --no-streaming; --stream-beam reaches the
    sessions."""
    from tpu_asr_torch.serve import build_server
    base = ["--random-init", "--device", "cpu", "--bucket-frames", "64",
            "--batch-size", "2", "--max-len", "4"]
    args = parse_args(base + ["--preset", "hybrid_dev", "--stream-beam",
                              "4"])
    server = build_server(args)
    streams = build_streams(args, server)
    assert streams.beam == 4 and streams.model is server.rec.model
    assert streams.device == server.device
    args = parse_args(base + ["--preset", "hybrid_dev", "--no-streaming"])
    assert build_streams(args, build_server(args)) is None
    from tpu_asr_torch.configs.presets import get_preset
    want = {"hybrid_dev": True, "ctc_dev": True, "streaming": True,
            "cif_dev": False, "attention": False, "transducer_dev": False,
            "transducer_streaming": True, "conformer_transducer": True}
    assert {k: streams_supported(get_preset(k).model) for k in want} == want


# ---- stream_demo on a checkpoint of the port's trainer ----

@pytest.fixture(scope="module")
def stream_ckpt(tmp_path_factory):
    """hybrid_dev trained with --enc-chunk-size 4 for one epoch; the
    saved CTC head's blank bias is then lowered by 50 (a new step) so
    that the model emits tokens (a few steps leave it all blank)."""
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.train.__main__ import main as train_main
    from tpu_asr_torch.train.checkpoints import Checkpointer
    d = tmp_path_factory.mktemp("stream")
    exp = str(d / "exp")
    train_main(["--preset", "hybrid_dev", "--enc-chunk-size", "4",
                "--synthetic", "16", "--epochs", "1", "--save-folder", exp,
                "--device", "cpu"])
    ck = Checkpointer(exp)
    assert ck.load_config().enc_chunk_size == 4
    state = ck.restore()
    state["model"]["ctc_head.ctc_proj.bias"][0] -= 50.0
    meta = state.pop("meta")
    ck.save(state, ck.latest_step() + 1, meta["epoch"])
    manifest = str(d / "all.jsonl")
    write_synthetic_manifest(manifest, 4, 64)
    return exp, manifest


@pytest.mark.parametrize("beam", [1, 3])
def test_stream_demo_equals_the_recognizer(stream_ckpt, beam, capsys):
    from tpu_asr_torch import stream_demo
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.train.checkpoints import Checkpointer
    exp, manifest = stream_ckpt
    summary = stream_demo.main([
        "--ckpt", exp, "--manifest", manifest, "--chunk-frames", "32",
        "--restore", "latest", "--beam", str(beam), "--device", "cpu"])
    out = capsys.readouterr()
    lines = [json.loads(x) for x in out.out.splitlines()
             if x.startswith("{")]
    assert lines[-1] == summary
    assert set(summary) == {"n_utts", "chunk_frames", "enc_chunk_size",
                            "mean_emission_lag_ms", "wall_s", "cer"}
    assert summary["n_utts"] == 4 and summary["enc_chunk_size"] == 4
    assert summary["mean_emission_lag_ms"] > 0
    assert "per-utterance CMVN is not causal" in out.err
    assert ("=[" if beam > 1 else "+[") in out.out
    ck = Checkpointer(exp)
    cfg = ck.load_config()
    model = build_model(cfg)
    model.load_state_dict(ck.restore()["model"])
    frontend = ck.load_frontend() or FrontendConfig()
    hyps = {x["id"]: x["tokens"] for x in lines[:-1]}
    for utt in load_manifest(manifest):
        feats = stream_demo.utterance_features(utt, frontend, "cpu")
        _, hyp, _ = _streamed(cfg, model, feats, 32, beam=beam)
        assert hyps[utt.id] == hyp
    assert any(hyps.values())


def test_stream_demo_refuses_cpu_without_asking(stream_ckpt):
    exp, manifest = stream_ckpt
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy, torch; torch.cuda.is_available = lambda: False"
         f"\nsys.argv = ['x', '--ckpt', {exp!r}, '--manifest', "
         f"{manifest!r}]\n"
         "runpy.run_module('tpu_asr_torch.stream_demo', "
         "run_name='__main__')"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


# ---- presets and trainer flags ----

def _plain(x):
    """A config as plain values (torch and jnp dtypes by name)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).rsplit(".", 1)[-1]
    if isinstance(x, type):                      # jnp.float32 and the like
        return np.dtype(x).name
    return x


@pytest.mark.parametrize("name", ["streaming", "transducer_streaming"])
def test_streaming_presets_equal_reference(name):
    from tpu_asr.configs.presets import get_preset as jax_preset
    from tpu_asr_torch.configs.presets import get_preset
    got = _plain(get_preset(name))
    assert got == _plain(jax_preset(name))
    assert got["model"]["enc_chunk_size"] == 16


@pytest.mark.parametrize("flags,want", [
    ([], (16, -1)),
    (["--enc-chunk-size", "0"], (0, -1)),
    (["--enc-chunk-size", "8", "--enc-left-chunks", "2"], (8, 2)),
    (["--enc-left-chunks", "-1"], (16, -1)),
    (["--enc-chunk-size", "-1", "--enc-left-chunks", "-2"], (16, -1)),
])
def test_trainer_chunk_flags_follow_bin_train(flags, want):
    """-1 / -2 keep the preset's chunk and left context; any other value
    overrides it, as bin/train.py does."""
    from tpu_asr_torch.train.__main__ import configure, parse_args
    _, mc = configure(parse_args(["--preset", "streaming", "--save-folder",
                                  "x"] + flags))
    assert (mc.enc_chunk_size, mc.enc_left_chunks) == want
    _, mc = configure(parse_args(["--preset", "hybrid_dev", "--save-folder",
                                  "x", "--enc-left-chunks", "3"]))
    assert (mc.enc_chunk_size, mc.enc_left_chunks) == (0, 3)
