"""Port AsrServer / HTTP front end on the CPU."""

import concurrent.futures
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.serve import (AsrServer, UtteranceTooLong,
                                 make_http_server, parse_args)
from torch_port_util import torch_cfg, torch_model, wav_batch

BUCKETS = (64, 128)
LENGTHS = [9600, 6400, 12000]     # two land in the 64-frame bucket


@pytest.fixture()
def server():
    rec = Recognizer(torch_cfg(), torch_model(), mode="joint", device="cpu",
                     beam=BeamConfig(beam=2, max_len=6, ctc_weight=0.3,
                                     nbest=2))
    srv = AsrServer(rec, bucket_frames=BUCKETS, batch_size=2, device="cpu")
    srv.warmup(kinds=("wav",))
    srv.start()
    yield srv
    srv.stop()


def _direct(rec, wav, bucket_frames):
    """The same utterance decoded alone in its bucket's static shape."""
    batch = {"wav": np.zeros((2, bucket_frames * 160), np.float32),
             "wav_lengths": np.array([len(wav), 0], np.int32)}
    batch["wav"][0, :len(wav)] = wav
    return rec.decode_batch_nbest(batch)[0]


def test_concurrent_requests_equal_direct_decode(server):
    b = wav_batch(LENGTHS, seed=9)
    wavs = [b["wav"][i, :n] for i, n in enumerate(LENGTHS)]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        got = list(pool.map(lambda w: server.submit("wav", w, nbest=2,
                                                    timeout=120), wavs))
    for wav, nb in zip(wavs, got):
        frames = len(wav) // 160
        bucket = next(t for t in BUCKETS if frames <= t)
        assert nb == _direct(server.rec, wav, bucket)
    assert server.stats["requests"] == 3


def test_decode_failure_raises_to_submitter(server):
    def boom(batch):
        raise RuntimeError("decoder exploded")
    server.rec.decode_batch_nbest = boom
    with pytest.raises(RuntimeError, match="decoder exploded"):
        server.submit("wav", np.zeros(4000, np.float32), timeout=60)


def test_submit_validates_input(server):
    with pytest.raises(UtteranceTooLong):
        server.submit("wav", np.zeros(200 * 160, np.float32))
    with pytest.raises(ValueError):
        server.submit("wav", np.zeros(10, np.float32))
    with pytest.raises(ValueError):
        server.submit("feats", np.zeros((10, 3), np.float32))


def test_http_recognize_and_healthz(server):
    httpd = make_http_server("127.0.0.1", 0, server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["bucket_frames"] == list(BUCKETS)
        assert health["device"] == "cpu"
        wav = wav_batch([8000], seed=2)["wav"][0]
        req = urllib.request.Request(
            base + "/recognize", data=json.dumps({"wav": wav.tolist()}
                                                 ).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            body = json.loads(r.read())
        assert body["tokens"] == _direct(server.rec, wav, 64)[0]["yseq"]
        req = urllib.request.Request(base + "/stream", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_cli_builds_cpu_server():
    from tpu_asr_torch.serve import build_server
    args = parse_args(["--random-init", "--seed", "1", "--preset",
                       "hybrid_dev", "--device", "cpu",
                       "--bucket-frames", "64", "--batch-size", "2",
                       "--max-len", "4"])
    srv = build_server(args)
    assert srv.rec.mode == "joint" and srv.rec.cfg.d_model == 64
    srv.warmup(kinds=("wav",))


def test_cli_serves_attn_rescore_over_http():
    """--mode attn_rescore on the CPU answers /recognize with the decode
    of its Recognizer; --ctc-weight reaches the rescoring."""
    from tpu_asr_torch.serve import build_server
    args = parse_args(["--random-init", "--seed", "1", "--preset",
                       "hybrid_dev", "--device", "cpu", "--mode",
                       "attn_rescore", "--beam", "3", "--ctc-weight", "0.4",
                       "--bucket-frames", "64", "--batch-size", "2",
                       "--max-len", "6"])
    srv = build_server(args)
    assert srv.rec.mode == "attn_rescore"
    assert srv.rec.beam.ctc_weight == 0.4
    srv.warmup(kinds=("wav",))
    srv.start()
    httpd = make_http_server("127.0.0.1", 0, srv)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        wav = wav_batch([8000], seed=3)["wav"][0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recognize",
            data=json.dumps({"wav": wav.tolist(), "nbest": 2}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            body = json.loads(r.read())
        want = _direct(srv.rec, wav, 64)
        assert body["tokens"] == want[0]["yseq"]
        assert [h["tokens"] for h in body["nbest"]] == \
            [h["yseq"] for h in want[:2]]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        srv.stop()


def test_ckpt_carries_use_pallas_to_the_server(tmp_path):
    """A checkpoint whose model_config.json sets use_pallas serves the
    fused forms (no CLI flag: the config carries it, as in tpu_asr);
    its decode equals a Recognizer built on that model directly."""
    from tpu_asr_torch.serve import build_server
    from tpu_asr_torch.train.checkpoints import Checkpointer
    cfg = torch_cfg(use_pallas=True)
    model = torch_model(use_pallas=True)
    ck = Checkpointer(str(tmp_path))
    ck.save_config(cfg)
    ck.save({"model": model.state_dict()}, step=1, is_best=True)
    srv = build_server(parse_args([
        "--ckpt", str(tmp_path), "--device", "cpu", "--mode", "attn_rescore",
        "--beam", "2", "--max-len", "6", "--bucket-frames", "64",
        "--batch-size", "2"]))
    assert srv.rec.cfg.attention_pallas and srv.rec.cfg.layernorm_pallas
    assert srv.rec.model.encoder.layers[0].slf_attn.use_pallas
    wav = wav_batch([8000], seed=4)["wav"][0]
    direct = Recognizer(cfg, model, mode="attn_rescore", device="cpu",
                        beam=BeamConfig(beam=2, max_len=6, ctc_weight=0.3,
                                        nbest=2))
    assert _direct(srv.rec, wav, 64) == _direct(direct, wav, 64)
