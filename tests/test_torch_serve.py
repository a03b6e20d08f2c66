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
