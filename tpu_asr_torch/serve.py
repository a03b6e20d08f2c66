"""Model server: dynamic micro-batching onto static bucket shapes, and
streaming sessions (port of tpu_asr/serve.py).

- requests enqueue; a collector thread drains up to `batch_size` of them,
  waiting at most `window_ms` after the first arrival;
- each request gets the smallest static frame bucket that fits;
- per (input kind, bucket) group, requests are padded into ONE fixed
  [batch_size, T(, D)] batch (absent rows are length-0 dummies) and
  decoded together.

`AsrServer.stats` counts requests, batches and rows decoded, and sums
each request's wait from `submit` to the start of its group's decode
(`queue_wait_s`: the collection window and the groups decoded first),
the groups' decode time (`decode_s`) and the recognizer's decode steps
(`beam_steps`) and those of them replayed from a CUDA graph
(`beam_graph_steps`); GET /healthz shows them.

A decode failure is caught on the collector thread (which must keep
serving), stored on each request of the batch, and raised to the
submitter as RuntimeError.

/stream sessions (StreamSessions) ride the streaming recognizers
(decode/streaming.py): each session's state lives on the host, its
chunk steps run on the server's device, and the model is shared.

Run as a module to serve over HTTP:

  python -m tpu_asr_torch.serve --random-init --seed 0 --mode joint \\
      --beam 5 --bucket-frames 512,1000 --batch-size 8 --port 8080
  python -m tpu_asr_torch.serve --ckpt exp/aishell --mode attn_rescore \\
      --beam 10 --dict dict.txt --lm-ckpt exp/lm --lm-weight 0.3
  python -m tpu_asr_torch.serve --random-init --preset cif --mode cif_greedy
  python -m tpu_asr_torch.serve --random-init --preset whisper_large_v3 \\
      --beam 5 --bucket-frames 3000 --batch-size 32 --inputs wav
  python -m tpu_asr_torch.serve --ckpt exp/transducer \\
      --mode transducer_rescore --beam 10 --ctc-weight 0.5
  python -m tpu_asr_torch.serve --ckpt exp/streaming --stream-beam 5
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import sys
import threading
import time
from collections import OrderedDict

import numpy as np

from tpu_asr_torch.frontend import FrontendConfig
from tpu_asr_torch.utils.device import resolve_device


class UtteranceTooLong(ValueError):
    """Input exceeds the longest configured frame bucket (HTTP 413)."""


class SessionExpired(ValueError):
    """A push to a stream session that already finished or was closed for
    idling (HTTP 410): restarting its hypothesis mid-stream would corrupt
    the client's transcript."""


@dataclasses.dataclass
class _Request:
    kind: str                      # "feats" | "wav"
    data: np.ndarray               # [T, D] f32 | [S] f32
    bucket: int
    nbest: int
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: list | None = None
    error: str | None = None
    cancelled: bool = False        # submitter timed out: drop, don't decode
    t_submit: float | None = None  # perf_counter at submit; None: warm-up


class AsrServer:
    """Micro-batching wrapper around a Recognizer.

    recognizer: tpu_asr_torch.decode.recognizer.Recognizer.
    bucket_frames: ascending static feature-frame buckets.
    batch_size: static rows per decoded batch (and the max micro-batch).
    window_ms: max wait after the first queued request.
    device: where the server decodes; None means the CUDA card and raises
        when there is none. It must be the recognizer's device.
    """

    def __init__(self, recognizer, bucket_frames=(512, 1000), batch_size=8,
                 window_ms=15.0, device=None):
        device = resolve_device(device)
        if recognizer.device != device:
            raise ValueError(f"recognizer runs on {recognizer.device}, "
                             f"server asked for {device}")
        self.rec = recognizer
        self.device = device
        self.bucket_frames = tuple(sorted(bucket_frames))
        self.batch_size = int(batch_size)
        self.window_s = float(window_ms) / 1000.0
        self.frontend = getattr(recognizer, "frontend", None) or \
            FrontendConfig()
        self.d_input = recognizer.cfg.d_input
        self._q: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="asr-batcher")
        self.stats = {"requests": 0, "batches": 0, "rows_decoded": 0,
                      "queue_wait_s": 0.0, "decode_s": 0.0,
                      "beam_steps": 0, "beam_graph_steps": 0}

    # --- lifecycle ---

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)

    def warmup(self, kinds=("feats", "wav")):
        """Decode one dummy batch per (kind, bucket) before taking
        traffic (first-use kernel build, cuBLAS handles, allocator, the
        beam step's CUDA graph of each bucket), then zero every counter
        of `stats`. The longest bucket goes first, so that the graphs'
        shared buffers take their largest size at once."""
        for kind in kinds:
            for b, t in reversed(list(enumerate(self.bucket_frames))):
                self._decode_group(kind, b, [self._dummy_request(kind, b, t)])
        self.stats.update(dict.fromkeys(self.stats, 0))

    def _dummy_request(self, kind, bucket, t):
        if kind == "feats":
            data = np.zeros((t, self.d_input), np.float32)
        else:
            data = np.zeros((t * self.frontend.frame_shift,), np.float32)
        return _Request(kind=kind, data=data, bucket=bucket, nbest=1)

    # --- submission ---

    def _bucket_for(self, n_frames: int) -> int | None:
        for i, t in enumerate(self.bucket_frames):
            if n_frames <= t:
                return i
        return None

    def submit(self, kind: str, data: np.ndarray, nbest: int = 1,
               timeout: float = 60.0) -> list[dict]:
        """Blocking decode of one utterance; thread-safe.

        kind="feats": data [T, d_input] float32 log-mel frames.
        kind="wav":   data [S] float32 samples at frontend.sample_rate.
        Returns the n-best list [{'yseq': [...], 'score': ...}, ...];
        raises RuntimeError when the batch's decode failed.
        """
        data = np.asarray(data, np.float32)
        if kind == "feats":
            if data.ndim != 2 or data.shape[1] != self.d_input:
                raise ValueError(
                    f"feats must be [T, {self.d_input}], got {data.shape}")
            frames = data.shape[0]
        elif kind == "wav":
            if data.ndim != 1:
                raise ValueError(f"wav must be [S], got {data.shape}")
            frames = data.shape[0] // self.frontend.frame_shift
        else:
            raise ValueError(f"unknown input kind {kind!r}")
        if frames < 1:
            raise ValueError("empty utterance")
        bucket = self._bucket_for(frames)
        if bucket is None:
            raise UtteranceTooLong(
                f"utterance is ~{frames} frames; longest bucket is "
                f"{self.bucket_frames[-1]}")
        req = _Request(kind=kind, data=data, bucket=bucket, nbest=nbest,
                       t_submit=time.perf_counter())
        self._q.put(req)
        if not req.event.wait(timeout):
            req.cancelled = True
            raise TimeoutError("decode timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    # --- collector ---

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_s
            cap = self.batch_size * max(2, len(self.bucket_frames))
            while len(batch) < cap:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            groups: dict[tuple[str, int], list[_Request]] = {}
            for r in batch:
                groups.setdefault((r.kind, r.bucket), []).append(r)
            for (kind, bucket), reqs in groups.items():
                for s in range(0, len(reqs), self.batch_size):
                    chunk = [r for r in reqs[s: s + self.batch_size]
                             if not r.cancelled]
                    if not chunk:
                        continue
                    try:
                        self._decode_group(kind, bucket, chunk)
                    except Exception as e:  # surface, don't kill the loop
                        for r in chunk:
                            r.error = f"{type(e).__name__}: {e}"
                    finally:
                        for r in chunk:
                            r.event.set()

    def _decode_group(self, kind: str, bucket: int, reqs: list[_Request]):
        """Pad a group into the bucket's STATIC [batch_size, ...] shape and
        decode it; absent rows are length-0 dummies."""
        t0 = time.perf_counter()
        t = self.bucket_frames[bucket]
        b = self.batch_size
        if kind == "feats":
            arr = np.zeros((b, t, self.d_input), np.float32)
        else:
            arr = np.zeros((b, t * self.frontend.frame_shift), np.float32)
        lens = np.zeros((b,), np.int32)
        for i, r in enumerate(reqs):
            arr[i, : r.data.shape[0]] = r.data
            lens[i] = r.data.shape[0]
        batch = ({"feats": arr, "feat_lengths": lens} if kind == "feats"
                 else {"wav": arr, "wav_lengths": lens})
        steps0, graphed0 = self.rec.decode_steps, self.rec.graph_steps
        nbest = self.rec.decode_batch_nbest(batch)
        for r, nb in zip(reqs, nbest):
            r.result = nb[: max(r.nbest, 1)]
        self.stats["requests"] += len(reqs)
        self.stats["batches"] += 1
        self.stats["rows_decoded"] += b
        self.stats["queue_wait_s"] += sum(t0 - r.t_submit for r in reqs
                                          if r.t_submit is not None)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["beam_steps"] += self.rec.decode_steps - steps0
        self.stats["beam_graph_steps"] += self.rec.graph_steps - graphed0


class StreamSessions:
    """Per-session incremental decoding for the /stream endpoint.

    A session owns a StreamingCTCRecognizer (beam 1),
    StreamingCTCBeamRecognizer (beam > 1) or, for a transducer,
    StreamingTransducerRecognizer. A push returns the newly final tokens
    (greedy, transducer) or the current 1-best (beam). model: the port's
    Transformer or TransducerModel, shared by the sessions and moved to
    `device` (None: the CUDA card; RuntimeError without one).

    The global lock guards only the session map and the ring of closed
    ids; a per-session lock serializes that session's decode, so
    independent sessions overlap."""

    def __init__(self, cfg, model, beam: int = 1, max_frames: int = 3000,
                 idle_timeout_s: float = 300.0, device=None):
        self.cfg, self.model = cfg, model
        self.beam, self.max_frames = beam, max_frames
        self.idle_timeout_s = idle_timeout_s
        self.device = resolve_device(device)
        # session -> [recognizer, session lock, last touch, finished]
        self._sessions: dict[str, list] = {}
        self._lock = threading.Lock()
        # ids that finished or idled out, so that a late push gets
        # SessionExpired; a bounded ring (an OrderedDict as LRU)
        self._closed: OrderedDict[str, str] = OrderedDict()
        self._closed_cap = 4096

    def _new_recognizer(self):
        from tpu_asr_torch.decode.streaming import make_streaming_recognizer
        return make_streaming_recognizer(self.cfg, self.model, self.beam,
                                         max_frames=self.max_frames,
                                         device=self.device)

    def _close(self, session_id: str, reason: str):
        """Caller holds self._lock."""
        self._sessions.pop(session_id, None)
        self._closed[session_id] = reason
        self._closed.move_to_end(session_id)
        while len(self._closed) > self._closed_cap:
            self._closed.popitem(last=False)

    def _gc(self, now: float):
        """Caller holds self._lock."""
        dead = [k for k, (_, _, ts, _) in self._sessions.items()
                if now - ts > self.idle_timeout_s]
        for k in dead:
            self._close(k, "expired")

    def push(self, session_id: str, feats, final: bool = False) -> dict:
        """feats: [t, d_input] newly arrived frames (may be empty with
        final=True, to flush) -> {"new_tokens", "tokens", "final"}, with
        "times" and "confidence" where the recognizer gives them.

        Raises SessionExpired for an id that already finished or idled
        out. The decode runs under the session's lock only."""
        now = time.monotonic()
        with self._lock:
            self._gc(now)
            entry = self._sessions.get(session_id)
            if entry is None:
                if session_id in self._closed:
                    raise SessionExpired(
                        f"session {session_id!r} already "
                        f"{self._closed[session_id]}; start a new session "
                        f"id (the partial hypothesis was discarded)")
                entry = [self._new_recognizer(), threading.Lock(), now,
                         False]
                self._sessions[session_id] = entry
            entry[2] = now
        rec, slock = entry[0], entry[1]
        with slock:
            # a concurrent final push may have finished the recognizer
            # while this one waited on the session lock
            if entry[3]:
                raise SessionExpired(
                    f"session {session_id!r} already finished; start a new "
                    f"session id (the partial hypothesis was discarded)")
            feats = np.asarray(feats, np.float32).reshape(-1,
                                                          self.cfg.d_input)
            new = rec.push(feats) if feats.shape[0] else []
            if final:
                tokens = rec.finish()
                entry[3] = True
            else:
                tokens = getattr(rec, "hypothesis", None)
            resp = {"new_tokens": new, "tokens": tokens, "final": final}
            if hasattr(rec, "hypothesis_times"):
                resp["times"] = rec.hypothesis_times
                resp["confidence"] = rec.hypothesis_confidence
        if final:
            with self._lock:
                self._close(session_id, "finished")
        return resp

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._sessions)


def streams_supported(cfg) -> bool:
    """The reference's rule for serving /stream: the conv2d front-end and
    a CTC head (ctc, hybrid) or a chunked transducer."""
    return cfg.input_layer == "conv2d" and (
        cfg.model_type in ("ctc", "hybrid")
        or (cfg.model_type == "transducer" and cfg.enc_chunk_size > 0))


def make_http_server(host: str, port: int, server: AsrServer,
                     char_list: list[str] | None = None,
                     streams: StreamSessions | None = None):
    """stdlib ThreadingHTTPServer with three endpoints:

    GET  /healthz    -> model/server info + stats (+ "streaming",
                        "active_streams")
    POST /recognize  -> {"feats": [[...]]} | {"wav": [...]} (+ "nbest": k)
                        -> n-best hypotheses
    POST /stream     -> {"session": id, "feats": [[...]], "final": bool}
                        -> incremental tokens (400 without `streams`,
                        410 for a finished or expired session)
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def ids_to_text(ids):
        if not char_list:
            return None
        return "".join(char_list[i] if 0 <= i < len(char_list) else "<unk>"
                       for i in ids)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: the body follows the headers in a second write, which
        # Nagle's algorithm would hold until the client's delayed ACK
        disable_nagle_algorithm = True

        def log_message(self, *a):      # quiet: stats live in /healthz
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {
                "status": "ok",
                "mode": server.rec.mode,
                "model_type": server.rec.cfg.model_type,
                "device": str(server.device),
                "bucket_frames": list(server.bucket_frames),
                "batch_size": server.batch_size,
                "window_ms": server.window_s * 1000.0,
                "streaming": streams is not None,
                "active_streams": streams.n_active if streams else 0,
                "stats": dict(server.stats),
            })

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad json: {e}"})
            if self.path == "/recognize":
                return self._recognize(req)
            if self.path == "/stream":
                return self._stream(req)
            return self._json(404, {"error": "not found"})

        def _recognize(self, req: dict):
            if ("feats" in req) == ("wav" in req):
                return self._json(
                    400, {"error": "send exactly one of 'feats'/'wav'"})
            kind = "feats" if "feats" in req else "wav"
            try:
                nb = server.submit(kind, np.asarray(req[kind], np.float32),
                                   nbest=int(req.get("nbest", 1)))
            except UtteranceTooLong as e:
                return self._json(413, {"error": str(e)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except TimeoutError as e:
                return self._json(503, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            out = [{"tokens": h["yseq"], "score": h["score"],
                    "text": ids_to_text(h["yseq"])} for h in nb]
            return self._json(200, {"nbest": out, "tokens": out[0]["tokens"],
                                    "text": out[0]["text"]})

        def _stream(self, req: dict):
            if streams is None:
                return self._json(400, {"error": "streaming disabled "
                                        "(--no-streaming or the model "
                                        "cannot stream)"})
            sid = req.get("session")
            if not sid:
                return self._json(400, {"error": "missing 'session'"})
            try:
                out = streams.push(sid, req.get("feats", []),
                                   final=bool(req.get("final", False)))
            except SessionExpired as e:
                return self._json(410, {"error": str(e), "expired": True})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            if out.get("tokens") is not None:
                out["text"] = ids_to_text(out["tokens"])
            return self._json(200, out)

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd


# --- command line ---

def parse_args(argv=None):
    from tpu_asr_torch.decode.recognizer import MODES
    p = argparse.ArgumentParser(
        prog="python -m tpu_asr_torch.serve",
        description="Serve the PyTorch port over HTTP (/healthz, "
                    "/recognize, /stream) with micro-batched decode.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--params-npz",
                     help="flax params of the preset's tpu_asr model "
                          "(Transformer, CifModel or TransducerModel) saved "
                          "as .npz with '/'-joined keys")
    src.add_argument("--random-init", action="store_true",
                     help="seeded random weights (no checkpoint)")
    src.add_argument("--ckpt",
                     help="checkpoint folder of python -m tpu_asr_torch."
                          "train: its config, frontend and best step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", default="aishell",
                   help="model preset (aishell | hybrid | hybrid_dev | "
                        "attention | ctc_dev | conformer | conformer_dev | "
                        "cif | cif_dev | transducer | transducer_dev | "
                        "conformer_transducer | conformer_transducer_dev "
                        "| transducer_streaming | streaming | "
                        "whisper_large_v3 | whisper_dev), with its "
                        "frontend; not read with --ckpt")
    p.add_argument("--mode", default=None, choices=MODES,
                   help="default: by model type (hybrid -> joint, "
                        "transformer -> beam, ctc -> greedy_ctc, cif -> "
                        "cif_greedy, transducer -> transducer_greedy)")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-len", type=int, default=100)
    p.add_argument("--maxlenratio", type=float, default=0.0,
                   help="per-utterance max decode length = ratio * encoder "
                        "length; 0 = --max-len only")
    p.add_argument("--ctc-weight", type=float, default=0.3,
                   help="CTC weight of joint, attn_rescore and "
                        "transducer_rescore")
    p.add_argument("--lm-ckpt", default="",
                   help="LM folder of python -m tpu_asr_torch.train_lm for "
                        "shallow fusion (beam, joint, ctc_beam, "
                        "transducer_beam) or n-best rescoring (attn_rescore)")
    p.add_argument("--lm-weight", type=float, default=0.3,
                   help="LM score weight (only with --lm-ckpt)")
    p.add_argument("--dict", dest="dict_path", default="",
                   help="token dict file -> 'text' fields in responses")
    p.add_argument("--restore", default="best", choices=["best", "latest"],
                   help="with --ckpt: which step when --step is -1")
    p.add_argument("--step", type=int, default=-1,
                   help="with --ckpt: the checkpoint step (-1 = --restore)")
    p.add_argument("--bucket-frames", default="512,1000",
                   help="comma-separated static frame buckets")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--window-ms", type=float, default=15.0)
    p.add_argument("--inputs", default="feats,wav",
                   help="input kinds to warm up (feats,wav)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--stream-beam", type=int, default=1,
                   help="beam of /stream sessions (1 = greedy CTC)")
    p.add_argument("--no-streaming", action="store_true",
                   help="no /stream endpoint (else on for a conv2d "
                        "ctc/hybrid model or a chunked transducer)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_server(args) -> AsrServer:
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import CTC_WEIGHT_MODES, Recognizer
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.lm import load_lm
    from tpu_asr_torch.recognize import DEFAULT_MODES, restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.weights import init_random, load_jax_params

    device = resolve_device(args.device)
    frontend = FrontendConfig()
    if args.ckpt:
        ck = Checkpointer(args.ckpt)
        cfg = ck.load_config()
        frontend = ck.load_frontend() or frontend
        model = build_model(cfg)
        model.load_state_dict(ck.restore(restore_step(
            ck, args.step, args.restore))["model"])
    else:
        preset = get_preset(args.preset)
        cfg, frontend = preset.model, preset.frontend
        model = build_model(cfg)
        if args.params_npz:
            load_jax_params(model, args.params_npz)
        else:
            init_random(model, args.seed)
    mode = args.mode or DEFAULT_MODES[cfg.model_type]
    lm = load_lm(args.lm_ckpt) if args.lm_ckpt else None
    rec = Recognizer(
        cfg, model, mode=mode, device=device, frontend=frontend,
        lm_cfg=None if lm is None else lm.cfg, lm=lm,
        beam=BeamConfig(beam=args.beam, max_len=args.max_len,
                        nbest=args.beam,   # requests slice their own nbest
                        maxlenratio=args.maxlenratio,
                        ctc_weight=args.ctc_weight
                        if mode in CTC_WEIGHT_MODES else 0.0,
                        lm_weight=args.lm_weight if lm is not None
                        else 0.0))
    buckets = tuple(int(x) for x in args.bucket_frames.split(","))
    return AsrServer(rec, bucket_frames=buckets, batch_size=args.batch_size,
                     window_ms=args.window_ms, device=device)


def build_streams(args, server: AsrServer) -> StreamSessions | None:
    """/stream sessions on the server's model and device, or None with
    --no-streaming or a model that cannot stream (streams_supported)."""
    cfg = server.rec.cfg
    if args.no_streaming or not streams_supported(cfg):
        return None
    return StreamSessions(cfg, server.rec.model, beam=args.stream_beam,
                          device=server.device)


def load_char_list(args) -> list[str] | None:
    """The --dict file's tokens, by id (None without --dict): what
    make_http_server turns hypotheses into text with."""
    if not args.dict_path:
        return None
    from tpu_asr_torch.utils.vocab import Vocab
    return Vocab.load(args.dict_path).tokens


def main(argv=None):
    args = parse_args(argv)
    server = build_server(args)
    kinds = tuple(k.strip() for k in args.inputs.split(",") if k.strip())
    print(f"warming up {len(kinds)}x{len(server.bucket_frames)} decode "
          f"shapes on {server.device} (mode={server.rec.mode}, "
          f"batch={args.batch_size})...", file=sys.stderr, flush=True)
    server.warmup(kinds=kinds)
    server.start()
    streams = build_streams(args, server)
    httpd = make_http_server(args.host, args.port, server,
                             load_char_list(args), streams)
    print(json.dumps({"serving": f"http://{args.host}:{args.port}",
                      "mode": server.rec.mode,
                      "device": str(server.device),
                      "buckets": list(server.bucket_frames),
                      "batch_size": args.batch_size,
                      "streaming": streams is not None}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
