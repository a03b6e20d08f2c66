"""Serving cells: the port's AsrServer, fed waveforms by a closed loop of
clients.

Set-up builds the model with the benchmark's seeded weights, a
Recognizer in the mix's decode mode (its maxlenratio caps each
hypothesis at about the length of real speech's: random weights rarely
end one sooner) and an AsrServer with the mix's buckets, batch size and
batching window, warms it on wav batches of each bucket, and starts
`clients` client threads: each submits a waveform of the seeded pool,
waits for its answer, and submits its next one. After `lead_s` of that
traffic the window opens; it lasts `seconds`. A request counts when its
answer arrived inside the window, timed from its submit call; the rate
is the audio of those requests over the window. At the close the
clients stop submitting and every request in flight is waited for.

The check takes a sample of the requests answered in the window, drawn
from the seed and holding the longest of them, and runs the plain
reference (float32, TF32 off) on each waveform alone, once the window
has closed and the server is stopped and freed:

score_gap: the largest gap, per token of the answer (plus one for its
end), between the joint score the server reported for its 1-best and
the reference's joint score of those same tokens (frontend, encoder, CTC
head, decoder and the CTC prefix probabilities all enter it).
"""

from __future__ import annotations

import gc
import json
import threading
import time

import torch

from benchmark import harness, traffic
from benchmark.drivers.train import free, program_config, sync
from benchmark.weights import make_weights


def weights_for(cell, seed, device) -> dict:
    cfg = cell.config["model"]
    return make_weights(cell.reference.param_spec(cfg), seed, device,
                        cfg["d_model"])


class Program:
    """The system under test: a Recognizer behind an AsrServer."""

    def __init__(self, cell, seed: int, device):
        from tpu_asr_torch.decode.beam import BeamConfig
        from tpu_asr_torch.decode.recognizer import Recognizer
        from tpu_asr_torch.frontend import FrontendConfig
        from tpu_asr_torch.models import build_model
        from tpu_asr_torch.serve import AsrServer
        mix = cell.traffic
        dev = torch.device(device)
        with dev:
            model = build_model(program_config(cell.config["model"]))
        model.load_state_dict(weights_for(cell, seed, dev), strict=True)
        d = mix["decode"]
        beam = BeamConfig(beam=d["beam"], max_len=d["max_len"],
                          ctc_weight=d["ctc_weight"],
                          maxlenratio=d["maxlenratio"])
        self.rec = Recognizer(model.cfg, model, beam=beam, mode=d["mode"],
                              frontend=FrontendConfig(), device=dev)
        s = mix["server"]
        self.server = AsrServer(self.rec, bucket_frames=s["bucket_frames"],
                                batch_size=s["batch_size"],
                                window_ms=s["window_ms"], device=dev)
        self.spans = []          # (start, end, [(frames, tokens)])
        self.stretch = None      # a traced stretch asked for, and its length
        self.stretch_s = 0.0
        self.traced = threading.Event()
        self._wrap()

    def trace(self, stretch, seconds: float):
        """Ask for a traced stretch of `seconds`: the decoding thread
        starts it before its next batch and stops it after the batch
        that ends it (the profiler records the thread that starts it)."""
        self.stretch_s = seconds
        self.stretch = stretch

    def _wrap(self):
        """Time each batch the server decodes (the harness's span around
        Recognizer.decode_batch_nbest), keep its rows' lengths, and run
        an asked-for traced stretch on the decoding thread."""
        from torch.profiler import record_function
        inner = self.rec.decode_batch_nbest

        def timed(batch):
            st = self.stretch
            if st is not None and not st.running and not self.traced.is_set():
                st.start()
                self._traced_from = time.perf_counter()
            t0 = time.perf_counter()
            with record_function("decode_batch"):
                out = inner(batch)
            t1 = time.perf_counter()
            rows = [(int(n) // 160, len(nb[0]["yseq"]))
                    for n, nb in zip(batch["wav_lengths"], out) if n > 0]
            with record_function("decode_rows " + json.dumps(rows)):
                pass
            self.spans.append((t0, t1, rows))
            if st is not None and st.running and \
                    t1 - self._traced_from >= self.stretch_s:
                st.stop()
                self.traced.set()
            return out

        self.rec.decode_batch_nbest = timed

    def close(self):
        self.server.stop()
        del self.server, self.rec


class Clients:
    """A closed loop: each client submits, waits, submits again."""

    def __init__(self, server, requests, n: int, seed: int):
        self.server, self.requests = server, requests
        self.stop = threading.Event()
        self.done = []           # (request, t_submit, t_answer, nbest)
        self.errors = []         # (request, t_submit, t_fail, message)
        self.lock = threading.Lock()
        order = traffic.rng_for(seed, 3).permutation(len(requests.wavs))
        self.threads = [threading.Thread(target=self._client,
                                         args=(order[c::n],), daemon=True)
                        for c in range(n)]

    def _client(self, mine):
        k = 0
        while not self.stop.is_set():
            i = int(mine[k % len(mine)])
            k += 1
            t0 = time.perf_counter()
            try:
                nbest = self.server.submit("wav", self.requests.wavs[i],
                                           timeout=120.0)
            except (RuntimeError, TimeoutError) as e:
                with self.lock:
                    self.errors.append((i, t0, time.perf_counter(), str(e)))
                continue
            with self.lock:
                self.done.append((i, t0, time.perf_counter(), nbest))

    def start(self):
        for t in self.threads:
            t.start()

    def join(self, timeout: float):
        self.stop.set()
        end = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(end - time.perf_counter(), 0.0))
        return not any(t.is_alive() for t in self.threads)


def sample(done: list, k: int, seed: int, requests) -> list:
    """k answered requests drawn from the seed, with the longest one."""
    if len(done) <= k:
        return list(done)
    longest = max(range(len(done)),
                  key=lambda j: requests.samples[done[j][0]])
    rest = [j for j in range(len(done)) if j != longest]
    pick = traffic.rng_for(seed, 4).choice(len(rest), k - 1, replace=False)
    return [done[longest]] + [done[rest[j]] for j in sorted(pick)]


def reference_answers(cell, picked, requests, seed, device,
                      control=False, search=False):
    """For each picked request: the score the server reported for its
    1-best and the reference's score of those tokens; with search, also
    the score of the reference's own beam's 1-best. With control, the
    reference computed in float8 stands in for the server: its own
    beam's 1-best and score are the ones judged."""
    ref = cell.reference
    cfg = cell.config["model"]
    beam = cell.traffic["decode"]
    P = weights_for(cell, seed, device)
    off = ref.Dropout(0.0, torch.float32, False)
    model = ref.Model(cfg, P, ref.Precision("f32"), off)
    low = ref.Model(cfg, P, ref.Precision("fp8"), off) if control else None
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        with torch.no_grad():
            for i, _, _, nbest in picked:
                wav = torch.from_numpy(requests.wavs[i]).to(device)
                feats = ref.log_mel(wav, cell.config["frontend"])
                dec = ref.Decoded(model, feats)
                if low is not None:
                    y, served = ref.joint_beam(ref.Decoded(low, feats), beam)
                else:
                    y, served = nbest[0]["yseq"], float(nbest[0]["score"])
                row = {"served": served, "tokens": len(y),
                       "ref_of_served": ref.score_hypothesis(dec, y, beam)}
                if search:
                    best, row["ref_best"] = ref.joint_beam(dec, beam)
                    row["ref_tokens"] = len(best)
                out.append(row)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return out


def compare(rows: list) -> dict:
    """score_gap; and best_gap where the rows hold the reference's own
    search (the readings report it; it is not compared: see PERF.md)."""
    out = {"score_gap": max(abs(r["served"] - r["ref_of_served"])
                            / (r["tokens"] + 1) for r in rows)}
    if all("ref_best" in r for r in rows):
        out["best_gap"] = max(max(r["ref_best"] - r["ref_of_served"], 0.0)
                              for r in rows)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        program_cls=Program):
    from benchmark import trace as tracing
    mix = cell.traffic
    requests = traffic.make_requests(mix, seed, device)
    prog = program_cls(cell, seed, device)
    prog.server.start()
    prog.server.warmup(kinds=("wav",))
    clients = Clients(prog.server, requests, mix["clients"], seed)
    stretch = tracing.Stretch(device) if trace else None
    if trace:
        tracing.warm_profiler(device)
    clients.start()
    time.sleep(mix["lead_s"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    stats0 = dict(prog.server.stats)
    t0 = time.perf_counter()
    if trace:
        time.sleep(0.4 * seconds)
        prog.trace(stretch, mix["traced_s"])
        if not prog.traced.wait(timeout=mix["drain_s"]):
            raise RuntimeError("the server decoded nothing to trace")
    time.sleep(max(t0 + seconds - time.perf_counter(), 0.0))
    t1 = time.perf_counter()
    stats1 = dict(prog.server.stats)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not clients.join(timeout=mix["drain_s"]):
        raise RuntimeError("a client's request never came back")
    sync(device)
    in_window = [d for d in clients.done if t0 <= d[2] <= t1]
    failed = [e for e in clients.errors if t0 <= e[2] <= t1]
    audio_s = sum(requests.audio_s(d[0]) for d in in_window)
    e2e = {"setup_s": setup_s, "decode_audio_s_per_s": audio_s / (t1 - t0),
           "peak_mem_gib": peak / 2 ** 30}
    dev_info = (harness.device_info(torch, cell.chips) if cuda else
                {"platform": "cpu", "kind": "cpu", "count": 1})
    dev_info["memory_peak_bytes"] = int(max(peak,
                                            setup_peak if cuda else 0))
    spans = [s for s in prog.spans if t0 <= s[1] <= t1]
    prog.close()
    del prog
    gc.collect()
    free(device)
    picked = sample(in_window, mix["check_sample"], seed, requests)
    rows = reference_answers(cell, picked, requests, seed, device)
    numbers = compare(rows) if rows else {"score_gap": float("inf")}
    checks = [("score_gap", numbers["score_gap"], cell.limits["score_gap"])]
    out = {"attempted": len(in_window) + len(failed), "failed": len(failed),
           "checks": checks, "sample": (requests, picked),
           "correct": harness.judge(checks) and not failed}
    if trace:
        summary = stretch.summary
        lat = [d[2] - d[1] for d in in_window]
        ctx = {"kind": "serve", "config": cell.config["model"],
               "decode": mix["decode"], "window_s": t1 - t0,
               "latencies_s": lat, "stats0": stats0, "stats1": stats1,
               "spans": spans, "trace": summary,
               "answered": [(requests.samples[d[0]] // 160,
                             len(d[3][0]["yseq"])) for d in in_window]}
        out["metrics"] = cell.read_per_layer(ctx)
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["span_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end()}
    out["device"] = dev_info
    return out

