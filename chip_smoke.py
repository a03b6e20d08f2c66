#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit before the last line):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile every kernel of the serving path from tpu_asr_torch/csrc.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the serving path's shapes and at ragged ones, with timings.
  4. agreement: a small hybrid model decodes the same batch on the card and
     on the CPU (plain versions); tokens must be equal.
  5. serving: the aishell-width hybrid model (d512, h8, 6+6 layers, conv
     (32, 128), vocab 4233, bf16; random weights from a seed) in joint
     CTC/attention beam-5 mode behind AsrServer; 16 wav requests from
     several threads (then the same again under torch.profiler, whose
     table of device time by kernel is printed), then one greedy_ctc
     batch. The kernels' launch counts must show the path went through
     them.
  6. HTTP: POST /recognize one wav through make_http_server.
Then one JSON line per the kernels, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"
PRESET = "aishell"            # the flagship model's widths
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
TOL = dict(atol=1e-4, rtol=1e-5)
BUCKETS = (512, 1000)
BATCH = 8
N_REQUESTS = 16


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---- phase 3: ctc_prefix_scan vs its plain version ----

def prefix_scan_inputs(n, t, k, lengths, gen):
    """Inputs shaped like the joint beam's: log-probs for x_cand/x_blank,
    phi with NEG_INF entries (repeated-symbol candidates), empty-prefix
    inits."""
    from tpu_asr_torch.ops.ctc_prefix import NEG_INF
    dev = "cuda"
    logp = torch.log_softmax(torch.randn(n, t, k + 1, generator=gen), -1)
    x_cand = logp[..., 1:].contiguous()
    x_blank = logp[..., 0].contiguous()
    phi = torch.log_softmax(torch.randn(n, t, k, generator=gen), -1)
    phi[:, :, 0] = NEG_INF
    first = torch.rand(n, generator=gen) < 0.5
    r_nb0 = torch.where(first[:, None], x_cand[:, 0], NEG_INF)
    r_b0 = torch.full((n, k), NEG_INF)
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    return [x.to(dev).contiguous() for x in
            (x_cand, phi, x_blank, r_nb0, r_b0, r_nb0.clone(), lens)]


def compare(got, want, what):
    """allclose after clipping to >= -1e31 (as the reference's tests do);
    returns the max abs error over entries of real probability (> -1e29),
    since entries at NEG_INF differ by float ulps of 1e30."""
    g = torch.clamp(got, min=-1e31)
    w = torch.clamp(want, min=-1e31)
    if not torch.allclose(g, w, **TOL):
        bad = (g - w).abs().max().item()
        raise AssertionError(f"{what}: kernel disagrees with plain version "
                             f"(max abs diff {bad})")
    live = (g > -1e29) & (w > -1e29)
    return (g - w).abs()[live].max().item() if live.any() else 0.0


def prefix_scan_bound_ms(n, t, k, lengths, hist: bool):
    """Least time for the same work on an H100: bytes each input read once
    for the frames this data needs, each output written once; operations
    ~27 float ops per active (chain, frame) step (3 logaddexp + adds)."""
    active = int(np.minimum(np.asarray(lengths), t).sum())
    steps = int(np.maximum(np.minimum(np.asarray(lengths), t) - 1, 0).sum())
    read = 4 * (2 * active * k + active + 3 * n * k + n)
    write = 4 * (n * k + (2 * n * t * k if hist else 0))
    bytes_ms = (read + write) / HBM_BYTES_PER_S * 1e3
    ops_ms = 27 * steps * k / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_prefix_scan(gen):
    from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                              ctc_prefix_scan_reference)
    cases = [  # (n, t, k, lengths): the path's two buckets, then ragged
        (40, 249, 11, [249] * 40),
        (40, 127, 11, [127] * 40),
        (40, 249, 11, list(np.random.default_rng(1).integers(1, 250, 40))),
        (13, 9, 21, [1, 9, 5, 2, 9, 3, 7, 1, 8, 6, 4, 9, 2]),
        (3, 1, 11, [1, 1, 0]),
        (2, 5, 130, [5, 3]),
    ]
    max_err, timings = 0.0, {}
    for n, t, k, lengths in cases:
        args = prefix_scan_inputs(n, t, k, lengths, gen)
        for hist in (True, False):
            got = ctc_prefix_scan(*args, return_hist=hist)
            want = ctc_prefix_scan_reference(*args, return_hist=hist)
            torch.cuda.synchronize()
            for name, g, w in zip(("psi", "nb_hist", "b_hist"), got, want):
                if g is None and w is None:
                    continue
                err = compare(g, w, f"{name} at N={n} T={t} K={k} "
                                    f"hist={hist}")
                max_err = max(max_err, err)
            if lengths == [t] * n:      # the path's shapes: time them
                ms = cuda_ms(lambda: ctc_prefix_scan(*args, return_hist=hist))
                plain = cuda_ms(lambda: ctc_prefix_scan_reference(
                    *args, return_hist=hist), reps=20, warmup=1)
                bound, by = prefix_scan_bound_ms(n, t, k, lengths, hist)
                timings[(t, hist)] = dict(ms=ms, plain_ms=plain,
                                          bound_ms=bound, bound_by=by)
                log(f"ctc_prefix_scan N={n} T={t} K={k} hist={hist}: "
                    f"kernel {ms:.4f} ms, plain {plain:.3f} ms, "
                    f"bound {bound * 1e3:.3f} us ({by})")
    log(f"ctc_prefix_scan vs plain: {len(cases) * 2} cases agree, "
        f"max abs err {max_err:.3e} (atol {TOL['atol']}, rtol "
        f"{TOL['rtol']})")
    return max_err, timings


# ---- phases 4-6 ----

def request_lengths(n, seed):
    """Utterance lengths in samples: lognormal around 4.3 s, clipped to
    [2.5 s, 10 s] (AISHELL-1-like, as the reference bench draws them)."""
    rng = np.random.default_rng(seed)
    frames = np.clip(np.exp(rng.normal(np.log(430.0), 0.35, n)), 250, 1000)
    return (frames.astype(np.int64) * 160).tolist()


def synth_wav(n_samples, rng):
    t = np.arange(n_samples) / 16000.0
    f0 = rng.uniform(100, 300)
    wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(
        n_samples)
    return wav.astype(np.float32)


def check_agreement():
    """Small f32 hybrid model: joint decode on the card (kernel) and on
    the CPU (plain scan) give the same tokens."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64)
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    batch = {"wav": wav, "wav_lengths": lens}
    out = {}
    for dev in ("cuda", "cpu"):
        rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                         mode="joint", device=dev,
                         beam=BeamConfig(beam=4, max_len=12, ctc_weight=0.3,
                                         nbest=4))
        out[dev] = rec.decode_batch_nbest(batch)
    for a, b in zip(out["cuda"], out["cpu"]):
        for ha, hb in zip(a, b):
            if ha["yseq"] != hb["yseq"] or abs(ha["score"]
                                               - hb["score"]) > 1e-3:
                raise AssertionError(f"card and CPU decodes differ: {ha} "
                                     f"vs {hb}")
    log("agreement: hybrid_dev joint beam-4 on the card == on the CPU "
        "(tokens equal, scores within 1e-3)")


def profile_serving(server, wavs, card):
    """The same requests again under torch.profiler (not counted above):
    device time by kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda w: server.submit("wav", w, timeout=600.0),
                          wavs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    avg = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in avg)
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:20]
    log(f"profile: wall {wall * 1e3:.1f} ms (profiler on), device busy "
        f"{busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}% [{card}]")
    for e in top:
        log(f"profile:   {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.3f}"
            f" ms  x{e.count}")


def run_serving(card):
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops.ctc_prefix import ctc_prefix_scan
    from tpu_asr_torch.serve import AsrServer, make_http_server
    from tpu_asr_torch.weights import init_random

    cfg = get_preset(PRESET).model
    v = cfg.vocab_size
    t0 = time.perf_counter()
    model = init_random(Transformer(cfg), SEED)
    rec = Recognizer(cfg, model, mode="joint", device=DEVICE,
                     beam=BeamConfig(beam=5, max_len=40, ctc_weight=0.3))
    server = AsrServer(rec, bucket_frames=BUCKETS, batch_size=BATCH,
                       device=DEVICE)
    server.warmup(kinds=("wav",))
    torch.cuda.synchronize()
    log(f"serving: {PRESET} model (d{cfg.d_model}, h{cfg.num_heads}, "
        f"{cfg.num_enc_layers}+{cfg.num_dec_layers} layers, conv "
        f"{cfg.conv_channels}, vocab {v}, {cfg.dtype}) built and warmed up "
        f"in {time.perf_counter() - t0:.1f} s")
    server.start()

    rng = np.random.default_rng(SEED)
    wavs = [synth_wav(n, rng) for n in request_lengths(N_REQUESTS, SEED)]
    audio_s = sum(len(w) for w in wavs) / 16000.0

    def one(wav):
        start = time.perf_counter()
        nbest = server.submit("wav", wav, timeout=600.0)
        return nbest, time.perf_counter() - start

    # main path: counts from 0 just before, read just after
    ctc_prefix_scan.launches = 0
    rec.decode_steps = 0
    wall0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        results = list(pool.map(one, wavs))
    wall = time.perf_counter() - wall0
    launches, steps = ctc_prefix_scan.launches, rec.decode_steps

    for nbest, _ in results:
        toks = nbest[0]["yseq"]
        if not all(0 <= x <= v - 3 for x in toks):
            raise AssertionError(f"token outside [0, {v - 3}]: {toks}")
    if steps <= 0 or launches < steps:
        raise AssertionError(f"ctc_prefix_scan launched {launches} times in "
                             f"{steps} decode steps")
    lat = sorted(dt for _, dt in results)
    log(f"serving: {N_REQUESTS} requests ({audio_s:.1f} s of audio) in "
        f"{wall:.3f} s; {server.stats['batches']} batches, {steps} decode "
        f"steps, {launches} ctc_prefix_scan launches; latency p50 "
        f"{statistics.median(lat) * 1e3:.1f} ms, max {lat[-1] * 1e3:.1f} ms; "
        f"inverse RTF {audio_s / wall:.2f} [{card}]")
    log("serving: first hypotheses " + json.dumps(
        [r[0][0]["yseq"][:8] for r in results[:3]]))
    profile_serving(server, wavs, card)

    # greedy_ctc: one batch straight through a second Recognizer
    greedy = Recognizer(cfg, model, mode="greedy_ctc", device=DEVICE)
    batch_wav = np.zeros((BATCH, BUCKETS[-1] * 160), np.float32)
    lens = np.zeros(BATCH, np.int32)
    for i, w in enumerate(wavs[:BATCH]):
        batch_wav[i, :len(w)] = w
        lens[i] = len(w)
    g0 = time.perf_counter()
    hyps = greedy.decode_batch_nbest({"wav": batch_wav, "wav_lengths": lens})
    g_wall = time.perf_counter() - g0
    if len(hyps) != BATCH or not all(
            0 <= x <= v - 2 for h in hyps for x in h[0]["yseq"]):
        raise AssertionError(f"greedy_ctc output malformed: {hyps[:2]}")
    log(f"greedy_ctc: one batch of {BATCH} in {g_wall * 1e3:.1f} ms; "
        f"{sum(len(h[0]['yseq']) for h in hyps)} tokens [{card}]")

    # HTTP: one request through the real front end
    httpd = make_http_server("127.0.0.1", 0, server)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize"
        req = urllib.request.Request(
            url, data=json.dumps({"wav": wavs[0].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
        if status != 200 or "tokens" not in body:
            raise AssertionError(f"/recognize answered {status}: {body}")
        if body["tokens"] != results[0][0][0]["yseq"]:
            raise AssertionError("/recognize disagrees with submit()")
        log(f"http: POST /recognize -> 200, {len(body['tokens'])} tokens")
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(timeout=10)
        server.stop()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from tpu_asr_torch.ops.ctc_prefix import LIBRARY

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    LIBRARY.load()
    log(f"build: ctc_prefix_scan in {time.perf_counter() - t0:.2f} s")
    if LIBRARY.build_log:
        log(LIBRARY.build_log.strip())

    gen = torch.Generator().manual_seed(SEED)
    max_err, timings = check_prefix_scan(gen)
    check_agreement()
    launches = run_serving(card)

    main_t = timings[(249, True)]          # 1000-frame bucket, one-pass
    log(json.dumps({"kernels": [{
        "name": "ctc_prefix_scan",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/ctc_prefix_scan.cu",
        "replaces": "tpu_asr/ops/pallas/ctc_prefix.py:114",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "kernel_ms": main_t["ms"],
        "bound_us": main_t["bound_ms"] * 1e3,
        "shape": "N=40 T=249 K=11 with histories",
        "other_shapes": {f"T={t} hist={h}": v for (t, h), v
                         in timings.items() if (t, h) != (249, True)},
    }]}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
