#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit before the last line):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile every kernel from tpu_asr_torch/csrc (one nvcc per
     source, all at once) and print nvcc's -Xptxas -v report.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes and at ragged ones, with timings:
     ctc_prefix_scan (serving) and the CTC loss pair ctc_loss_fwd /
     ctc_loss_bwd (training), the latter also beside torch's own CTC loss
     (F.ctc_loss, timed as a yardstick and used as a value check only).
  4. agreement: a small hybrid model decodes the same batch on the card and
     on the CPU (plain versions), tokens equal; and takes two train steps
     from the same init on one batch on both: losses of both steps within
     1e-4, step 1's grad norms within 1e-3 relative, and >= 99% of the
     entries of step 1's update within 0.1 lr.
  5. serving: the aishell-width hybrid model (d512, h8, 6+6 layers, conv
     (32, 128), vocab 4233, bf16; random weights from a seed) in joint
     CTC/attention beam-5 mode behind AsrServer; 16 wav requests from
     several threads (then the same again under torch.profiler, whose
     table of device time by kernel is printed), then one greedy_ctc
     batch. The kernels' launch counts must show the path went through
     them.
  6. HTTP: POST /recognize one wav through make_http_server.
  7. training: the aishell preset at full width (dropout 0.1, SpecAugment,
     Noam/Adam, clip 5, 32000-frame batches) through the Solver that
     `python -m tpu_asr_torch.train` builds, on 512 synthetic AISHELL-like
     wav utterances, for at least 20 optimizer steps; losses and grad norms
     finite, the CTC kernels launched once per step (forward also once per
     cv batch); step times, throughput, peak memory; a few steps under
     torch.profiler; 20 steps at the fixed shape feats [32, 1000, 80],
     U = 24; the epoch checkpoint restores to equal parameters.
Then one JSON line for the kernels, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
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
CTC_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
MIN_TRAIN_STEPS = 20
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


# ---- phase 3: the CTC loss kernels vs their plain versions ----

def ctc_case(b, t, u, ilens, llens, v, seed):
    """Lattice inputs on the card: emissions gathered from random logits
    for random labels (row 0 repeats a label, so a skip is barred)."""
    from tpu_asr_torch.ops.ctc import (_interleave_blanks, lattice_emissions,
                                       lattice_masks)
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(b, t, v, generator=g)
    labels = torch.randint(2, v - 2, (b, u), generator=g)
    if u >= 2:
        labels[0, 1] = labels[0, 0]
    z = _interleave_blanks(labels.to(DEVICE), 0)
    llen = torch.as_tensor(llens, dtype=torch.int32, device=DEVICE)
    skip, valid = lattice_masks(z, llen)
    emissions = lattice_emissions(logits.to(DEVICE), z).contiguous()
    ilen = torch.as_tensor(ilens, dtype=torch.int32, device=DEVICE)
    return emissions, skip, valid, ilen, llen


def ctc_bound_ms(b, t, s, ilens, backward: bool):
    """Least time for the same work on an H100. Bytes: E (and, backward,
    alpha) read for the frames this data needs, the masks and lengths
    once, each output written once. Operations: ~14 float ops per active
    lattice cell and step for the 3-way logaddexp and masks (+3 for the
    gradient in the backward)."""
    active = int(np.maximum(np.minimum(np.asarray(ilens), t), 1).sum())
    steps = int(np.maximum(np.minimum(np.asarray(ilens), t) - 1, 0).sum())
    small = 2 * b * s + 8 * b + 4 * b                 # masks, lengths, nll
    if backward:
        nbytes = 2 * 4 * active * s + small + 4 * b * t * s
        ops = 17 * (steps + b) * s
    else:
        nbytes = 4 * active * s + small + 4 * b * t * s
        ops = 14 * steps * s
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def ctc_library_ms(b, t, u, v):
    """torch's own CTC loss (F.ctc_loss, reduction none, zero_infinity) on
    the same log-probabilities [T, B, V]: forward alone and backward alone,
    and both beside the port's whole ctc_loss_kernel (gather + logsumexp +
    both kernels + scatter into the logits' gradient) from bf16 logits, as
    in training. A yardstick and a value check; the port never calls it."""
    import torch.nn.functional as F
    from tpu_asr_torch.ops.ctc_loss import ctc_loss_kernel
    g = torch.Generator().manual_seed(SEED + 1)
    logits = torch.randn(b, t, v, generator=g).to(DEVICE, torch.bfloat16)
    labels = torch.randint(2, v - 2, (b, u), generator=g).to(DEVICE)
    ilen = torch.full((b,), t, dtype=torch.long, device=DEVICE)
    llen = torch.full((b,), u, dtype=torch.long, device=DEVICE)
    lp = torch.log_softmax(logits.float(), -1).transpose(0, 1).contiguous()

    def lib(x, reduction="none"):
        return F.ctc_loss(x, labels, ilen, llen, blank=0,
                          reduction=reduction, zero_infinity=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: lib(lp))
        want = lib(lp)
        got = ctc_loss_kernel(logits, labels, ilen, llen, reduction="none")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
        raise AssertionError(f"ctc_loss_kernel disagrees with F.ctc_loss: "
                             f"max abs diff {(got - want).abs().max()}")
    lp_req = lp.detach().requires_grad_(True)
    nll = lib(lp_req)
    ones = torch.ones_like(nll)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(nll, lp_req, ones,
                                                  retain_graph=True))
    lg = logits.detach().requires_grad_(True)
    port_e2e = cuda_ms(lambda: torch.autograd.grad(ctc_loss_kernel(
        lg, labels, ilen, llen, reduction="sum"), lg))
    lib_e2e = cuda_ms(lambda: torch.autograd.grad(lib(torch.log_softmax(
        lg.float(), -1).transpose(0, 1), "sum"), lg))
    log(f"ctc loss B={b} T={t} U={u} V={v}: F.ctc_loss forward {lib_fwd:.4f}"
        f" ms, backward {lib_bwd:.4f} ms; from bf16 logits, forward + "
        f"backward: port ctc_loss_kernel {port_e2e:.4f} ms, F.ctc_loss "
        f"(+ log_softmax) {lib_e2e:.4f} ms; nll agrees (max abs diff "
        f"{(got - want).abs().max().item():.3e})")
    return dict(fwd=lib_fwd, bwd=lib_bwd, port_e2e=port_e2e,
                lib_e2e=lib_e2e)


def check_ctc_loss():
    from tpu_asr_torch.ops.ctc_loss import (ctc_loss_bwd,
                                            ctc_loss_bwd_reference,
                                            ctc_loss_fwd,
                                            ctc_loss_fwd_reference)
    rng = np.random.default_rng(2)
    b, t = 32, 249
    cases = [  # (b, t, u, ilens, llens, v): the path's shapes, then ragged
        (b, t, 24, [t] * b, [24] * b, 4233),
        (b, t, 30, [t] * b, [30] * b, 4233),
        (b, t, 24, list(rng.integers(1, t + 1, b)),
         list(rng.integers(0, 25, b)), 4233),
        (6, 40, 8, [40, 0, 3, 40, 17, 40], [8, 0, 8, 0, 5, 8], 64),
        (4, 1, 3, [1, 1, 0, 1], [0, 1, 0, 3], 64),
        (3, 20, 0, [20, 7, 0], [0, 0, 0], 64),                  # S = 1
        (3, 300, 200, [300, 250, 150], [200, 200, 100], 500),   # S = 401
    ]
    errs = dict(fwd=0.0, bwd=0.0)
    timings = {}
    for i, (bb, tt, u, ilens, llens, v) in enumerate(cases):
        args = ctc_case(bb, tt, u, ilens, llens, v, SEED + i)
        nll, alpha = ctc_loss_fwd(*args)
        grad = ctc_loss_bwd(*args, alpha, nll)
        want_nll, want_alpha = ctc_loss_fwd_reference(*args)
        want_grad = ctc_loss_bwd_reference(*args, want_alpha, want_nll)
        torch.cuda.synchronize()
        what = f"B={bb} T={tt} U={u}"
        errs["fwd"] = max(errs["fwd"],
                          compare(nll, want_nll, f"nll at {what}"),
                          compare(alpha, want_alpha, f"alpha at {what}"))
        if not torch.allclose(grad, want_grad, **CTC_GRAD_TOL):
            raise AssertionError(f"grad_E at {what}: kernel disagrees with "
                                 f"plain version (max abs diff "
                                 f"{(grad - want_grad).abs().max().item()})")
        if not torch.isfinite(grad).all():
            raise AssertionError(f"grad_E at {what} is not finite")
        errs["bwd"] = max(errs["bwd"],
                          (grad - want_grad).abs().max().item())
        if i < 2:                           # the path's shapes: time them
            s = 2 * u + 1
            fwd_ms = cuda_ms(lambda: ctc_loss_fwd(*args))
            bwd_ms = cuda_ms(lambda: ctc_loss_bwd(*args, alpha, nll))
            plain_fwd = cuda_ms(lambda: ctc_loss_fwd_reference(*args),
                                reps=5, warmup=1)
            plain_bwd = cuda_ms(lambda: ctc_loss_bwd_reference(
                *args, alpha, nll), reps=5, warmup=1)
            for name, ms, plain, bwd in (("fwd", fwd_ms, plain_fwd, False),
                                         ("bwd", bwd_ms, plain_bwd, True)):
                bound, by = ctc_bound_ms(bb, tt, s, ilens, bwd)
                timings[(name, s)] = dict(ms=ms, plain_ms=plain,
                                          bound_ms=bound, bound_by=by)
                log(f"ctc_loss_{name} B={bb} T={tt} S={s}: kernel "
                    f"{ms:.4f} ms, plain {plain:.3f} ms, bound "
                    f"{bound * 1e3:.3f} us ({by})")
    log(f"ctc_loss_fwd/bwd vs plain: {len(cases)} cases agree; max abs err "
        f"forward {errs['fwd']:.3e} (nll, alpha: atol {TOL['atol']}, rtol "
        f"{TOL['rtol']}), backward {errs['bwd']:.3e} (grad_E: atol "
        f"{CTC_GRAD_TOL['atol']}, rtol {CTC_GRAD_TOL['rtol']})")
    library = {s: ctc_library_ms(b, t, u, 4233) for s, u in ((49, 24),
                                                             (61, 30))}
    return errs, timings, library


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


def check_train_agreement():
    """hybrid_dev in float32 (dropout 0, no SpecAugment): two TrainSteps
    from the same init on one batch on the card (the CTC kernels) and on
    the CPU (their plain versions). Step 1's losses and raw grad norm, the
    update it applies (clip, Adam, Noam lr), and step 2's losses agree."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.train import NoamAdam, TrainStep, noam_schedule
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64)
    rng = np.random.default_rng(SEED)
    flens = np.array([200, 151, 0, 97], np.int32)
    tlens = np.array([8, 5, 0, 3], np.int32)
    targets = np.full((4, 8), -1, np.int32)
    for i, n in enumerate(tlens):
        targets[i, :n] = rng.integers(2, 62, n)
    batch = {"feats": rng.standard_normal((4, 200, 80)).astype(np.float32),
             "feat_lengths": flens, "targets": targets,
             "target_lengths": tlens}
    out, step2, update = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = init_random(Transformer(cfg), SEED).to(dev)
        ts = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model, 100),
                       device=dev, seed=SEED)
        p0 = torch.cat([p.detach().flatten() for p in model.parameters()])
        out[dev] = {k: float(v) for k, v in ts(batch).items()}
        update[dev] = torch.cat([p.detach().flatten() for p in
                                 model.parameters()]).cpu() - p0.cpu()
        step2[dev] = {k: float(v) for k, v in ts(batch).items()}
    card, cpu = out["cuda"], out["cpu"]
    losses = ("loss", "loss_att", "loss_ctc", "acc")
    bad = [k for k in losses if abs(card[k] - cpu[k]) > 1e-4]
    bad += [f"step 2 {k}" for k in losses
            if abs(step2["cuda"][k] - step2["cpu"][k]) > 1e-4]
    if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
            1e-3 * abs(cpu["grad_norm"]):
        raise AssertionError(f"train step on the card {card} {step2['cuda']}"
                             f" != on the CPU {cpu} {step2['cpu']}: {bad}")
    # Adam's first update is about lr * sign(g) per weight; a gradient
    # near 0 may round to either sign, so hold 99% of the entries, not all.
    lr = noam_schedule(cfg.d_model, 100)(0)
    near = 0.1 * lr
    agree = ((update["cuda"] - update["cpu"]).abs() <= near).float().mean()
    noop = (update["cpu"].abs() <= near).float().mean()
    if not agree >= 0.99 > noop:
        raise AssertionError(f"update on the card != on the CPU: {agree:.6f}"
                             f" of the entries within 0.1 lr ({noop:.6f} "
                             f"for a no-op update)")
    log("agreement: hybrid_dev train step on the card == on the CPU "
        "(losses of steps 1 and 2 within 1e-4, grad norm within 1e-3 "
        "relative, >= 99% of the update within 0.1 lr): "
        + json.dumps({"step1": {k: [card[k], cpu[k]] for k in sorted(card)},
                      "step2": {k: [step2["cuda"][k], step2["cpu"][k]]
                                for k in losses},
                      "update_within_0.1lr": float(agree),
                      "noop_within_0.1lr": float(noop)}))


def profile_device(fn, what, card):
    """Run fn() under torch.profiler: device time by kernel, and the
    device's busy share of the wall time. Only device-side events
    (kernels, copies, memsets) count: a CPU op's self device time is the
    time of the kernels it launched, which are listed themselves, and a
    record_function range (Optimizer.step) spans its kernels and the gaps
    between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    avg = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in avg)
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:20]
    log(f"profile {what}: wall {wall * 1e3:.1f} ms (profiler on), device "
        f"busy {busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}%, "
        f"{sum(e.count for e in avg)} device events [{card}]")
    for e in top:
        log(f"profile {what}:   {e.key[:70]:70s} "
            f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count}")


def profile_serving(server, wavs, card):
    """The same requests again under torch.profiler (not counted above)."""
    def run():
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda w: server.submit("wav", w, timeout=600.0),
                          wavs))
    profile_device(run, "serving", card)


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


# ---- phase 7: training ----

class TimedLoader:
    """A train loader that records a CUDA event (no sync) at every batch
    boundary, so each step's time on the device's timeline is read after
    the run, and counts the real utterances and audio of each batch."""

    def __init__(self, loader):
        self.loader = loader
        self.steps = []          # (start event, end event, utts, samples)

    def __iter__(self):
        prev = None
        for batch in self.loader:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if prev is not None:
                self.steps.append((prev[0], ev) + prev[1:])
            prev = (ev, len(batch["ids"]), int(batch["wav_lengths"].sum()))
            yield batch
        if prev is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.steps.append((prev[0], ev) + prev[1:])


def synthetic_aishell():
    """512 synthetic wav utterances, 8-30 tokens of 320 ms (2.6-9.6 s,
    ~3 tokens/s, AISHELL-like) over the 4233-token vocabulary; one tenth
    held out for cv, as `--synthetic` splits."""
    from tpu_asr_torch.data.synthetic import make_synthetic_dataset
    utts, waves = make_synthetic_dataset(512, 4233, min_tokens=8,
                                         max_tokens=30, tone_ms=320,
                                         seed=SEED)
    n_cv = len(utts) // 10
    return utts[n_cv:], utts[:n_cv], "wav", waves


def fixed_shape_batch(b=32, t=1000, u=24, v=4233):
    rng = np.random.default_rng(SEED)
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.full(b, t, np.int32),
            "targets": rng.integers(2, v - 2, (b, u)).astype(np.int32),
            "target_lengths": np.full(b, u, np.int32)}


def run_training(card, workdir):
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops.ctc_loss import ctc_loss_bwd, ctc_loss_fwd
    from tpu_asr_torch.train.__main__ import build_solver, parse_args

    t0 = time.perf_counter()
    data = synthetic_aishell()
    log(f"training: {len(data[0])} + {len(data[1])} synthetic utterances "
        f"made in {time.perf_counter() - t0:.1f} s")
    args = parse_args(["--preset", PRESET, "--save-folder", workdir])
    solver = build_solver(args, data)
    epochs = max(2, -(-MIN_TRAIN_STEPS // len(solver.train_loader)))
    solver.epochs = epochs
    timed = TimedLoader(solver.train_loader)
    solver.train_loader = timed
    ts = solver.train_step
    cfg = ts.model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # main path: counts from 0 just before, read just after
    ctc_loss_fwd.launches = ctc_loss_bwd.launches = 0
    wall0 = time.perf_counter()
    solver.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    fwd_launches, bwd_launches = ctc_loss_fwd.launches, ctc_loss_bwd.launches
    peak = torch.cuda.max_memory_allocated()

    steps = sum(h["train_steps"] for h in solver.history)
    cv_batches = sum(h["cv_batches"] for h in solver.history)
    if steps < MIN_TRAIN_STEPS or ts.optimizer.count != steps:
        raise AssertionError(f"{steps} steps, {ts.optimizer.count} updates")
    if any(h["nonfinite_steps"] for h in solver.history) or not all(
            np.isfinite([h["loss"], h["train_loss"], h["grad_norm_max"]]).all()
            for h in solver.history):
        raise AssertionError(f"non-finite training: {solver.history}")
    if bwd_launches != steps or fwd_launches != steps + cv_batches:
        raise AssertionError(
            f"CTC kernels: {fwd_launches} forward / {bwd_launches} backward "
            f"launches for {steps} train steps + {cv_batches} cv batches")
    step_ms = [a.elapsed_time(b) for a, b, _, _ in timed.steps]
    steady = timed.steps[1:]              # the first step warms up
    steady_s = sum(a.elapsed_time(b) for a, b, _, _ in steady) / 1e3
    utts = sum(n for _, _, n, _ in steady)
    audio_s = sum(x for _, _, _, x in steady) / 16000.0
    log(f"training: {PRESET} model (d{cfg.d_model}, h{cfg.num_heads}, "
        f"{cfg.num_enc_layers}+{cfg.num_dec_layers} layers, conv "
        f"{cfg.conv_channels}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"dropout {cfg.dropout}, SpecAugment on) {epochs} epochs, {steps} "
        f"steps + {cv_batches} cv batches in {wall:.2f} s; CTC kernels "
        f"{fwd_launches} forward / {bwd_launches} backward launches")
    log("training: per epoch " + json.dumps(solver.history))
    log(f"training: step ms median {statistics.median(step_ms):.2f}, min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; steady (steps 2..): "
        f"{len(steady) / steady_s:.2f} steps/s, {utts / steady_s:.1f} "
        f"utterances/s, {audio_s / steady_s:.1f} audio s/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")

    # the epoch checkpoint restores to equal parameters
    ck = solver.checkpointer
    restored = Transformer(cfg)
    restored.load_state_dict(ck.restore(ck.latest_step())["model"])
    for (k, a), b in zip(ts.model.state_dict().items(),
                         restored.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"checkpoint restore differs at {k}")
    log(f"training: checkpoint step {ck.latest_step()} restores equal "
        f"parameters ({len(restored.state_dict())} tensors)")

    it = iter(solver.train_loader.loader)
    batches = [next(it) for _ in range(4)]
    it.close()
    profile_device(lambda: [ts(b) for b in batches], "training", card)

    batch = fixed_shape_batch()
    for _ in range(3):
        ts(batch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(21)]
    events[0].record()
    for i in range(20):
        ts(batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    fixed = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    total_s = events[0].elapsed_time(events[-1]) / 1e3
    log(f"training: fixed shape feats [32, 1000, 80], U=24: 20 steps, "
        f"step ms median {statistics.median(fixed):.2f}, min "
        f"{min(fixed):.2f}; {20 / total_s:.2f} steps/s, "
        f"{20 * 32 / total_s:.1f} utterances/s, {20 * 32 * 10 / total_s:.1f}"
        f" audio s/s [{card}]")
    return fwd_launches, bwd_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from tpu_asr_torch.ops import ctc_loss, ctc_prefix
    from tpu_asr_torch.ops.cuda_build import load_all

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libraries = (ctc_prefix.LIBRARY, ctc_loss.LIBRARY)
    load_all(*libraries)
    log(f"build: {', '.join(lib.name for lib in libraries)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libraries:
        if lib.build_log:
            log(lib.build_log.strip())

    gen = torch.Generator().manual_seed(SEED)
    max_err, timings = check_prefix_scan(gen)
    ctc_errs, ctc_timings, ctc_library = check_ctc_loss()
    check_agreement()
    check_train_agreement()
    launches = run_serving(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        fwd_launches, bwd_launches = run_training(card, workdir)

    main_t = timings[(249, True)]          # 1000-frame bucket, one-pass
    kernels = [{
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
    }]
    for name, line, n in (("fwd", 176, fwd_launches),
                          ("bwd", 211, bwd_launches)):
        t = ctc_timings[(name, 49)]
        kernels.append({
            "name": f"ctc_loss_{name}",
            "route": "cuda",
            "source": "tpu_asr_torch/csrc/ctc_loss.cu",
            "replaces": f"tpu_asr/ops/pallas/ctc.py:{line}",
            "launches": n,
            "max_abs_err": ctc_errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": ctc_library[49][name],
            "shape": "B=32 T=249 S=49 (U=24)",
            "other_shapes": {"B=32 T=249 S=61 (U=30)": dict(
                ctc_timings[(name, 61)], library_ms=ctc_library[61][name])},
            "ctc_loss_kernel_e2e_ms": ctc_library[49]["port_e2e"],
            "library_e2e_ms": ctc_library[49]["lib_e2e"],
        })
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
