#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit before the last line):
  1. device: require CUDA; print the card's name and power limit; TF32 off.
  2. build: compile every kernel from tpu_asr_torch/csrc (one nvcc per
     source, all at once) and print nvcc's -Xptxas -v report when this
     run built them; read each library's HGMMA (wgmma) instructions and
     the kernels' registers, stack frame and local memory from the
     library itself (cuobjdump, so a cached library is checked alike) and
     fail unless every bf16 flash forward, dq and dk/dv kernel has HGMMA
     and none of them, nor any LN backward kernel, nor the CTC prefix
     scan, nor the CTC forward's or backward's warp route, nor the CIF
     fire kernel, spills registers.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the main paths' shapes and at ragged ones, with timings (the
     wrapper by CUDA events, the kernel alone by the profiler):
     ctc_prefix_scan (serving; also at the edges of its ring of tiles,
     lengths past T and T = 3000) and the CTC loss pair ctc_loss_fwd /
     ctc_loss_bwd (training; each on both of its routes, at the edges of
     the warp routes' rings, ilen past T and T = 3000), two calls equal
     bitwise, the pair also beside torch's own CTC loss
     (F.ctc_loss, timed as a yardstick and used as a value check only),
     each CTC recursion beside its chain floor (a probe: one warp running
     the kernel's step T - 1 times on operands in registers), the
     forward's branch-free log held bit-equal to logf at every float in
     [1, 3];
     cif_fire (CIF serving and training) on 13 cases (serving's two
     buckets, the bench shape, ragged ones, alphas whose c - alpha is not
     monotone in its last ulp, T past one shared-memory stage) and its
     autograd Function's
     gradients against autograd of the plain version; flash_attention_fwd
     (use_pallas serving: encoder self-attention, decoder causal
     self-attention and cross-attention at the served shapes, ragged key
     lengths with a length-0 row, Tk >= 600, float32 and bfloat16; in
     bf16 (the wgmma kernel) also dh 32 and 128, Tq = 1, batches whose
     padding masks whole 64-key tiles, and q/k/v as strided views of one
     [B, T, 3, H, dh] tensor; timed beside F.scaled_dot_product_attention
     with the same boolean mask as a yardstick) and
     layer_norm_residual_fwd (the served row counts, 1 to 8080 rows, D 64
     to 2048). The backward kernels of use_pallas training against the
     plain backward: flash_attention_bwd_dq and flash_attention_bwd_dkv
     (csrc/flash_attention_bwd.cu) at the training shapes (encoder self
     [32, 249], decoder causal [32, 25], cross [32, 25] x [32, 249], h8
     dh64 bf16; timed beside torch.autograd.grad of
     F.scaled_dot_product_attention), at ragged ones and at the forward's
     new bf16 cases (bf16 on the wgmma dq and dk/dv kernels), and
     layer_norm_residual_bwd at 7968 and 800 rows x 512 (timed beside
     aten.native_layer_norm_backward, warm and with L2 flushed, and
     traced: one device kernel a call) and 1 to 8080 rows, D 64 to 2048.
  4. agreement: a small hybrid model decodes the same batch on the card and
     on the CPU (plain versions), tokens equal; and takes two train steps
     from the same init on one batch on both: losses of both steps within
     1e-4, step 1's grad norms within 1e-3 relative, and >= 99% of the
     entries of step 1's update within 0.1 lr; the same with use_pallas
     on a batch of >= 512 encoder and decoder rows, where the flash and
     LN kernels run forward and backward. A small CIF model (cif_dev)
     likewise: cif_greedy and cif_beam tokens equal, one train step's
     losses within 1e-4 and grad norm within 1e-3 relative, without and
     with use_pallas. The small
     hybrid model with use_pallas in attn_rescore and ctc_beam: tokens
     equal on the card (flash attention and fused LN kernels) and on the
     CPU.
  5. serving: the aishell-width hybrid model (d512, h8, 6+6 layers, conv
     (32, 128), vocab 4233, bf16; random weights from a seed) in joint
     CTC/attention beam-5 mode behind AsrServer; 16 wav requests from
     several threads (then the same again under torch.profiler, whose
     table of device time by kernel is printed), then one greedy_ctc
     batch. The kernels' launch counts must show the path went through
     them.
  6. HTTP: POST /recognize one wav through make_http_server. Then CIF
     serving: the cif preset at full width (d512, h8, 6+6 layers, conv 256,
     vocab 4233, float32; random weights) in cif_greedy behind AsrServer,
     the same 16 requests (and again under torch.profiler); cif_fire
     launches once per decode batch.
  7. use_pallas serving: the aishell model with use_pallas in the preset's
     attn_rescore (beam 10, max_len 100, ctc weight 0.3) behind AsrServer,
     the same 16 requests (and again under torch.profiler); per decode
     batch the flash kernel launches once per attention of the encoder
     and the decoder pass, the LN kernel once per post-norm block.
  8. training: the aishell preset at full width (dropout 0.1, SpecAugment,
     Noam/Adam, clip 5, 32000-frame batches) through the Solver that
     `python -m tpu_asr_torch.train` builds, on 512 synthetic AISHELL-like
     wav utterances, for at least 20 optimizer steps; losses and grad norms
     finite, the CTC kernels launched once per step (forward also once per
     cv batch; both on their warp routes); step times, throughput,
     peak memory; a few steps under torch.profiler; 20 steps at the fixed shape feats [32, 1000, 80],
     U = 24; the epoch checkpoint restores to equal parameters. Then the
     same for the cif preset (16000-frame batches, no SpecAugment), where
     cif_fire also launches once per train step and cv batch; and for the
     aishell preset with use_pallas (build_solver's model_overrides),
     where per train step the flash forward, dq and dk/dv kernels launch
     once per full-pass attention (18; the forward also per cv batch) and
     the LN forward and backward once per post-norm call of >= 512 rows.
  9. kernels on the main paths' inputs: ctc_prefix_scan on the first
     and a later call of each joint-beam serving bucket, ctc_loss_fwd and
     ctc_loss_bwd on the first backward's inputs of each training (the
     forward also against the alpha and nll the path's forward gave), as
     the kernels received them,
     against their plain versions, timed; cif_fire on the first batch of
     each CIF serving bucket and the first CIF train and cv batch, as
     model.fire received them, against the plain version, timed beside one
     torch.bmm on a materialized weight matrix (training's also checks the
     gradients); flash_attention_fwd and layer_norm_residual_fwd on the
     first inputs of each kind in each bucket of phase 7, as the kernels
     received them, against their plain versions, timed; the backward
     kernels likewise on the first train batch of each bucket of the
     use_pallas training, as the Functions' backward received them.
Then one JSON line for the kernels, the card line, and the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
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
BF16_FLOP_PER_S = 989e12      # H100 SXM, bf16 dense tensor cores
TOL = dict(atol=1e-4, rtol=1e-5)
CTC_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
CIF_TOL = dict(atol=1e-5, rtol=1e-5)
F32_TOL = dict(atol=1e-5, rtol=1e-5)     # flash and LN kernels, float32
F32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # their backward kernels
FLASH_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
FLIP_REPORT_ULPS = 0.75   # a bf16 flash gradient this near its bound logs
                          # what rounding flips of p and ds can explain
MIN_TRAIN_STEPS = 20
# the redesigned kernels' times alone before their present design: the
# served cross shape (forward) and training's encoder self shape (dk/dv,
# dq; the LN backward at [33, 238, 512] bf16), runs E (forward, dk/dv) and
# F (dq, LN backward) of PERF.md; the CTC prefix scan at N=40 T=249 K=11
# with histories and the CTC backward at B=32 T=249 S=49, run D of
# PERF.md; the CTC forward at B=32 T=249 S=49 and cif_fire at served
# B=8 T'=248 U=100, run I of PERF.md; all NVIDIA H100 80GB HBM3, 700 W
PREVIOUS_ALONE_MS = {"flash_attention_fwd": 0.6092,
                     "flash_attention_bwd_dkv": 0.6672,
                     "flash_attention_bwd_dq": 0.6054,
                     "layer_norm_residual_bwd": 0.0265,
                     "ctc_prefix_scan": 0.0945,
                     "ctc_loss_bwd": 0.0702,
                     "ctc_loss_fwd": 0.0503,
                     "cif_fire": 0.0040}
L2_FLUSH_BYTES = 128 << 20    # read between calls: > the H100's 50 MB L2
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


_flush_buffer = []


def flush_l2():
    """Read L2_FLUSH_BYTES of device memory (one sum), so the next kernel
    finds its inputs in device memory and not in the L2 cache. A read, not
    a write: a write would leave the cache full of dirty lines whose
    write-back the next kernel would pay for."""
    if not _flush_buffer:
        _flush_buffer.append(torch.zeros(L2_FLUSH_BYTES // 4,
                                         dtype=torch.float32, device=DEVICE))
    _flush_buffer[0].sum()


def kernel_device_ms(fn, name: str, reps: int = 20, flush=None):
    """Mean device time of one launch of the kernel whose name contains
    `name` (torch.profiler; fn() launches it once): the kernel alone,
    without the wrapper's other launches and host time; with `flush`,
    flush() runs before each call (its own kernel is not counted). The
    mean is over the launches the trace holds, not over the calls: late
    in a long run the trace came back with some of them missing (a flash
    backward kernel read 0.27 ms by reps and 0.59 ms alone in a fresh
    process), and at times with none of 20, three traces in a row. So an
    empty trace is taken again with twice the calls, up to 4 times. If
    all 4 are empty, the kernel's time is unknown: None (null in the
    `kernels` line, "not traced" in the log). No other time stands in for
    it; the row's `ms` is the wrapper's by CUDA events, as always."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        calls = reps << attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush:
                    flush()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        count = sum(e.count for e in events)
        if count:
            break
        log(f"profiler: no launch of {name} traced in {calls} calls (trace "
            f"{attempt + 1} of 4)")
    else:
        log(f"profiler: no launch of {name} in 4 traces: its time alone is "
            f"not traced (null)")
        return None
    if count != calls:
        log(f"profiler: {count} of {calls} launches of {name} traced")
    return sum(e.self_device_time_total for e in events) / 1e3 / count


def ms4(ms) -> str:
    """A kernel-alone time for the log: 4 decimals, or "not traced" where
    kernel_device_ms found no launch."""
    return "not traced" if ms is None else f"{ms:.4f}"


def device_events(fn, name: str, reps: int = 10) -> dict:
    """{kernel name: count} of every device-side event (kernels, copies,
    memsets) that `reps` calls of fn() leave in a torch.profiler trace,
    taken again (up to 3 times) until the kernel whose name contains
    `name` is in it: what a wrapper launches besides its kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if any(name in k for k in found):
            return found
    raise AssertionError(f"the profiler saw no launch of {name} in 3 traces")


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of fn() over `reps` calls (CUDA events); with
    `flush`, flush() runs before each call, outside the timed region."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---- phase 2: what the build made ----

def parse_hgmma(sass: str) -> dict:
    """{mangled kernel name: HGMMA instructions} from `cuobjdump
    --dump-sass` of a library."""
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        counts[name] = counts.get(name, 0) + chunk.count("HGMMA")
    return counts


def parse_resource_usage(text: str) -> dict:
    """{mangled kernel name: {"REG", "STACK", "SHARED", "LOCAL", ...}} from
    `cuobjdump --dump-resource-usage` of a library: what ptxas gave each
    kernel, read from the built library itself, so it holds whether or
    not this process ran nvcc. Spills go to the stack frame (STACK) or
    local memory (LOCAL)."""
    usage = {}
    for name, fields in re.findall(r"Function ([^\s:]+):\s*\n\s*([^\n]*)",
                                   text):
        usage[name] = {k: int(v) for k, v in
                       re.findall(r"([A-Z][A-Z0-9_\[\]]*):(\d+)", fields)}
    return usage


def sass_report(path: str) -> dict:
    """{mangled kernel name: {"hgmma", "registers", "stack_bytes",
    "local_bytes", "static_smem_bytes"}} of the shared library at `path`,
    by the cuobjdump of the toolkit that built it."""
    from tpu_asr_torch.ops.cuda_build import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, path], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    hgmma = parse_hgmma(dump("--dump-sass"))
    usage = parse_resource_usage(dump("--dump-resource-usage"))
    return {name: dict(hgmma=hgmma.get(name, 0),
                       registers=usage.get(name, {}).get("REG"),
                       stack_bytes=usage.get(name, {}).get("STACK"),
                       local_bytes=usage.get(name, {}).get("LOCAL"),
                       static_smem_bytes=usage.get(name, {}).get("SHARED"))
            for name in {**hgmma, **usage}}


WGMMA_KERNELS = ("flash_attention_fwd_wgmma_kernel",
                 "flash_attention_bwd_dq_wgmma_kernel",
                 "flash_attention_bwd_dkv_wgmma_kernel")
# kernels whose every instantiation must not spill (no HGMMA expected):
# the LN backward, the three CTC kernels whose step chains read shared
# memory only, and the CIF fire kernel, which holds its frames' loads of h
# in registers
NO_SPILL_KERNELS = ("layer_norm_residual_bwd_kernel", "ctc_prefix_scan_kernel",
                    "ctc_beta_grad_warp_kernel", "ctc_alpha_warp_kernel",
                    "cif_fire_kernel")


def check_build(libraries, report=sass_report) -> dict:
    """Print each library's HGMMA count and, for the bf16 flash kernels on
    wgmma and the NO_SPILL_KERNELS, their registers, stack frame, local
    memory, static shared memory (the flash tiles and the CTC rings are
    dynamic shared memory) and HGMMA instructions, all read from the
    built libraries;
    fail unless each wgmma kernel (every head size) has HGMMA and none of
    them (every instantiation) has a stack frame or local memory (no
    spills). -> {kernel: that report}."""
    watched = WGMMA_KERNELS + NO_SPILL_KERNELS
    found = {}
    for lib in libraries:
        kernels = report(lib._target())
        log(f"SASS {lib.name}: "
            f"{sum(k['hgmma'] for k in kernels.values())} HGMMA in "
            f"{len(kernels)} kernels")
        found.update({name: r for name, r in kernels.items()
                      if any(w in name for w in watched)})
    log("wgmma, LN backward, CTC and CIF kernels (cuobjdump): "
        + json.dumps(found))
    for w in watched:
        mine = {k: v for k, v in found.items() if w in k}
        if w in WGMMA_KERNELS and (
                len(mine) != 3 or any(not v["hgmma"] for v in mine.values())):
            raise AssertionError(f"{w}: expected 3 head sizes with HGMMA "
                                 f"instructions, got {mine}")
        if not mine or any(v["registers"] is None or v["stack_bytes"] != 0
                           or v["local_bytes"] != 0 for v in mine.values()):
            raise AssertionError(f"{w} spills registers (or its resource "
                                 f"usage was not read): {mine}")
    return found


# ---- phase 3: ctc_prefix_scan vs its plain version ----

def prefix_scan_inputs(n, t, k, lengths, gen):
    """Inputs shaped like the joint beam's: log-probs for x_cand/x_blank,
    phi with NEG_INF entries (repeated-symbol candidates), empty-prefix
    inits."""
    from tpu_asr_torch.ops.ctc_prefix import NEG_INF
    dev = DEVICE
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


def compare_prefix(args, what):
    """The kernel against its plain version with and without histories,
    within TOL; two calls give the same bits. -> max abs error."""
    from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                              ctc_prefix_scan_reference)
    max_err = 0.0
    for hist in (True, False):
        got = ctc_prefix_scan(*args, return_hist=hist)
        again = ctc_prefix_scan(*args, return_hist=hist)
        want = ctc_prefix_scan_reference(*args, return_hist=hist)
        torch.cuda.synchronize()
        for name, g, a, w in zip(("psi", "nb_hist", "b_hist"), got, again,
                                 want):
            if g is None and w is None:
                continue
            max_err = max(max_err, compare(g, w, f"{name} at {what} "
                                                 f"hist={hist}"))
            if not torch.equal(g, a):
                raise AssertionError(f"{name} at {what} hist={hist}: two "
                                     f"calls differ")
    return max_err


def time_prefix(args, hist, what):
    """ctc_prefix_scan's times on these inputs: the wrapper (CUDA events),
    the kernel alone (profiler), the plain version; the bound."""
    from tpu_asr_torch.ops.ctc_prefix import (KERNEL_SYMBOL, ctc_prefix_scan,
                                              ctc_prefix_scan_reference)
    n, t, k = args[0].shape
    lengths = args[6].tolist()
    fn = lambda: ctc_prefix_scan(*args, return_hist=hist)  # noqa: E731
    ms = cuda_ms(fn)
    alone = kernel_device_ms(fn, KERNEL_SYMBOL)
    plain = cuda_ms(lambda: ctc_prefix_scan_reference(
        *args, return_hist=hist), reps=20, warmup=1)
    bound, by = prefix_scan_bound_ms(n, t, k, lengths, hist)
    log(f"ctc_prefix_scan {what} hist={hist}: wrapper {ms:.4f} ms, the "
        f"kernel alone {ms4(alone)} ms (profiler), plain {plain:.3f} ms, "
        f"bound {bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, kernel_device_ms=alone, plain_ms=plain,
                bound_ms=bound, bound_by=by)


def prefix_chain_floor_ms(t):
    """The chain's floor at T frames: the probe (one warp, the kernel's
    step T - 1 times, operands in registers) alone, by the profiler."""
    from tpu_asr_torch.ops.ctc_prefix import PROBE_SYMBOL, chain_probe
    if not torch.isfinite(chain_probe(t - 1)).all():
        raise AssertionError("ctc_prefix_scan chain probe: not finite")
    return kernel_device_ms(lambda: chain_probe(t - 1), PROBE_SYMBOL)


def check_prefix_scan(gen):
    from tpu_asr_torch.ops.ctc_prefix import launch_plan, log1p_mismatches
    bad = log1p_mismatches()
    if bad:
        raise AssertionError(f"the prefix scan's log1p differs from log1pf "
                             f"at {bad} floats in [0, 1]")
    log("ctc_prefix_scan: its branch-free log1p equals log1pf bit for bit "
        "at every float in [0, 1]")
    cases = [  # (n, t, k, lengths): the path's two buckets, then ragged
        (40, 249, 11, [249] * 40),
        (40, 127, 11, [127] * 40),
        (40, 249, 11, list(np.random.default_rng(1).integers(1, 250, 40))),
        (13, 9, 21, [1, 9, 5, 2, 9, 3, 7, 1, 8, 6, 4, 9, 2]),
        (3, 1, 11, [1, 1, 0]),
        (2, 5, 130, [5, 3]),
        # the ring's edges: 64, 63, 32, 31 and 1 steps (tiles of 32)
        (5, 65, 11, [65, 64, 33, 32, 2]),
        # lengths past T, and T whose rows (2K + 1) T 4 bytes (276 KB)
        # exceed a block's shared memory
        (3, 40, 11, [100, 40, 0]),
        (4, 3000, 11, [3000, 2999, 1500, 33]),
        (3, 70, 300, [70, 69, 5]),           # three chain groups a beam
    ]
    max_err, timings = 0.0, {}
    for n, t, k, lengths in cases:
        args = prefix_scan_inputs(n, t, k, lengths, gen)
        what = f"N={n} T={t} K={k}"
        max_err = max(max_err, compare_prefix(args, what))
        if lengths == [t] * n:      # the path's shapes: time them
            for hist in (True, False):
                timings[(t, hist)] = time_prefix(args, hist, what)
    floor = prefix_chain_floor_ms(249)
    log(f"ctc_prefix_scan vs plain: {len(cases) * 2} cases agree, two calls "
        f"equal bitwise, max abs err {max_err:.3e} (atol {TOL['atol']}, "
        f"rtol {TOL['rtol']}); chain floor at T=249 (248 steps, the probe "
        f"alone) {ms4(floor)} ms")
    log(f"ctc_prefix_scan's launch at K=11 (constants of its source, as its "
        f"library reports them; not measured): {json.dumps(launch_plan(11))}")
    return max_err, timings, floor


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


def compare_ctc_bwd(args, alpha, nll, what, want_alpha=None,
                    want_nll=None):
    """ctc_loss_bwd on alpha and nll against its plain version, within
    CTC_GRAD_TOL, finite; two calls give the same bits. The plain version
    takes want_alpha and want_nll where given (the plain forward's, so
    that the whole plain chain is held), else the same alpha and nll.
    -> max abs error."""
    from tpu_asr_torch.ops.ctc_loss import (ctc_loss_bwd,
                                            ctc_loss_bwd_reference)
    grad = ctc_loss_bwd(*args, alpha, nll)
    again = ctc_loss_bwd(*args, alpha, nll)
    want = ctc_loss_bwd_reference(
        *args, alpha if want_alpha is None else want_alpha,
        nll if want_nll is None else want_nll)
    torch.cuda.synchronize()
    if not torch.allclose(grad, want, **CTC_GRAD_TOL):
        raise AssertionError(f"grad_E at {what}: kernel disagrees with plain "
                             f"version (max abs diff "
                             f"{(grad - want).abs().max().item()})")
    if not torch.isfinite(grad).all():
        raise AssertionError(f"grad_E at {what} is not finite")
    if not torch.equal(grad, again):
        raise AssertionError(f"grad_E at {what}: two calls differ")
    return (grad - want).abs().max().item()


def time_ctc(args, alpha, nll, backward, what):
    """One CTC loss kernel's times on these inputs: the wrapper (CUDA
    events), the kernel alone (profiler, by the symbol of the kernel the
    wrapper launches), the plain version; the bound."""
    from tpu_asr_torch.ops.ctc_loss import (BWD_SYMBOLS, FWD_SYMBOLS,
                                            bwd_route, ctc_loss_bwd,
                                            ctc_loss_bwd_reference,
                                            ctc_loss_fwd,
                                            ctc_loss_fwd_reference,
                                            fwd_route)
    b, t, s = args[0].shape
    if backward:
        fn = lambda: ctc_loss_bwd(*args, alpha, nll)  # noqa: E731
        plain_fn = lambda: ctc_loss_bwd_reference(  # noqa: E731
            *args, alpha, nll)
        symbol = BWD_SYMBOLS[bwd_route(s)]
    else:
        fn = lambda: ctc_loss_fwd(*args)  # noqa: E731
        plain_fn = lambda: ctc_loss_fwd_reference(*args)  # noqa: E731
        symbol = FWD_SYMBOLS[fwd_route(s)]
    plain = cuda_ms(plain_fn, reps=5, warmup=1)
    bound, by = ctc_bound_ms(b, t, s, args[3].tolist(), backward)
    ms = cuda_ms(fn)
    alone = kernel_device_ms(fn, symbol)
    log(f"{symbol} {what}: wrapper {ms:.4f} ms, the kernel alone "
        f"{ms4(alone)} ms (profiler), plain {plain:.3f} ms, bound "
        f"{bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, kernel_device_ms=alone, plain_ms=plain,
                bound_ms=bound, bound_by=by, symbol=symbol)


def ctc_chain_floor_ms(t, s, which):
    """The forward's (which="fwd") or backward's ("bwd") chain floor at T
    frames and S positions: the probe (one warp, the warp route's step T -
    1 times, operands in registers) alone, by the profiler."""
    from tpu_asr_torch.ops.ctc_loss import PROBE_SYMBOLS, chain_probe

    def probe():
        return chain_probe(t - 1, s, which=which)
    if not torch.isfinite(probe()).all():
        raise AssertionError(f"ctc_loss_{which} chain probe: not finite")
    return kernel_device_ms(probe, PROBE_SYMBOLS[which])


def compare_ctc_fwd(args, what):
    """ctc_loss_fwd against its plain version, within TOL; two calls give
    the same bits. -> (nll, alpha), the plain version's (nll, alpha), max
    abs error, and whether nll and alpha are the plain version's bits."""
    from tpu_asr_torch.ops.ctc_loss import (ctc_loss_fwd,
                                            ctc_loss_fwd_reference)
    got = ctc_loss_fwd(*args)
    again = ctc_loss_fwd(*args)
    want = ctc_loss_fwd_reference(*args)
    torch.cuda.synchronize()
    err = max(compare(got[0], want[0], f"nll at {what}"),
              compare(got[1], want[1], f"alpha at {what}"))
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"ctc_loss_fwd at {what}: two calls differ")
    return got, want, err, all(torch.equal(g, w) for g, w in zip(got, want))


def route_launches(counts, before):
    """{route: launches} since `before` (a copy of FWD_ROUTE_LAUNCHES or
    BWD_ROUTE_LAUNCHES)."""
    return {k: v - before[k] for k, v in counts.items() if v != before[k]}


def check_ctc_loss():
    from tpu_asr_torch.ops.ctc_loss import (BWD_ROUTE_LAUNCHES,
                                            FWD_ROUTE_LAUNCHES, bwd_route,
                                            fwd_route, log_mismatches,
                                            warp_plan)
    bad = log_mismatches()
    if bad:
        raise AssertionError(f"the CTC forward's log differs from logf at "
                             f"{bad} floats in [1, 3]")
    log("ctc_loss_fwd: its branch-free log equals logf bit for bit at "
        "every float in [1, 3]")
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
        # the warp route's ring: ilen past T, rows at the tile's edges
        # (tiles of 16 rows), S = 63 (the last lane's pair half full), S =
        # 65 (training's longest labels, two positions a lane and the last
        # on lane 31), S = 97 (three and the last), S = 127 (four); S =
        # 129, the block route's first width
        (5, 20, 5, [25, 20, 16, 17, 1], [5, 5, 2, 5, 0], 64),
        (5, 249, 31, [249, 200, 33, 32, 16], [31, 31, 8, 5, 0], 500),
        (b, t, 32, [t] * b, [32] * b, 4233),
        (3, 50, 48, [50, 49, 20], [48, 40, 8], 500),
        (5, 60, 63, [60, 59, 17, 16, 1], [63, 60, 8, 5, 0], 500),
        (3, 30, 64, [30, 29, 1], [64, 30, 0], 500),
        # T whose rows of E and alpha (2 T S 4 bytes, 1.2 MB) exceed a
        # block's shared memory many times
        (3, 3000, 24, [3000, 2999, 1601], [24, 24, 10], 300),
    ]
    errs = dict(fwd=0.0, bwd=0.0)
    timings = {}
    routes = {"fwd": {}, "bwd": {}}
    bitwise = 0
    for i, (bb, tt, u, ilens, llens, v) in enumerate(cases):
        args = ctc_case(bb, tt, u, ilens, llens, v, SEED + i)
        s = 2 * u + 1
        what = f"B={bb} T={tt} U={u} (S={s}, {bwd_route(s)} route)"
        before = dict(FWD_ROUTE_LAUNCHES)
        (nll, alpha), (want_nll, want_alpha), err, same = compare_ctc_fwd(
            args, what)
        errs["fwd"] = max(errs["fwd"], err)
        bitwise += same
        routes["fwd"][what] = route_launches(FWD_ROUTE_LAUNCHES, before)
        before = dict(BWD_ROUTE_LAUNCHES)
        errs["bwd"] = max(errs["bwd"], compare_ctc_bwd(
            args, alpha, nll, what, want_alpha, want_nll))
        routes["bwd"][what] = route_launches(BWD_ROUTE_LAUNCHES, before)
        for name, route in (("fwd", fwd_route(s)), ("bwd", bwd_route(s))):
            if routes[name][what] != {route: 2}:
                raise AssertionError(f"ctc_loss_{name} at {what} took the "
                                     f"routes {routes[name][what]}")
        if i < 2 or s == 65:                # the path's shapes: time them
            for name, backward in (("fwd", False), ("bwd", True)):
                timings[(name, s)] = dict(
                    time_ctc(args, alpha, nll, backward,
                             f"B={bb} T={tt} S={s}"), route=bwd_route(s))
                if s <= 64:                 # the probes: two positions a lane
                    timings[(name, s)]["chain_floor_ms"] = ctc_chain_floor_ms(
                        tt, s, name)
    floors = {name: " / ".join(ms4(timings[(name, s)]['chain_floor_ms'])
                               for s in (49, 61)) for name in ("fwd", "bwd")}
    log(f"ctc_loss_fwd/bwd vs plain: {len(cases)} cases agree; max abs err "
        f"forward {errs['fwd']:.3e} (nll, alpha: atol {TOL['atol']}, rtol "
        f"{TOL['rtol']}; nll and alpha the plain version's bits in "
        f"{bitwise} of {len(cases)} cases), backward {errs['bwd']:.3e} "
        f"(grad_E: atol {CTC_GRAD_TOL['atol']}, rtol "
        f"{CTC_GRAD_TOL['rtol']}); two calls equal bitwise; routes "
        f"{json.dumps(routes)}; chain floors at T=249 S=49 / 61 (the probes "
        f"alone): forward {floors['fwd']} ms, backward {floors['bwd']} ms")
    log("ctc_loss_fwd's and ctc_loss_bwd's warp-route launches at S=49 / 61 "
        "/ 65 (constants of their source, as its library reports them; not "
        "measured): " + "; ".join(
            f"{name} " + " / ".join(json.dumps(warp_plan(s, name))
                                    for s in (49, 61, 65))
            for name in ("fwd", "bwd")))
    library = {s: ctc_library_ms(b, t, u, 4233) for s, u in ((49, 24),
                                                             (61, 30))}
    return errs, timings, library


# ---- phase 3: the CIF fire kernel vs its plain version ----

def cif_case(b, t, d, u_max, kind, seed):
    """(hidden [B, T, D], alphas [B, T]) on the card. kinds: `scaled`
    (assigner-like alphas scaled to sum to u_max), `serving` (each row
    scaled to its own 40-95 fires, below u_max, as cif_greedy scales them
    to the rounded fire count), `padded` (raw alphas within each row's
    length, 0 past it, the batch's second half empty rows, as in a served
    batch; each row's total falls between two whole fires, so its padding
    sits inside an output's [u, u + 1)), `raw` (sigmoid-like, unscaled), `big`
    (alphas up to 3), `zero_rows` (rows of length 0), `few` (far fewer
    fires than u_max), `ulp` (c - alpha not monotone in its last ulp: each
    row's cumsum reaches k = 16, 32 or 64 exactly on halves, ten alphas of
    1e-10 leave c and c - alpha at k, and the next alpha a gives c - alpha
    = (k + a) - a, which rounds to k - ulp in about a quarter of the rows
    (below a power of two the ulp halves), so that frame weighs ~2e-6 on
    output k - 1 after frames whose c - alpha is k)."""
    g = torch.Generator().manual_seed(seed)
    hidden = torch.randn(b, t, d, generator=g)
    hi = {"big": 3.0, "few": 0.05}.get(kind, 1.0)
    alphas = torch.rand(b, t, generator=g) * hi
    if kind == "zero_rows":
        lens = torch.randint(1, t + 1, (b,), generator=g)
        lens[::3] = 0
        alphas = torch.where(torch.arange(t)[None, :] < lens[:, None],
                             alphas, 0.0)
    if kind == "scaled":
        alphas = alphas * (u_max / alphas.sum(-1, keepdim=True))
    if kind == "padded":
        lens = torch.randint(t // 2, t + 1, (b,), generator=g)
        lens[b // 2:] = 0
        alphas = torch.where(torch.arange(t)[None, :] < lens[:, None],
                             alphas, 0.0)
    if kind == "serving":
        fires = torch.randint(40, 96, (b, 1), generator=g).float()
        alphas = alphas * (fires / alphas.sum(-1, keepdim=True))
    if kind == "ulp":
        for r in range(b):
            k = 2 * (16, 32, 64)[r % 3]    # halves: c reaches 16, 32, 64
            alphas[r, :k] = 0.5
            alphas[r, k:k + 10] = 1e-10
    return hidden.to(DEVICE), alphas.to(DEVICE)


def disordered_weights(alphas, u_max):
    """Non-zero weights of frames whose c - alpha lies below an earlier
    frame's: the weights a search that took c - alpha as sorted could
    lose."""
    from tpu_asr_torch.ops.cif import cif_weights
    c_prev = torch.cumsum(alphas, -1) - alphas
    before = torch.cummax(c_prev, -1).values
    below = torch.zeros_like(c_prev, dtype=torch.bool)
    below[:, 1:] = c_prev[:, 1:] < before[:, :-1]
    return int(((cif_weights(alphas, u_max) != 0) & below[..., None]).sum())


def cif_bound_ms(hidden, alphas, u_max):
    """Least time for the same work on an H100. Bytes: h, alpha and c read
    once, the output written once. Operations: one multiply-add per
    non-zero weight (this data's) and column."""
    from tpu_asr_torch.ops.cif import cif_weights
    b, t, d = hidden.shape
    nnz = int((cif_weights(alphas, u_max) != 0).sum())
    nbytes = 4 * (b * t * d + 2 * b * t + b * u_max * d)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * nnz * d / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def compare_cif(hidden, alphas, u, what):
    """cif_fire_fwd against the plain cif_fire on the same inputs (the same
    c, so the same weights bit for bit; only the order of the sum
    differs): atol 1e-5, rtol 1e-5. -> max abs error."""
    from tpu_asr_torch.ops.cif import cif_fire
    from tpu_asr_torch.ops.cif_fire import cif_fire_fwd
    got = cif_fire_fwd(hidden, alphas, u)
    want = cif_fire(hidden, alphas, u)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **CIF_TOL):
        raise AssertionError(f"cif_fire at {what}: kernel disagrees with "
                             f"plain version (max abs diff "
                             f"{(got - want).abs().max().item()})")
    return (got - want).abs().max().item()


def time_cif(hidden, alphas, u, what):
    """cif_fire's times at one shape: the wrapper (cumsum + kernel), the
    kernel alone, the plain version, and one torch.bmm on the weight matrix
    W built beforehand; the bound from these inputs."""
    from tpu_asr_torch.ops.cif import cif_fire, cif_weights
    from tpu_asr_torch.ops.cif_fire import KERNEL_SYMBOL, cif_fire_fwd
    w_t = cif_weights(alphas, u).transpose(1, 2).contiguous()
    if not torch.allclose(torch.bmm(w_t, hidden), cif_fire(hidden, alphas, u),
                          **CIF_TOL):
        raise AssertionError(f"torch.bmm on W disagrees with cif_fire at "
                             f"{what}")
    ms = cuda_ms(lambda: cif_fire_fwd(hidden, alphas, u))
    alone = kernel_device_ms(lambda: cif_fire_fwd(hidden, alphas, u),
                             KERNEL_SYMBOL)
    plain = cuda_ms(lambda: cif_fire(hidden, alphas, u))
    library = cuda_ms(lambda: torch.bmm(w_t, hidden))
    bound, by = cif_bound_ms(hidden, alphas, u)
    log(f"cif_fire {what}: wrapper (cumsum + kernel) {ms:.4f} ms, the kernel "
        f"alone {ms4(alone)} ms (profiler), plain {plain:.4f} ms, torch.bmm "
        f"on a materialized W {library:.4f} ms, bound {bound * 1e3:.3f} us "
        f"({by})")
    return dict(ms=ms, kernel_device_ms=alone, plain_ms=plain,
                library_ms=library, bound_ms=bound, bound_by=by)


def check_cif_fire():
    """cif_fire_fwd against the plain cif_fire at serving-like, bench and
    ragged shapes; the autograd Function's gradients against autograd of
    the plain version. Times at the bench shape (B=32, T=249, D=512,
    U=25). The main paths' own inputs are held after they run
    (check_cif_fire_on_paths)."""
    cases = [  # (b, t, d, u_max, kind): serving's two buckets, bench, ragged
        (BATCH, 249, 512, 100, "serving"),
        (BATCH, 124, 512, 100, "serving"),
        (BATCH, 249, 512, 100, "padded"),
        (32, 249, 512, 25, "scaled"),
        (32, 249, 512, 25, "raw"),
        (8, 60, 512, 100, "big"),
        (9, 249, 512, 40, "zero_rows"),
        (4, 249, 512, 25, "few"),
        (5, 1, 512, 4, "big"),
        (6, 249, 512, 1, "raw"),
        (32, 249, 64, 25, "scaled"),
        (32, 249, 512, 200, "ulp"),
        # T past one shared-memory stage of c and c - alpha (2048 frames)
        (3, 3000, 512, 400, "scaled"),
    ]
    max_err, timing = 0.0, None
    for i, (b, t, d, u, kind) in enumerate(cases):
        hidden, alphas = cif_case(b, t, d, u, kind, SEED + i)
        what = f"B={b} T={t} D={d} U={u} {kind}"
        max_err = max(max_err, compare_cif(hidden, alphas, u, what))
        if kind == "ulp":
            log(f"cif_fire {what}: {disordered_weights(alphas, u)} non-zero "
                f"weights at frames whose c - alpha is below an earlier "
                f"frame's (held like every other weight)")
        if (b, t, d, u, kind) == (32, 249, 512, 25, "scaled"):
            timing = time_cif(hidden, alphas, u, what)
    log(f"cif_fire vs plain: {len(cases)} cases agree, max abs err "
        f"{max_err:.3e} (atol {CIF_TOL['atol']}, rtol {CIF_TOL['rtol']})")

    # gradients: the Function (kernel forward, plain backward) vs autograd
    hidden, alphas = cif_case(8, 249, 512, 25, "scaled", SEED)
    check_cif_grads(hidden, alphas, 25, "B=8 T=249 D=512 U=25 scaled")
    return max_err, timing


def check_cif_grads(hidden, alphas, u, what):
    from tpu_asr_torch.ops.cif import cif_fire
    from tpu_asr_torch.ops.cif_fire import cif_fire_kernel
    g = torch.randn(hidden.shape[0], u, hidden.shape[2], device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(SEED))
    grads = []
    for fire in (cif_fire_kernel, cif_fire):
        h = hidden.clone().requires_grad_(True)
        a = alphas.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fire(h, a, u) * g).sum(), (h, a)))
    grad_err = 0.0
    for name, got, want in zip(("hidden", "alphas"), *grads):
        if not torch.allclose(got, want, **CIF_TOL):
            raise AssertionError(f"cif_fire grad of {name} at {what} "
                                 f"disagrees: max abs diff "
                                 f"{(got - want).abs().max().item()}")
        grad_err = max(grad_err, (got - want).abs().max().item())
    log(f"cif_fire gradients (hidden, alphas) at {what} == autograd of the "
        f"plain version: max abs err {grad_err:.3e}")


@contextlib.contextmanager
def record_inputs(owner, name, captures, label):
    """While the main path runs, keep a copy of the positional inputs of
    the first call of owner.<name> (model.fire, or a kernel wrapper in the
    module that calls it) under each label(*args, **kwargs) that is not
    None, so the kernel is then held against its plain version on the
    path's own inputs. The call itself, and the wrapper's launch count,
    are unchanged."""
    fn = getattr(owner, name)
    own = name in vars(owner)          # a module's function, not a method

    def recording(*args, **kwargs):
        key = label(*args, **kwargs)   # None: a call not to keep
        if key is not None and key not in captures:
            captures[key] = tuple(a.detach().clone()
                                  if isinstance(a, torch.Tensor) else a
                                  for a in args)
        return fn(*args, **kwargs)

    # a kernel wrapper counts its launches on its module's name for it,
    # which is `recording` while this runs: its count goes back to fn
    counted = hasattr(fn, "launches")
    recording.launches = start = getattr(fn, "launches", 0)
    setattr(owner, name, recording)
    try:
        yield
    finally:
        if counted:
            fn.launches += recording.launches - start
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def check_cif_fire_on_paths(captures):
    """The kernel against its plain version, timed, on the inputs that CIF
    serving and CIF training gave model.fire (after both ran, so these
    launches are not counted). Training's inputs also check the
    gradients. -> (max abs err, {label: timings})."""
    max_err, timings = 0.0, {}
    for label, (hidden, alphas, u) in captures.items():
        hidden, alphas = hidden.clone(), alphas.clone()   # not inference
        b, t, d = hidden.shape
        fires = alphas.sum(-1)
        what = (f"{label}: B={b} T={t} D={d} U={u}, alphas sum to "
                f"{fires.min().item():.1f}-{fires.max().item():.1f}")
        max_err = max(max_err, compare_cif(hidden, alphas, u, what))
        timings[label] = dict(time_cif(hidden, alphas, u, what),
                              shape=f"B={b} T={t} D={d} U={u}")
        if "training" in label:
            check_cif_grads(hidden, alphas, u, what)
    log(f"cif_fire vs plain on the main paths' inputs: {len(captures)} "
        f"batches agree, max abs err {max_err:.3e}")
    return max_err, timings


# ---- phase 3: the flash attention and fused LayerNorm kernels ----

def flash_case(b, tq, tk, h, dh, dtype, lens, seed, packed=False):
    """q [B, Tq, H, dh], k/v [B, Tk, H, dh] and kv_valid [B, Tk] on the
    card; lens[i] valid keys in row i. packed (Tq = Tk): q, k and v are
    strided views of one [B, T, 3, H, dh] tensor, as a fused projection
    gives them."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.arange(tk)[None, :] < torch.as_tensor(lens)[:, None]
    if packed:
        qkv = torch.randn(b, tq, 3, h, dh, generator=g).to(DEVICE, dtype)
        return list(qkv.unbind(2)) + [valid.to(DEVICE)]
    q = torch.randn(b, tq, h, dh, generator=g)
    k = torch.randn(b, tk, h, dh, generator=g)
    v = torch.randn(b, tk, h, dh, generator=g)
    return [x.to(DEVICE, dtype) for x in (q, k, v)] + [valid.to(DEVICE)]


def flash_symbol(which, dtype):
    """A substring of the symbol of the kernel that a flash wrapper
    launches for `dtype` (which = "fwd", "dq" or "dkv"), for
    kernel_device_ms: it matches that kernel alone."""
    from tpu_asr_torch.ops.flash_attention import kernel_symbol
    return kernel_symbol(which, dtype, 64)


# bf16 cases for the wgmma kernels beside the served and training shapes,
# (b, tq, tk, h, dh, causal, lens, packed): dh 32 (64-byte swizzle), dh
# 128 (two panels; dk/dv on two warpgroups), Tq = 1 with Tk >= 600, a
# batch whose padding masks whole 64-key tiles, q/k/v as strided views of
# one [B, T, 3, H, dh]
WGMMA_CASES = [
    (4, 70, 90, 2, 32, False, [90, 41, 7, 0], False),
    (3, 90, 90, 2, 32, True, [90, 64, 0], True),
    (3, 70, 70, 4, 128, True, [70, 33, 0], False),
    (3, 100, 190, 2, 128, False, [190, 129, 0], False),
    (3, 1, 600, 2, 64, False, [600, 1, 0], False),
    (3, 1, 700, 2, 128, False, [700, 650, 0], False),
    (4, 101, 330, 8, 64, False, [330, 40, 64, 0], False),
    (4, 200, 200, 8, 64, True, [200, 130, 65, 0], True),
]


def flash_bound_ms(q, k, valid, causal):
    """Least time for the same work on an H100. Bytes: q and valid read
    once, the rows of k and v of the keys that valid lets through read
    once (the output depends on no other key), out and lse written once.
    Operations: 4 dh flops (QK^T and PV) per (query, key, head) that this
    data's mask lets through, at the bf16 tensor-core rate for bf16
    inputs, the float32 rate otherwise."""
    from tpu_asr_torch.ops.flash_attention import _mask
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    pairs = int(_mask(valid, causal, tq).expand(b, 1, tq, tk).sum()) * h
    keys = int(valid.sum())
    nbytes = (q.element_size() * 2 * h * dh * (b * tq + keys)
              + 4 * b * h * tq + b * tk)
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * dh * pairs / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def compare_flash(q, k, v, valid, causal, what):
    """flash_attention_fwd against its plain version: out within atol/rtol
    1e-5 in float32, 2e-2 in bf16; lse within 1e-4; rows whose keys are
    all masked give zeros and lse -1e30. -> (max abs err of out, of lse)."""
    from tpu_asr_torch.ops.flash_attention import (NEG_INF,
                                                   flash_attention_fwd,
                                                   flash_attention_reference)
    out, lse = flash_attention_fwd(q, k, v, valid, causal)
    w_out, w_lse = flash_attention_reference(q, k, v, valid, causal)
    torch.cuda.synchronize()
    tol = F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
    if not torch.allclose(out.float(), w_out.float(), **tol):
        raise AssertionError(f"flash attention out at {what}: kernel "
                             f"disagrees with plain version (max abs diff "
                             f"{(out.float() - w_out.float()).abs().max()})")
    g, w = lse.clamp(min=-1e31), w_lse.clamp(min=-1e31)
    if not torch.allclose(g, w, **LSE_TOL):
        raise AssertionError(f"flash attention lse at {what}: max abs diff "
                             f"{(g - w).abs().max().item()}")
    live = w > -1e29
    lse_err = (g - w).abs()[live].max().item() if live.any() else 0.0
    dead = ~valid.any(dim=1)
    if dead.any() and (out[dead].any() or (lse[dead] != NEG_INF).any()):
        raise AssertionError(f"flash attention at {what}: a row with every "
                             f"key masked is not zeros with lse -1e30")
    return (out.float() - w_out.float()).abs().max().item(), lse_err


def time_flash(q, k, v, valid, causal, what):
    """flash_attention_fwd's times at one shape: the wrapper, the kernel
    alone (profiler), the plain version, and one
    F.scaled_dot_product_attention call with the same boolean mask on
    [B, H, T, dh] copies made beforehand (a yardstick the port never
    calls; it is checked against the plain version on the rows with a
    valid key); the bound from these inputs."""
    import torch.nn.functional as F
    from tpu_asr_torch.ops.flash_attention import (_mask, flash_attention_fwd,
                                                   flash_attention_reference)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = _mask(valid, causal, q.shape[1])
    want = flash_attention_reference(q, k, v, valid, causal)[0]
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    b, tq, _, _ = q.shape
    live = mask.expand(b, 1, tq, k.shape[1]).any(dim=-1)[:, 0]   # [B, Tq]
    lib_err = (lib.transpose(1, 2)[live].float()
               - want[live].float()).abs().max().item()
    if lib_err > 0.1:
        raise AssertionError(f"scaled_dot_product_attention disagrees with "
                             f"the plain version at {what}: {lib_err}")
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, valid, causal))
    alone = kernel_device_ms(lambda: flash_attention_fwd(q, k, v, valid,
                                                         causal),
                             flash_symbol("fwd", q.dtype))
    plain = cuda_ms(lambda: flash_attention_reference(q, k, v, valid,
                                                      causal))
    library = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    bound, by = flash_bound_ms(q, k, valid, causal)
    log(f"flash_attention_fwd {what}: wrapper {ms:.4f} ms, the kernel alone "
        f"{ms4(alone)} ms (profiler), plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {library:.4f} ms (max abs diff to "
        f"plain {lib_err:.2e}), bound {bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, kernel_device_ms=alone, plain_ms=plain,
                library_ms=library, bound_ms=bound, bound_by=by)


def check_flash_attention():
    """flash_attention_fwd against its plain version at the served shapes
    (the aishell model's dh 64, bf16; the encoder of a 1000-frame bucket,
    the decoder pass over 8 x 10 hypotheses of 101 positions) with ragged
    key lengths and a length-0 row, at float32, dh 32 / 128, Tq = 1 and
    Tk >= 600, and at WGMMA_CASES. -> (max abs err out, max abs err lse,
    {shape: times})."""
    rng = np.random.default_rng(3)

    def ragged(b, tk):
        lens = rng.integers(1, tk + 1, b)
        lens[0], lens[-1] = tk, 0
        return lens.tolist()

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, tq, tk, h, dh, causal, dtype, lens, timed)
        (BATCH, 248, 248, 8, 64, False, bf16, ragged(BATCH, 248), True),
        (80, 101, 101, 8, 64, True, bf16, [101] * 80, True),
        (80, 101, 248, 8, 64, False, bf16, ragged(80, 248), True),
        (BATCH, 126, 126, 8, 64, False, bf16, ragged(BATCH, 126), False),
        (BATCH, 248, 248, 8, 64, False, f32, ragged(BATCH, 248), False),
        (80, 101, 101, 8, 64, True, f32, [101] * 80, False),
        (4, 33, 600, 8, 64, False, bf16, [600, 517, 3, 0], False),
        (3, 1, 600, 2, 32, False, f32, [600, 1, 0], False),
        (4, 24, 24, 2, 32, True, f32, [24, 24, 10, 0], False),
        (3, 70, 70, 4, 128, True, f32, [70, 33, 0], False),
    ]
    cases = [c + (False,) for c in cases] + [
        (b, tq, tk, h, dh, causal, bf16, lens, False, packed)
        for b, tq, tk, h, dh, causal, lens, packed in WGMMA_CASES]
    out_err = lse_err = 0.0
    timings = {}
    for i, (b, tq, tk, h, dh, causal, dt, lens, timed, packed) in \
            enumerate(cases):
        q, k, v, valid = flash_case(b, tq, tk, h, dh, dt, lens, SEED + i,
                                    packed)
        what = (f"B={b} Tq={tq} Tk={tk} H={h} dh={dh} "
                f"{'causal' if causal else 'key padding'} {dt}"
                f"{' packed q/k/v' if packed else ''}")
        oe, le = compare_flash(q, k, v, valid, causal, what)
        out_err, lse_err = max(out_err, oe), max(lse_err, le)
        if timed:
            timings[what] = time_flash(q, k, v, valid, causal, what)
    log(f"flash_attention_fwd vs plain: {len(cases)} cases agree, max abs "
        f"err out {out_err:.3e} (float32 atol/rtol {F32_TOL['atol']}, bf16 "
        f"{FLASH_BF16_TOL['atol']}), lse {lse_err:.3e} (atol "
        f"{LSE_TOL['atol']})")
    return out_err, lse_err, timings


def raw_bf16_ulps(got, want) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors, element by
    element (bit patterns of equal-signed values order like the values)."""
    def key(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((key(got) - key(want)).abs().max())


def ln_bound_ms(r):
    """Least time for the same work on an H100. Bytes: residual and h read
    once, out written once, gamma/beta read and mean/rstd written once.
    Operations: ~10 float32 operations an element (add, two reductions,
    centre, square, scale, affine) on the SIMT units."""
    d = r.shape[-1]
    rows = r.numel() // d
    nbytes = 3 * r.element_size() * rows * d + 8 * d + 8 * rows
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 10 * rows * d / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def compare_ln(r, h, g, b, what):
    """layer_norm_residual_fwd against its plain version: float32 within
    atol/rtol 1e-5, bf16 within one bf16 ulp at the output's scale
    (bf16_ulp_error); mean and rstd within 1e-5. -> (max abs err of out,
    bf16 ulp error at the output's scale, largest raw bf16 ulp distance)."""
    from tpu_asr_torch.ops.layernorm import (bf16_ulp_error,
                                             layer_norm_residual_fwd,
                                             layer_norm_residual_reference)
    got = layer_norm_residual_fwd(r, h, g, b)
    want = layer_norm_residual_reference(r, h, g, b)
    torch.cuda.synchronize()
    for name, x, w in zip(("mean", "rstd"), got[1:], want[1:]):
        if not torch.allclose(x, w, **F32_TOL):
            raise AssertionError(f"layer_norm_residual {name} at {what}: max "
                                 f"abs diff {(x - w).abs().max().item()}")
    out, w_out = got[0], want[0]
    ulp_err = raw = 0.0
    if r.dtype == torch.float32:
        if not torch.allclose(out, w_out, **F32_TOL):
            raise AssertionError(f"layer_norm_residual out at {what}: max abs"
                                 f" diff {(out - w_out).abs().max().item()}")
    else:
        ulp_err, raw = bf16_ulp_error(out, w_out), raw_bf16_ulps(out, w_out)
        if ulp_err > 1.0:
            raise AssertionError(f"layer_norm_residual out at {what}: "
                                 f"{ulp_err:.2f} bf16 ulps from the plain "
                                 f"version")
    return (out.float() - w_out.float()).abs().max().item(), ulp_err, raw


def time_ln(r, h, g, b, what):
    from tpu_asr_torch.ops.layernorm import (layer_norm_residual_fwd,
                                             layer_norm_residual_reference)
    ms = cuda_ms(lambda: layer_norm_residual_fwd(r, h, g, b))
    alone = kernel_device_ms(lambda: layer_norm_residual_fwd(r, h, g, b),
                             "layer_norm_residual_kernel")
    plain = cuda_ms(lambda: layer_norm_residual_reference(r, h, g, b))
    bound, by = ln_bound_ms(r)
    log(f"layer_norm_residual_fwd {what}: wrapper {ms:.4f} ms, the kernel "
        f"alone {ms4(alone)} ms (profiler), plain {plain:.4f} ms, bound "
        f"{bound * 1e3:.3f} us ({by}); no single torch call adds and "
        f"normalizes, so no library time")
    return dict(ms=ms, kernel_device_ms=alone, plain_ms=plain,
                library_ms=None, bound_ms=bound, bound_by=by)


def check_layer_norm():
    """layer_norm_residual_fwd against its plain version at the served row
    counts (bf16, D 512: the decoder pass's 8080 rows, the encoder's 1984
    and 1008), and float32 / other D at ragged row counts."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (rows, d, dtype, timed)
        (8080, 512, bf16, True), (1984, 512, bf16, True),
        (1008, 512, bf16, False), (1984, 512, f32, False),
        (511, 512, f32, False), (1000, 64, f32, False), (1, 64, f32, False),
        (7, 2048, bf16, False), (513, 96, bf16, False),
    ]
    err = ulps = 0.0
    raw = 0
    timings = {}
    for i, (rows, d, dt, timed) in enumerate(cases):
        g = torch.Generator().manual_seed(SEED + i)
        r, h = (torch.randn(rows, d, generator=g).to(DEVICE, dt)
                for _ in range(2))
        gamma = (1 + 0.5 * torch.randn(d, generator=g)).to(DEVICE)
        beta = torch.randn(d, generator=g).to(DEVICE)
        what = f"rows={rows} D={d} {dt}"
        e, u, w = compare_ln(r, h, gamma, beta, what)
        err, ulps, raw = max(err, e), max(ulps, u), max(raw, w)
        if timed:
            timings[what] = time_ln(r, h, gamma, beta, what)
    log(f"layer_norm_residual_fwd vs plain: {len(cases)} cases agree, max "
        f"abs err {err:.3e}; bf16 within {ulps:.3f} ulp at the output's "
        f"scale (largest raw ulp distance {raw}, at outputs near 0)")
    return err, ulps, raw, timings


def check_flash_ln_on_paths(flash_caps, ln_caps):
    """Both kernels against their plain versions, timed, on the inputs the
    use_pallas serving path gave them (after its counts were read).
    -> ({label: flash timings}, {label: LN timings}, errors)."""
    errs = dict(flash=0.0, lse=0.0, ln=0.0, ln_ulps=0.0, ln_raw=0)
    flash_t, ln_t = {}, {}
    for label, (q, k, v, valid, causal) in flash_caps.items():
        what = (f"{label}: q {list(q.shape)} k {list(k.shape)} {q.dtype}, "
                f"{int(valid.sum(1).min())}-{int(valid.sum(1).max())} "
                f"valid keys a row")
        oe, le = compare_flash(q, k, v, valid, causal, what)
        errs["flash"], errs["lse"] = max(errs["flash"], oe), max(errs["lse"],
                                                                  le)
        flash_t[label] = dict(time_flash(q, k, v, valid, causal, what),
                              shape=what)
    for label, (r, h, g, b, _eps) in ln_caps.items():
        what = f"{label}: {list(r.shape)} {r.dtype}"
        e, u, w = compare_ln(r, h, g, b, what)
        errs["ln"], errs["ln_ulps"] = max(errs["ln"], e), max(errs["ln_ulps"],
                                                              u)
        errs["ln_raw"] = max(errs["ln_raw"], w)
        ln_t[label] = dict(time_ln(r, h, g, b, what), shape=what)
    log(f"flash_attention_fwd and layer_norm_residual_fwd vs plain on the "
        f"use_pallas serving path's inputs: {len(flash_caps)} + "
        f"{len(ln_caps)} calls agree: " + json.dumps(errs))
    return flash_t, ln_t, errs


# ---- phase 3: the backward kernels (flash dq, dk/dv; LN) ----

def cosine(a, b) -> float:
    """Cosine similarity of two tensors as flat float64 vectors: how a
    library call's gradient is held to the plain one. Gradients of real
    inputs are sums that cancel (a softmax row's ds sums to 0), where the
    library's other rounding points move small entries by a large part of
    their size, but not the vector's direction."""
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-300))


def flash_bwd_bound_ms(q, k, valid, causal, which):
    """Least time for the same work on an H100. Bytes: q, dO, lse, delta
    and valid read once, the rows of k and v of the keys that valid lets
    through read once (no gradient depends on another key's), every row
    of dq (which="dq") or of dk and dv ("dkv") written once. Operations
    per (query, key, head) that this data's mask lets through: s, dp and
    ds K (6 dh flops) for dq; s, dp, p^T dO and ds^T q (8 dh) for dk/dv;
    at the bf16 tensor-core rate for bf16 inputs, the float32 rate
    otherwise."""
    from tpu_asr_torch.ops.flash_attention import _mask
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    pairs = int(_mask(valid, causal, tq).expand(b, 1, tq, tk).sum()) * h
    e = q.element_size()
    keys = int(valid.sum())
    read = e * h * dh * (2 * b * tq + 2 * keys) + 8 * b * h * tq + b * tk
    written = e * h * dh * (b * tq if which == "dq" else 2 * b * tk)
    flops = (6 if which == "dq" else 8) * dh * pairs
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def flash_bwd_inputs(q, k, v, valid, causal, seed):
    """What FlashAttentionFunction's backward receives: the forward
    kernel's out and lse, and an output gradient dO (seeded)."""
    from tpu_asr_torch.ops.flash_attention import flash_attention_fwd
    out, lse = flash_attention_fwd(q, k, v, valid, causal)
    g = torch.Generator().manual_seed(seed)
    dout = torch.randn(q.shape, generator=g).to(DEVICE, q.dtype)
    return out, dout, lse


def rounding_flips(q, k, v, out, dout, lse, valid, causal, got):
    """What the summation order of the scores alone does to bf16
    gradients. The kernels' own rounded p and ds cannot be read out, so
    the plain backward's terms (float32 dots s and dp, rounded to bf16) are
    set against the same terms from exact dots (float64): how many of the
    rounded p and ds terms that the mask lets through round the other way;
    and dq, dk, dv built from the exact-dot terms (float64 sums, rounded to
    bf16), in bf16 ulps at the gradient's scale from the plain backward's
    and from the kernels' (`got`). -> {"terms", "p_flips", "ds_flips",
    "plain_ulps": {name: ulps}, "kernel_ulps": {name: ulps}}."""
    from tpu_asr_torch.ops.flash_attention import (
        NEG_INF, _mask, flash_attention_bwd_reference, flash_attention_delta)
    from tpu_asr_torch.ops.layernorm import bf16_ulp_error
    scale = 1.0 / q.shape[-1] ** 0.5
    mask = _mask(valid, causal, q.shape[1])
    delta = flash_attention_delta(out, dout)[..., None]
    m = lse.clamp(min=NEG_INF / 2)[..., None]
    terms = {}
    for dt in (torch.float32, torch.float64):
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)) * scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m.to(dt)))
        dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(dt), v.to(dt))
        ds = p * (dp - delta.to(dt)) * scale
        terms[dt] = (p.to(q.dtype), ds.to(q.dtype))
    (p32, ds32), (p64, ds64) = terms[torch.float32], terms[torch.float64]
    live = mask.expand_as(p32)
    exact = [torch.einsum(eq, a.double(), b.double()).to(q.dtype)
             for eq, a, b in (("bhqk,bkhd->bqhd", ds64, k),
                              ("bhqk,bqhd->bkhd", ds64, q),
                              ("bhqk,bqhd->bkhd", p64, dout))]
    plain = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid,
                                          causal)
    names = ("dq", "dk", "dv")
    return dict(
        terms=int(live.sum()),
        p_flips=int(((p32 != p64) & live).sum()),
        ds_flips=int(((ds32 != ds64) & live).sum()),
        plain_ulps={n: bf16_ulp_error(w, x, floor=1.0)
                    for n, w, x in zip(names, plain, exact)},
        kernel_ulps={n: bf16_ulp_error(g, x, floor=1.0)
                     for n, g, x in zip(names, got, exact)})


def compare_flash_bwd(q, k, v, out, dout, lse, valid, causal, what):
    """dq, dk, dv of the kernels against the plain backward: float32
    within atol 1e-5 / rtol 1e-4, bf16 within one bf16 ulp at the
    gradient's scale (the ulp of its largest magnitude: ds and p are
    rounded to bf16 before their products on both sides, and where the
    two float32 scores differ in their last bit such a rounding may flip,
    moving a sum by an ulp of one term); a query row whose keys are all
    masked and a masked key get exactly 0. -> {name: (max abs err, bf16
    ulps at the gradient's scale)}."""
    from tpu_asr_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference)
    from tpu_asr_torch.ops.layernorm import bf16_ulp_error
    got = flash_attention_bwd(q, k, v, out, dout, lse, valid, causal)
    want = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid,
                                         causal)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"flash {name} at {what}: {g.dtype} "
                                 f"{tuple(g.shape)}, want {w.dtype} "
                                 f"{tuple(w.shape)}")
        ulps = 0.0
        if q.dtype == torch.float32:
            ok = torch.allclose(g, w, **F32_GRAD_TOL)
        else:
            ulps = bf16_ulp_error(g, w, floor=1.0)
            ok = ulps <= 1.0
        err = (g.float() - w.float()).abs().max().item()
        if not ok:
            raise AssertionError(f"flash {name} at {what}: kernel disagrees "
                                 f"with the plain backward (max abs diff "
                                 f"{err}, {ulps:.2f} bf16 ulps)")
        errs[name] = (err, ulps)
    dead = ~valid.any(dim=1)
    if got[0][dead].any() or got[1][~valid].any() or got[2][~valid].any():
        raise AssertionError(f"flash backward at {what}: a masked row or "
                             f"key has a nonzero gradient")
    if max(u for _, u in errs.values()) >= FLIP_REPORT_ULPS:
        log(f"flash backward at {what} reads near its one-ulp bound "
            f"({ {n: u for n, (_, u) in errs.items()} }); bf16 terms "
            f"rounding the other way with exact scores: " + json.dumps(
                rounding_flips(q, k, v, out, dout, lse, valid, causal, got)))
    return errs


def time_flash_bwd(q, k, v, out, dout, lse, valid, causal, what):
    """The backward kernels' times at one shape: each wrapper (CUDA
    events), each kernel alone (profiler), the whole backward (delta and
    both kernels), the plain backward, and one torch.autograd.grad of
    F.scaled_dot_product_attention with the same boolean mask on
    [B, H, T, dh] copies, its forward outside the timed region (a
    yardstick the port never calls; its dq is checked against the plain
    version on the rows with a valid key, by cosine); the bounds from
    these inputs. -> {"dq": times, "dkv": times}."""
    import torch.nn.functional as F
    from tpu_asr_torch.ops.flash_attention import (
        _mask, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_reference,
        flash_attention_delta)
    delta = flash_attention_delta(out, dout).contiguous()
    want = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid,
                                         causal)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    mask = _mask(valid, causal, q.shape[1])
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_dq = library()[0].transpose(1, 2)
    b, tq, _, _ = q.shape
    live = mask.expand(b, 1, tq, k.shape[1]).any(dim=-1)[:, 0]   # [B, Tq]
    lib_err = (lib_dq[live].float() - want[0][live].float()).abs().max()
    cos = cosine(lib_dq[live], want[0][live])
    if not cos >= 0.99:
        raise AssertionError(f"scaled_dot_product_attention's dq disagrees "
                             f"with the plain backward at {what}: cosine "
                             f"{cos}, max abs diff {lib_err}")
    library_ms = cuda_ms(library)
    plain = cuda_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, dout, lse, valid, causal))
    whole = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse,
                                              valid, causal))
    times = {}
    for which, fn in (
            ("dq", lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                  valid, causal)),
            ("dkv", lambda: flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                    delta, valid, causal))):
        bound, by = flash_bwd_bound_ms(q, k, valid, causal, which)
        times[which] = dict(
            ms=cuda_ms(fn),
            kernel_device_ms=kernel_device_ms(
                fn, flash_symbol(which, q.dtype)),
            plain_ms=plain, library_ms=library_ms, bound_ms=bound,
            bound_by=by, backward_ms=whole)
        t = times[which]
        log(f"flash_attention_bwd_{which} {what}: wrapper {t['ms']:.4f} ms,"
            f" the kernel alone {ms4(t['kernel_device_ms'])} ms (profiler), "
            f"bound {bound * 1e3:.3f} us ({by})")
    log(f"flash backward {what}: delta + both kernels {whole:.4f} ms, plain "
        f"backward {plain:.4f} ms, autograd.grad of "
        f"scaled_dot_product_attention {library_ms:.4f} ms (dq max abs "
        f"diff to plain {lib_err:.2e}, cosine {cos:.6f})")
    return times


def check_flash_bwd():
    """The dq and dk/dv kernels against the plain backward at the training
    shapes (aishell, fixed shape feats [32, 1000, 80], U = 24: encoder
    self-attention [32, 249] x [32, 249], decoder causal self-attention
    [32, 25], cross-attention [32, 25] x [32, 249]; h8 dh64 bf16, timed),
    and at ragged key lengths with a length-0 row, Tq != Tk, Tk >= 600,
    dh 32 / 128, float32 and bf16, and at WGMMA_CASES. -> (errors,
    {shape: times})."""
    rng = np.random.default_rng(5)

    def ragged(b, tk):
        lens = rng.integers(1, tk + 1, b)
        lens[0], lens[-1] = tk, 0
        return lens.tolist()

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, tq, tk, h, dh, causal, dtype, lens, timed)
        (32, 249, 249, 8, 64, False, bf16, [249] * 32, True),
        (32, 25, 25, 8, 64, True, bf16, [25] * 32, True),
        (32, 25, 249, 8, 64, False, bf16, [249] * 32, True),
        (32, 249, 249, 8, 64, False, bf16, ragged(32, 249), False),
        (32, 25, 25, 8, 64, True, bf16, ragged(32, 25), False),
        (8, 249, 249, 8, 64, False, f32, ragged(8, 249), False),
        (8, 25, 249, 8, 64, False, f32, ragged(8, 249), False),
        (4, 33, 600, 8, 64, False, bf16, [600, 517, 3, 0], False),
        (3, 1, 600, 2, 32, False, f32, [600, 1, 0], False),
        (4, 24, 24, 2, 32, True, f32, [24, 24, 10, 0], False),
        (3, 70, 70, 4, 128, True, f32, [70, 33, 0], False),
        (3, 100, 40, 2, 64, True, bf16, [40, 17, 0], False),
    ]
    cases = [c + (False,) for c in cases] + [
        (b, tq, tk, h, dh, causal, bf16, lens, False, packed)
        for b, tq, tk, h, dh, causal, lens, packed in WGMMA_CASES]
    errs = {n: [0.0, 0.0] for n in ("dq", "dk", "dv")}
    timings = {}
    for i, (b, tq, tk, h, dh, causal, dt, lens, timed, packed) in \
            enumerate(cases):
        q, k, v, valid = flash_case(b, tq, tk, h, dh, dt, lens,
                                    SEED + 50 + i, packed)
        out, dout, lse = flash_bwd_inputs(q, k, v, valid, causal, SEED + i)
        what = (f"B={b} Tq={tq} Tk={tk} H={h} dh={dh} "
                f"{'causal' if causal else 'key padding'} {dt}"
                f"{' packed q/k/v' if packed else ''}")
        for name, (e, u) in compare_flash_bwd(q, k, v, out, dout, lse, valid,
                                              causal, what).items():
            errs[name] = [max(errs[name][0], e), max(errs[name][1], u)]
        if timed:
            timings[what] = time_flash_bwd(q, k, v, out, dout, lse, valid,
                                           causal, what)
    log(f"flash_attention_bwd_dq / _dkv vs the plain backward: {len(cases)} "
        f"cases agree, max abs err and bf16 ulps at the gradient's scale: "
        f"{json.dumps(errs)} (float32 atol {F32_GRAD_TOL['atol']} rtol "
        f"{F32_GRAD_TOL['rtol']}; bf16 one ulp)")
    return errs, timings


def ln_bwd_bound_ms(r):
    """Least time for the same work on an H100. Bytes: residual, h and dy
    read once, dx written once; gamma, mean and rstd read and dgamma,
    dbeta written once. Operations: ~14 float32 operations an element
    (the add, x_hat, a, two row sums, two column sums, dx) on the SIMT
    units."""
    d = r.shape[-1]
    rows = r.numel() // d
    nbytes = 4 * r.element_size() * rows * d + 12 * d + 8 * rows
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 14 * rows * d / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def compare_ln_bwd(r, h, g, mean, rstd, dy, what):
    """layer_norm_residual_bwd against the plain backward: dx float32
    within atol 1e-5 / rtol 1e-4, bf16 within one bf16 ulp at its scale;
    dgamma and dbeta (float32 sums over the rows, in another order) within
    1e-5 of their largest magnitude. -> (max abs err of dx, bf16 ulps,
    max error of dgamma/dbeta relative to their largest magnitude)."""
    from tpu_asr_torch.ops.layernorm import (bf16_ulp_error,
                                             layer_norm_residual_bwd,
                                             layer_norm_residual_bwd_reference)
    got = layer_norm_residual_bwd(r, h, g, mean, rstd, dy)
    want = layer_norm_residual_bwd_reference(r, h, g, mean, rstd, dy)
    torch.cuda.synchronize()
    dx, w_dx = got[0], want[0]
    ulps = 0.0
    if r.dtype == torch.float32:
        ok = torch.allclose(dx, w_dx, **F32_GRAD_TOL)
    else:
        ulps = bf16_ulp_error(dx, w_dx)
        ok = ulps <= 1.0
    err = (dx.float() - w_dx.float()).abs().max().item()
    if not ok or dx.dtype != r.dtype:
        raise AssertionError(f"layer_norm_residual_bwd dx at {what}: max abs "
                             f"diff {err}, {ulps:.2f} bf16 ulps")
    rel = 0.0
    for name, x, w in zip(("dgamma", "dbeta"), got[1:], want[1:]):
        e = ((x - w).abs().max() / w.abs().max()).item()
        if not e <= 1e-5:
            raise AssertionError(f"layer_norm_residual_bwd {name} at {what}:"
                                 f" {e:.2e} of its largest magnitude")
        rel = max(rel, e)
    return err, ulps, rel


def time_ln_bwd(r, h, g, mean, rstd, dy, what):
    """The LN backward's times: the wrapper and the kernel alone
    (profiler), each with its inputs warm in L2 and with L2 flushed before
    every call, the plain backward, and one
    torch.ops.aten.native_layer_norm_backward on x = residual + h (made
    beforehand, in the input dtype) with the forward's mean and rstd (a
    yardstick the port never calls; its dx is checked against the plain
    version, by cosine); the bound from these inputs. Fails unless a call
    leaves one device event, the kernel's, in a profiler trace."""
    from tpu_asr_torch.ops.layernorm import (layer_norm_residual_bwd,
                                             layer_norm_residual_bwd_reference)
    d = r.shape[-1]
    x = (r.float() + h.float()).to(r.dtype)
    gt = g.to(r.dtype)
    bias = torch.zeros_like(gt)
    m2, r2 = mean.reshape(-1, 1), rstd.reshape(-1, 1)

    def library():
        return torch.ops.aten.native_layer_norm_backward(
            dy, x, [d], m2, r2, gt, bias, [True, True, True])
    want = layer_norm_residual_bwd_reference(r, h, g, mean, rstd, dy)[0]
    lib_dx = library()[0]
    lib_err = (lib_dx.float() - want.float()).abs().max()
    cos = cosine(lib_dx, want)
    if not cos >= 0.99:
        raise AssertionError(f"native_layer_norm_backward's dx disagrees "
                             f"with the plain backward at {what}: cosine "
                             f"{cos}, max abs diff {lib_err}")
    fn = lambda: layer_norm_residual_bwd(r, h, g, mean, rstd, dy)  # noqa: E731
    symbol = "layer_norm_residual_bwd_kernel"
    reps = 10
    events = device_events(fn, symbol, reps)
    ours = sum(n for k, n in events.items() if symbol in k)
    if ours != sum(events.values()) or ours > reps:
        raise AssertionError(f"layer_norm_residual_bwd at {what}: {reps} "
                             f"calls left device events {events}, not one "
                             f"kernel a call")
    ms = cuda_ms(fn)
    alone = kernel_device_ms(fn, symbol)
    ms_cold = cuda_ms(fn, flush=flush_l2)
    alone_cold = kernel_device_ms(fn, symbol, flush=flush_l2)
    plain = cuda_ms(lambda: layer_norm_residual_bwd_reference(
        r, h, g, mean, rstd, dy))
    library_ms = cuda_ms(library)
    bound, by = ln_bwd_bound_ms(r)
    log(f"layer_norm_residual_bwd {what}: wrapper {ms:.4f} ms ({ms_cold:.4f}"
        f" ms with L2 flushed), the kernel alone {ms4(alone)} ms "
        f"({ms4(alone_cold)} ms with L2 flushed; profiler, {ours} of {reps} "
        f"calls traced, no other device event), plain {plain:.4f} ms, "
        f"native_layer_norm_backward {library_ms:.4f} ms (dx max abs diff "
        f"to plain {lib_err:.2e}, cosine {cos:.6f}), bound "
        f"{bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, kernel_device_ms=alone, ms_l2_flushed=ms_cold,
                kernel_device_ms_l2_flushed=alone_cold, plain_ms=plain,
                library_ms=library_ms, bound_ms=bound, bound_by=by,
                device_events=events)


def check_ln_bwd():
    """layer_norm_residual_bwd against the plain backward at the training
    row counts (bf16, D 512: the encoder's 32 x 249 = 7968 rows and the
    decoder's 32 x 25 = 800, timed), and at 1-8080 rows, D 64-2048,
    float32 and bf16; mean and rstd from the forward kernel. -> (errors,
    {shape: times})."""
    from tpu_asr_torch.ops.layernorm import layer_norm_residual_fwd
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (rows, d, dtype, timed)
        (7968, 512, bf16, True), (800, 512, bf16, True),
        (7968, 512, f32, False), (8080, 512, bf16, False),
        (511, 512, f32, False), (1000, 64, f32, False), (1, 64, f32, False),
        (7, 2048, bf16, False), (33, 2048, f32, False), (513, 96, bf16, False),
    ]
    errs = dict(dx=0.0, dx_bf16_ulps=0.0, dgamma_dbeta_rel=0.0)
    timings = {}
    for i, (rows, d, dt, timed) in enumerate(cases):
        g = torch.Generator().manual_seed(SEED + 70 + i)
        r, h, dy = (torch.randn(rows, d, generator=g).to(DEVICE, dt)
                    for _ in range(3))
        gamma = (1 + 0.5 * torch.randn(d, generator=g)).to(DEVICE)
        beta = torch.randn(d, generator=g).to(DEVICE)
        _, mean, rstd = layer_norm_residual_fwd(r, h, gamma, beta)
        what = f"rows={rows} D={d} {dt}"
        e, u, rel = compare_ln_bwd(r, h, gamma, mean, rstd, dy, what)
        errs = dict(dx=max(errs["dx"], e),
                    dx_bf16_ulps=max(errs["dx_bf16_ulps"], u),
                    dgamma_dbeta_rel=max(errs["dgamma_dbeta_rel"], rel))
        if timed:
            timings[what] = time_ln_bwd(r, h, gamma, mean, rstd, dy, what)
    log(f"layer_norm_residual_bwd vs the plain backward: {len(cases)} cases "
        f"agree: {json.dumps(errs)}")
    return errs, timings


def check_bwd_on_paths(bwd_caps):
    """The backward kernels against the plain backward, timed, on the
    inputs that use_pallas training gave them (the first train batch of
    each bucket, recorded as the Functions' backward received them, after
    the run's counts were read). -> ({label: {"dq", "dkv": times}},
    {label: LN times}, errors)."""
    errs = dict(flash={n: [0.0, 0.0] for n in ("dq", "dk", "dv")},
                ln=dict(dx=0.0, dx_bf16_ulps=0.0, dgamma_dbeta_rel=0.0))
    flash_t, ln_t = {}, {}
    for label, (q, k, v, out, dout, lse, valid, causal) in \
            bwd_caps["flash"].items():
        what = (f"use_pallas training, {label} {q.dtype}, "
                f"{int(valid.sum(1).min())}-{int(valid.sum(1).max())} valid "
                f"keys a row")
        for name, (e, u) in compare_flash_bwd(q, k, v, out, dout, lse, valid,
                                              causal, what).items():
            errs["flash"][name] = [max(errs["flash"][name][0], e),
                                   max(errs["flash"][name][1], u)]
        flash_t[label] = {
            which: dict(t, shape=f"use_pallas training, {label} {q.dtype}")
            for which, t in time_flash_bwd(q, k, v, out, dout, lse, valid,
                                           causal, what).items()}
    for label, (r, h, g, mean, rstd, dy) in bwd_caps["ln"].items():
        what = f"use_pallas training, {label} {r.dtype}"
        e, u, rel = compare_ln_bwd(r, h, g, mean, rstd, dy, what)
        errs["ln"] = dict(dx=max(errs["ln"]["dx"], e),
                          dx_bf16_ulps=max(errs["ln"]["dx_bf16_ulps"], u),
                          dgamma_dbeta_rel=max(
                              errs["ln"]["dgamma_dbeta_rel"], rel))
        ln_t[label] = dict(time_ln_bwd(r, h, g, mean, rstd, dy, what),
                           shape=what)
    if not flash_t or not ln_t:
        raise AssertionError(f"use_pallas training recorded no backward "
                             f"inputs: {len(flash_t)} flash, {len(ln_t)} LN")
    log(f"backward kernels vs the plain backward on use_pallas training's "
        f"inputs: {len(flash_t)} flash + {len(ln_t)} LN calls agree: "
        + json.dumps(errs))
    return flash_t, ln_t, errs


def check_ctc_on_paths(prefix_caps, ctc_caps):
    """ctc_prefix_scan on the inputs the joint beam gave it (each bucket's
    first call and a later one), and ctc_loss_fwd and ctc_loss_bwd on the
    first backward's inputs of each training (recorded while the paths
    ran, after their counts were read; the forward's are the first five,
    and its alpha and nll must equal the path's forward's bit for bit),
    against their plain versions, timed and bounded. -> ({label: prefix
    timings}, {label: {"fwd": forward timings, "bwd": backward
    timings}}, errors)."""
    errs = dict(prefix=0.0, fwd=0.0, bwd=0.0)
    prefix_t, ctc_t = {}, {}
    for label, args in prefix_caps.items():
        lengths = args[6]
        what = (f"{label}: N={args[0].shape[0]} T={args[0].shape[1]} "
                f"K={args[0].shape[2]}, lengths {int(lengths.min())}-"
                f"{int(lengths.max())}")
        errs["prefix"] = max(errs["prefix"], compare_prefix(list(args), what))
        prefix_t[label] = dict(time_prefix(list(args), True, what),
                               shape=what)
    bitwise = 0
    for label, args in ctc_caps.items():
        emissions, skip, valid, ilen, llen, alpha, nll = args
        what = (f"{label} (S={emissions.shape[2]}), ilen "
                f"{int(ilen.min())}-{int(ilen.max())}")
        got, _, err, same = compare_ctc_fwd(args[:5], what)
        if not (torch.equal(got[0], nll) and torch.equal(got[1], alpha)):
            raise AssertionError(f"ctc_loss_fwd at {what}: not the bits the "
                                 f"path's forward gave")
        errs["fwd"] = max(errs["fwd"], err)
        bitwise += same
        errs["bwd"] = max(errs["bwd"], compare_ctc_bwd(
            args[:5], alpha, nll, what))
        ctc_t[label] = {name: dict(time_ctc(args[:5], alpha, nll, backward,
                                            what), shape=what)
                        for name, backward in (("fwd", False),
                                               ("bwd", True))}
    if not prefix_t or len(ctc_t) != 3:
        raise AssertionError(f"the paths recorded {len(prefix_t)} prefix "
                             f"scans and {len(ctc_t)} CTC backwards (3 "
                             f"trainings)")
    log(f"ctc_prefix_scan, ctc_loss_fwd and ctc_loss_bwd vs plain on the "
        f"main paths' inputs: {len(prefix_t)} + {len(ctc_t)} + "
        f"{len(ctc_t)} calls agree (the forward's nll and alpha the plain "
        f"version's bits in {bitwise} of {len(ctc_t)}): " + json.dumps(errs))
    return prefix_t, ctc_t, errs


# ---- phases 4-7 ----

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


def kernel_counters():
    """{name: wrapper} of every kernel of the port, by the name the
    kernels line gives it."""
    from tpu_asr_torch.ops import (cif_fire, ctc_loss, ctc_prefix,
                                   flash_attention as fa, layernorm as ln)
    return {"ctc_prefix_scan": ctc_prefix.ctc_prefix_scan,
            "ctc_loss_fwd": ctc_loss.ctc_loss_fwd,
            "ctc_loss_bwd": ctc_loss.ctc_loss_bwd,
            "cif_fire": cif_fire.cif_fire_fwd,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "layer_norm_residual_fwd": ln.layer_norm_residual_fwd,
            "layer_norm_residual_bwd": ln.layer_norm_residual_bwd}


def train_batch(rng, b, t, flens, tlens, u, v=64):
    """feats [b, t, 80] with the given lengths, targets [b, u] padded."""
    targets = np.full((b, u), -1, np.int32)
    for i, n in enumerate(tlens):
        targets[i, :n] = rng.integers(2, v - 2, n)
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.asarray(flens, np.int32), "targets": targets,
            "target_lengths": np.asarray(tlens, np.int32)}


def pallas_train_batch(rng):
    """16 utterances of up to 527 frames (one of length 0; T' = 131, so
    2096 encoder rows) with 2-31 tokens padded to U = 31 (U + 1 = 32, so
    512 decoder rows): every post-norm block takes the fused LN."""
    flens = rng.integers(300, 528, 16)
    flens[0], flens[-1] = 527, 0
    tlens = rng.integers(2, 32, 16)
    tlens[0], tlens[-1] = 31, 0
    return train_batch(rng, 16, 527, flens, tlens, 31)


def train_on_both(model_cls, cfg, batch, steps):
    """`steps` TrainSteps from the same seeded init on one batch, on the
    card and on the CPU. -> {"card" | "cpu": (metrics of each step, step
    1's update, kernel launches)}."""
    from tpu_asr_torch.train import NoamAdam, TrainStep
    from tpu_asr_torch.weights import init_random
    out = {}
    for key, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = init_random(model_cls(cfg), SEED).to(dev)
        ts = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model, 100),
                       device=dev, seed=SEED)
        p0 = torch.cat([p.detach().flatten() for p in model.parameters()])
        counters = kernel_counters()
        before = {k: f.launches for k, f in counters.items()}
        metrics, update = [], None
        for _ in range(steps):
            metrics.append({k: float(v) for k, v in ts(batch).items()})
            if update is None:
                update = torch.cat([p.detach().flatten() for p in
                                    model.parameters()]).cpu() - p0.cpu()
        out[key] = (metrics, update, {k: f.launches - before[k]
                                      for k, f in counters.items()})
    return out


def check_train_agreement(use_pallas=False):
    """hybrid_dev in float32 (dropout 0, no SpecAugment): two TrainSteps
    from the same init on one batch on the card (the kernels) and on the
    CPU (their plain versions). Step 1's losses and raw grad norm, the
    update it applies (clip, Adam, Noam lr), and step 2's losses agree.
    With use_pallas the batch puts >= 512 rows through the encoder and the
    decoder, and every kernel of the Functions (flash forward, dq, dk/dv;
    LN forward and backward) launches once per attention or post-norm
    block and step on the card, never on the CPU."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.train import noam_schedule

    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64,
                              use_pallas=use_pallas)
    rng = np.random.default_rng(SEED)
    batch = (pallas_train_batch(rng) if use_pallas else
             train_batch(rng, 4, 200, [200, 151, 0, 97], [8, 5, 0, 3], 8))
    runs = train_on_both(Transformer, cfg, batch, 2)
    (card, card2), (cpu, cpu2) = (runs[d][0] for d in ("card", "cpu"))
    what = "use_pallas " if use_pallas else ""
    losses = ("loss", "loss_att", "loss_ctc", "acc")
    bad = [k for k in losses if abs(card[k] - cpu[k]) > 1e-4]
    bad += [f"step 2 {k}" for k in losses if abs(card2[k] - cpu2[k]) > 1e-4]
    if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
            1e-3 * abs(cpu["grad_norm"]):
        raise AssertionError(f"{what}train step on the card {card} {card2} "
                             f"!= on the CPU {cpu} {cpu2}: {bad}")
    # Adam's first update is about lr * sign(g) per weight; a gradient
    # near 0 may round to either sign, so hold 99% of the entries, not all.
    lr = noam_schedule(cfg.d_model, 100)(0)
    near = 0.1 * lr
    update = {d: runs[d][1] for d in runs}
    agree = ((update["card"] - update["cpu"]).abs() <= near).float().mean()
    noop = (update["cpu"].abs() <= near).float().mean()
    if not agree >= 0.99 > noop:
        raise AssertionError(f"{what}update on the card != on the CPU: "
                             f"{agree:.6f} of the entries within 0.1 lr "
                             f"({noop:.6f} for a no-op update)")
    launches = runs["card"][2]
    if use_pallas:
        n_attn = cfg.num_enc_layers + 2 * cfg.num_dec_layers
        n_ln = 2 * cfg.num_enc_layers + 3 * cfg.num_dec_layers
        expect = {"flash_attention_fwd": 2 * n_attn,
                  "flash_attention_bwd_dq": 2 * n_attn,
                  "flash_attention_bwd_dkv": 2 * n_attn,
                  "layer_norm_residual_fwd": 2 * n_ln,
                  "layer_norm_residual_bwd": 2 * n_ln}
        got = {k: launches[k] for k in expect}
        if got != expect or any(runs["cpu"][2].values()):
            raise AssertionError(f"use_pallas train agreement launches: card "
                                 f"{launches}, expected {expect}; CPU "
                                 f"{runs['cpu'][2]}")
    log(f"agreement: hybrid_dev {what}train step on the card == on the CPU "
        "(losses of steps 1 and 2 within 1e-4, grad norm within 1e-3 "
        "relative, >= 99% of the update within 0.1 lr): "
        + json.dumps({"step1": {k: [card[k], cpu[k]] for k in sorted(card)},
                      "step2": {k: [card2[k], cpu2[k]] for k in losses},
                      "update_within_0.1lr": float(agree),
                      "noop_within_0.1lr": float(noop),
                      "card_launches": {k: n for k, n in launches.items()
                                        if n}}))


def check_cif_agreement():
    """cif_dev in float32 (dropout 0): the same batch decodes to the same
    tokens on the card (the CIF kernel) and on the CPU (its plain
    version) in cif_greedy and cif_beam; one TrainStep from the same init
    gives losses within 1e-4 and grad norms within 1e-3 relative, without
    and with use_pallas."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.cif import CifModel
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("cif_dev").model, vocab_size=64)
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    batch = {"wav": wav, "wav_lengths": lens}
    out = {}
    for mode in ("cif_greedy", "cif_beam"):
        for dev in ("cuda", "cpu"):
            rec = Recognizer(cfg, init_random(CifModel(cfg), SEED),
                             mode=mode, device=dev,
                             beam=BeamConfig(beam=4, max_len=40))
            out[mode, dev] = rec.decode_batch(batch)
        if out[mode, "cuda"] != out[mode, "cpu"]:
            raise AssertionError(f"{mode}: card {out[mode, 'cuda']} != CPU "
                                 f"{out[mode, 'cpu']}")

    log("agreement: cif_dev cif_greedy and cif_beam-4 on the card == on the "
        "CPU (tokens equal: " + json.dumps(out["cif_greedy", "cuda"][:2])
        + ")")
    check_cif_train_agreement(cfg, rng, False)
    check_cif_train_agreement(cfg, rng, True)


def check_cif_train_agreement(cfg, rng, use_pallas):
    """One cif_dev TrainStep from the same init on the card and on the CPU:
    losses within 1e-4, grad norm within 1e-3 relative. With use_pallas
    (the batch has >= 512 encoder and decoder rows) the flash and LN
    kernels, forward and backward, launch on the card."""
    from tpu_asr_torch.models.cif import CifModel
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    batch = (pallas_train_batch(rng) if use_pallas else
             train_batch(rng, 4, 200, [200, 151, 0, 97], [8, 5, 0, 3], 8))
    runs = train_on_both(CifModel, cfg, batch, 1)
    card, cpu = runs["card"][0][0], runs["cpu"][0][0]
    launches = runs["card"][2]
    what = "use_pallas " if use_pallas else ""
    bad = [k for k in ("loss", "loss_att", "loss_qty", "loss_ctc", "acc")
           if abs(card[k] - cpu[k]) > 1e-4]
    if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
            1e-3 * abs(cpu["grad_norm"]):
        raise AssertionError(f"CIF {what}train step on the card {card} != on "
                             f"the CPU {cpu}: {bad}")
    names = [k for k in launches if k.startswith(("flash", "layer_norm"))]
    if use_pallas and not all(launches[k] > 0 for k in names):
        raise AssertionError(f"CIF use_pallas train step launches {launches}")
    log(f"agreement: cif_dev {what}train step on the card == on the CPU "
        "(losses within 1e-4, grad norm within 1e-3 relative): "
        + json.dumps({k: [card[k], cpu[k]] for k in sorted(card)})
        + "; card launches "
        + json.dumps({k: n for k, n in launches.items() if n}))


def check_pallas_agreement():
    """hybrid_dev in float32 with use_pallas (flash attention, fused LN):
    attn_rescore and ctc_beam decode the same batch to the same tokens
    on the card (the kernels) and on the CPU (their plain versions). With
    beam 8 the rescoring pass has 4 x 8 x 24 = 768 rows, so the LN kernel
    runs as well as the flash kernel."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64,
                              use_pallas=True)
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    batch = {"wav": wav, "wav_lengths": lens}
    launches = {}
    for mode in ("attn_rescore", "ctc_beam"):
        out = {}
        for dev in ("cuda", "cpu"):
            rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                             mode=mode, device=dev,
                             beam=BeamConfig(beam=8, max_len=24,
                                             ctc_weight=0.3, nbest=8))
            before = (fa.flash_attention_fwd.launches,
                      ln.layer_norm_residual_fwd.launches)
            out[dev] = rec.decode_batch_nbest(batch)
            launches[mode, dev] = (
                fa.flash_attention_fwd.launches - before[0],
                ln.layer_norm_residual_fwd.launches - before[1])
        for a, b in zip(out["cuda"], out["cpu"]):
            for ha, hb in zip(a, b):
                if ha["yseq"] != hb["yseq"] or abs(ha["score"]
                                                   - hb["score"]) > 1e-3:
                    raise AssertionError(f"use_pallas {mode}: card {ha} != "
                                         f"CPU {hb}")
    flash_n, ln_n = launches["attn_rescore", "cuda"]
    if not (flash_n == cfg.num_enc_layers + 2 * cfg.num_dec_layers
            and ln_n == 3 * cfg.num_dec_layers
            and launches["ctc_beam", "cuda"] == (cfg.num_enc_layers, 0)
            and launches["attn_rescore", "cpu"] == (0, 0)):
        raise AssertionError(f"use_pallas agreement launches: {launches}")
    log(f"agreement: hybrid_dev use_pallas attn_rescore and ctc_beam-8 on "
        f"the card == on the CPU (tokens equal, scores within 1e-3); "
        f"(flash, LN) launches on the card {launches['attn_rescore', 'cuda']}"
        f" and {launches['ctc_beam', 'cuda']}")


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


def profile_serving(server, wavs, card, what="serving"):
    """The same requests again under torch.profiler (not counted above)."""
    def run():
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda w: server.submit("wav", w, timeout=600.0),
                          wavs))
    profile_device(run, what, card)


def serve_requests(server, wavs):
    """The requests from 8 threads -> ([(nbest, latency s)], wall s)."""
    def one(wav):
        start = time.perf_counter()
        nbest = server.submit("wav", wav, timeout=600.0)
        return nbest, time.perf_counter() - start

    wall0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        results = list(pool.map(one, wavs))
    return results, time.perf_counter() - wall0


def run_cif_serving(card, captures):
    """The cif preset at full width behind AsrServer in cif_greedy: 16
    wav requests; the CIF kernel launches once per decode batch. The first
    batch's firing inputs of each bucket go into `captures`."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.cif import CifModel
    from tpu_asr_torch.ops.cif_fire import cif_fire_fwd
    from tpu_asr_torch.serve import AsrServer
    from tpu_asr_torch.weights import init_random

    tc = get_preset("cif")
    cfg = tc.model
    t0 = time.perf_counter()
    rec = Recognizer(cfg, init_random(CifModel(cfg), SEED), mode="cif_greedy",
                     device=DEVICE, beam=tc.beam)
    server = AsrServer(rec, bucket_frames=BUCKETS, batch_size=BATCH,
                       device=DEVICE)
    server.warmup(kinds=("wav",))
    torch.cuda.synchronize()
    log(f"cif serving: cif model (d{cfg.d_model}, h{cfg.num_heads}, "
        f"{cfg.num_enc_layers}+{cfg.num_dec_layers} layers, conv "
        f"{cfg.conv_channels}, vocab {cfg.vocab_size}, {cfg.dtype}) built "
        f"and warmed up in {time.perf_counter() - t0:.1f} s")
    server.start()
    rng = np.random.default_rng(SEED)
    wavs = [synth_wav(n, rng) for n in request_lengths(N_REQUESTS, SEED)]
    audio_s = sum(len(w) for w in wavs) / 16000.0

    # main path: counts from 0 just before, read just after
    cif_fire_fwd.launches = 0
    rec.decode_steps = 0
    with record_inputs(rec.model, "fire", captures,
                       lambda h, a, u: f"cif serving T'={h.shape[1]}"):
        results, wall = serve_requests(server, wavs)
    launches, steps = cif_fire_fwd.launches, rec.decode_steps
    batches = server.stats["batches"]
    try:
        v = cfg.vocab_size
        lengths = [len(nb[0]["yseq"]) for nb, _ in results]
        if not all(0 <= x <= v - 3 for nb, _ in results
                   for x in nb[0]["yseq"]):
            raise AssertionError("cif_greedy token outside the vocabulary")
        if batches <= 0 or launches != batches:
            raise AssertionError(f"cif_fire launched {launches} times for "
                                 f"{batches} decode batches")
        lat = sorted(dt for _, dt in results)
        log(f"cif serving: {N_REQUESTS} requests ({audio_s:.1f} s of audio) "
            f"in {wall:.3f} s; {batches} batches, {steps} decode steps, "
            f"{launches} cif_fire launches; latency p50 "
            f"{statistics.median(lat) * 1e3:.1f} ms, max "
            f"{lat[-1] * 1e3:.1f} ms; inverse RTF {audio_s / wall:.2f} "
            f"[{card}]; random weights: hypothesis lengths {lengths}, "
            f"{lengths.count(tc.beam.max_len)} of {len(lengths)} at max_len "
            f"{tc.beam.max_len}")
        profile_serving(server, wavs, card, "cif serving")
    finally:
        server.stop()
    return launches


def run_pallas_serving(card, flash_caps, ln_caps):
    """The aishell model with use_pallas behind AsrServer in the preset's
    attn_rescore: 16 wav requests. Per decode batch the flash kernel
    launches once per attention of the encoder (self) and of the decoder
    pass (self and cross), the LN kernel once per post-norm block (every
    call has >= 512 rows). The first kernel inputs of each kind in each
    bucket go into flash_caps / ln_caps. -> (flash launches, LN
    launches)."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln
    from tpu_asr_torch.serve import AsrServer
    from tpu_asr_torch.weights import init_random

    tc = get_preset(PRESET)
    cfg = dataclasses.replace(tc.model, use_pallas=True)
    t0 = time.perf_counter()
    rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                     mode=tc.decode_mode, device=DEVICE, beam=tc.beam)
    server = AsrServer(rec, bucket_frames=BUCKETS, batch_size=BATCH,
                       device=DEVICE)
    server.warmup(kinds=("wav",))
    torch.cuda.synchronize()
    log(f"use_pallas serving: {PRESET} model with use_pallas (flash "
        f"attention {cfg.attention_pallas}, fused LN {cfg.layernorm_pallas},"
        f" bf16) in {rec.mode}, beam {tc.beam.beam}, max_len "
        f"{tc.beam.max_len}, ctc weight {tc.beam.ctc_weight}; built and "
        f"warmed up in {time.perf_counter() - t0:.1f} s")
    server.start()
    rng = np.random.default_rng(SEED)
    wavs = [synth_wav(n, rng) for n in request_lengths(N_REQUESTS, SEED)]
    audio_s = sum(len(w) for w in wavs) / 16000.0

    bucket = {}     # the encoder T' of the batch being decoded

    def flash_label(q, k, v, valid, causal):
        if causal:
            kind = "decoder self-attention (causal)"
        elif q.shape[1] == k.shape[1] and q.shape[0] == BATCH:
            bucket["t"] = q.shape[1]
            kind = "encoder self-attention"
        else:
            kind = "decoder cross-attention"
        return f"T'={bucket.get('t')} {kind}"

    def ln_label(r, *_):
        return (f"T'={bucket.get('t')} "
                f"{'encoder' if r.shape[0] == BATCH else 'decoder'} LN")

    # main path: counts from 0 just before, read just after
    flash_fwd, ln_fwd = fa.flash_attention_fwd, ln.layer_norm_residual_fwd
    flash_fwd.launches = ln_fwd.launches = 0
    with record_inputs(fa, "flash_attention_fwd", flash_caps, flash_label), \
            record_inputs(ln, "layer_norm_residual_fwd", ln_caps, ln_label):
        results, wall = serve_requests(server, wavs)
    flash_n, ln_n = flash_fwd.launches, ln_fwd.launches
    batches = server.stats["batches"]
    try:
        v = cfg.vocab_size
        if not all(0 <= x <= v - 3 for nb, _ in results
                   for x in nb[0]["yseq"]):
            raise AssertionError("attn_rescore token outside the vocabulary")
        per_batch = (cfg.num_enc_layers + 2 * cfg.num_dec_layers,
                     2 * cfg.num_enc_layers + 3 * cfg.num_dec_layers)
        if batches <= 0 or (flash_n, ln_n) != (per_batch[0] * batches,
                                               per_batch[1] * batches):
            raise AssertionError(f"use_pallas serving: {flash_n} flash and "
                                 f"{ln_n} LN launches for {batches} batches,"
                                 f" expected {per_batch} a batch")
        lengths = [len(nb[0]["yseq"]) for nb, _ in results]
        lat = sorted(dt for _, dt in results)
        log(f"use_pallas serving: {N_REQUESTS} requests ({audio_s:.1f} s of "
            f"audio) in {wall:.3f} s; {batches} batches, {flash_n} "
            f"flash_attention_fwd and {ln_n} layer_norm_residual_fwd "
            f"launches ({per_batch[0]} and {per_batch[1]} a batch); latency "
            f"p50 {statistics.median(lat) * 1e3:.1f} ms, max "
            f"{lat[-1] * 1e3:.1f} ms; inverse RTF {audio_s / wall:.2f} "
            f"[{card}]; random weights: hypothesis lengths {lengths}")
        profile_serving(server, wavs, card, "use_pallas serving")
    finally:
        server.stop()
    return flash_n, ln_n


# the joint beam's later call of ctc_prefix_scan kept in each bucket,
# beside its first: a step whose prefixes are no longer empty
LATER_PREFIX_CALL = 10


def run_serving(card, prefix_caps):
    """The aishell-width hybrid model in joint beam 5 behind AsrServer;
    the inputs of ctc_prefix_scan's first call and its LATER_PREFIX_CALL-th
    call in each bucket go into prefix_caps. -> launches."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode import ctc_prefix as scorer_module
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

    calls = {}      # ctc_prefix_scan calls so far in each bucket

    def prefix_label(x_cand, *_, **__):
        t = x_cand.shape[1]
        calls[t] = calls.get(t, 0) + 1
        if calls[t] in (1, LATER_PREFIX_CALL):
            return f"joint beam T'={t} call {calls[t]}"
        return None

    # main path: counts from 0 just before, read just after
    ctc_prefix_scan.launches = 0
    rec.decode_steps = 0
    with record_inputs(scorer_module, "ctc_prefix_scan", prefix_caps,
                       prefix_label):
        results, wall = serve_requests(server, wavs)
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


# ---- phase 8: training ----

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


def flash_bwd_label(q, k, v, out, dout, lse, valid, causal):
    """A backward call's kind and shapes (one bucket of training is one
    static shape)."""
    kind = ("decoder self-attention (causal)" if causal else
            "encoder self-attention" if q.shape[1] == k.shape[1] else
            "decoder cross-attention")
    return f"{kind}: q {list(q.shape)} k {list(k.shape)}"


def ln_bwd_label(r, *_):
    return f"LN {list(r.shape)}"


def run_training(card, workdir, preset, data, captures,
                 model_overrides=None, bwd_caps=None, ctc_caps=None):
    """The Solver that `python -m tpu_asr_torch.train --preset <preset>`
    builds (with `model_overrides` to its ModelConfig, as
    build_solver takes them), on `data`, for >= MIN_TRAIN_STEPS steps;
    then a checkpoint restore, a profile and 20 steps at the fixed shape.
    A CIF model's firing inputs of its first train and cv batch go into
    `captures`; with use_pallas, the inputs of the flash and LN backward
    of the first train batch of each bucket into bwd_caps["flash"] and
    bwd_caps["ln"]; the inputs of the first ctc_loss_bwd into ctc_caps.
    Every ctc_loss_fwd and ctc_loss_bwd must take the warp route. ->
    {kernel name: launches in the Solver run}."""
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.modules import FUSED_LN_MIN_ROWS, PostNormBlock
    from tpu_asr_torch.ops import ctc_loss as ctc_module
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln
    from tpu_asr_torch.train.__main__ import build_solver, parse_args

    args = parse_args(["--preset", preset, "--save-folder", workdir])
    solver = build_solver(args, data, model_overrides)
    epochs = max(2, -(-MIN_TRAIN_STEPS // len(solver.train_loader)))
    solver.epochs = epochs
    timed = TimedLoader(solver.train_loader)
    solver.train_loader = timed
    ts = solver.train_step
    cfg = ts.model.cfg
    what = f"{preset} training" + (" with use_pallas" if cfg.use_pallas
                                   else "")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the post-norm calls that take the fused LN (>= 512 rows), counted
    # as they happen: the expected LN launches
    fused = {"fwd": 0, "bwd": 0}

    def count_fused(block, inputs):
        rows = inputs[0].numel() // inputs[0].shape[-1]
        if block.use_pallas and rows >= FUSED_LN_MIN_ROWS:
            fused["fwd"] += 1
            fused["bwd"] += int(torch.is_grad_enabled())
    hooks = [m.register_forward_pre_hook(count_fused)
             for m in ts.model.modules() if isinstance(m, PostNormBlock)]

    # main path: counts from 0 just before, read just after
    counters = {k: f for k, f in kernel_counters().items()
                if k != "ctc_prefix_scan"}
    model = ts.model
    records = contextlib.ExitStack()
    if cfg.model_type == "cif":
        records.enter_context(record_inputs(
            model, "fire", captures, lambda h, a, u: (
                f"{what}, {'train' if model.training else 'cv'} batch")))
    if cfg.use_pallas and bwd_caps is not None:
        records.enter_context(record_inputs(
            fa, "flash_attention_bwd", bwd_caps["flash"], flash_bwd_label))
        records.enter_context(record_inputs(
            ln, "layer_norm_residual_bwd", bwd_caps["ln"], ln_bwd_label))
    if ctc_caps is not None:
        records.enter_context(record_inputs(
            ctc_module, "ctc_loss_bwd", ctc_caps,
            lambda e, *_: f"{what}: E {list(e.shape)}"
            if not any(k.startswith(f"{what}:") for k in ctc_caps) else None))
    for fn in counters.values():
        fn.launches = 0
    routes = {"ctc_loss_fwd": ctc_module.FWD_ROUTE_LAUNCHES,
              "ctc_loss_bwd": ctc_module.BWD_ROUTE_LAUNCHES}
    for r in routes.values():
        r.update(warp=0, block=0)
    wall0 = time.perf_counter()
    with records:
        solver.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, r in routes.items():
        if r != {"warp": launches[name], "block": 0}:
            raise AssertionError(f"{what}: {name} routes {r} for "
                                 f"{launches[name]} launches; every training "
                                 f"shape has S <= 65")
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()

    steps = sum(h["train_steps"] for h in solver.history)
    cv_batches = sum(h["cv_batches"] for h in solver.history)
    if steps < MIN_TRAIN_STEPS or ts.optimizer.count != steps:
        raise AssertionError(f"{steps} steps, {ts.optimizer.count} updates")
    if any(h["nonfinite_steps"] for h in solver.history) or not all(
            np.isfinite([h["loss"], h["train_loss"], h["grad_norm_max"]]).all()
            for h in solver.history):
        raise AssertionError(f"non-finite training: {solver.history}")
    # forward kernels run in every train step and cv batch, the backward
    # kernels in every train step: the flash pair once per full-pass
    # attention (encoder self, decoder self and cross), the LN pair once
    # per post-norm call of >= 512 rows
    n_attn = (cfg.num_enc_layers + 2 * cfg.num_dec_layers
              if cfg.attention_pallas else 0)
    expect = {"ctc_loss_fwd": steps + cv_batches, "ctc_loss_bwd": steps,
              "cif_fire": (steps + cv_batches if cfg.model_type == "cif"
                           else 0),
              "flash_attention_fwd": n_attn * (steps + cv_batches),
              "flash_attention_bwd_dq": n_attn * steps,
              "flash_attention_bwd_dkv": n_attn * steps,
              "layer_norm_residual_fwd": fused["fwd"],
              "layer_norm_residual_bwd": fused["bwd"]}
    if launches != expect:
        raise AssertionError(f"{what}: kernel launches {launches}, expected "
                             f"{expect} for {steps} train steps + "
                             f"{cv_batches} cv batches")
    step_ms = [a.elapsed_time(b) for a, b, _, _ in timed.steps]
    steady = timed.steps[1:]              # the first step warms up
    steady_s = sum(a.elapsed_time(b) for a, b, _, _ in steady) / 1e3
    utts = sum(n for _, _, n, _ in steady)
    audio_s = sum(x for _, _, _, x in steady) / 16000.0
    log(f"{what}: {cfg.model_type} model (d{cfg.d_model}, h{cfg.num_heads},"
        f" {cfg.num_enc_layers}+{cfg.num_dec_layers} layers, conv "
        f"{cfg.conv_channels}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"dropout {cfg.dropout}, SpecAugment "
        f"{'on' if ts.specaug else 'off'}) {epochs} epochs, {steps} steps + "
        f"{cv_batches} cv batches in {wall:.2f} s; kernel launches "
        f"{json.dumps(launches)} (CTC by route {json.dumps(routes)}); "
        f"post-norm calls of >= {FUSED_LN_MIN_ROWS}"
        f" rows {json.dumps(fused)}")
    log(f"{what}: per epoch " + json.dumps(solver.history))
    log(f"{what}: step ms median {statistics.median(step_ms):.2f}, min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; steady (steps 2..): "
        f"{len(steady) / steady_s:.2f} steps/s, {utts / steady_s:.1f} "
        f"utterances/s, {audio_s / steady_s:.1f} audio s/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")

    # the epoch checkpoint restores to equal parameters
    ck = solver.checkpointer
    restored = build_model(cfg)
    restored.load_state_dict(ck.restore(ck.latest_step())["model"])
    for (k, a), b in zip(ts.model.state_dict().items(),
                         restored.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"checkpoint restore differs at {k}")
    log(f"{what}: checkpoint step {ck.latest_step()} restores equal "
        f"parameters ({len(restored.state_dict())} tensors)")

    it = iter(solver.train_loader.loader)
    batches = [next(it) for _ in range(4)]
    it.close()
    profile_device(lambda: [ts(b) for b in batches], what, card)

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
    log(f"{what}: fixed shape feats [32, 1000, 80], U=24: 20 steps, "
        f"step ms median {statistics.median(fixed):.2f}, min "
        f"{min(fixed):.2f}; {20 / total_s:.2f} steps/s, "
        f"{20 * 32 / total_s:.1f} utterances/s, {20 * 32 * 10 / total_s:.1f}"
        f" audio s/s [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from tpu_asr_torch.ops import (cif_fire, ctc_loss, ctc_prefix,
                                   flash_attention, layernorm)
    from tpu_asr_torch.ops.cuda_build import load_all

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libraries = (ctc_prefix.LIBRARY, ctc_loss.LIBRARY, cif_fire.LIBRARY,
                 flash_attention.LIBRARY, flash_attention.BWD_LIBRARY,
                 layernorm.LIBRARY)
    load_all(*libraries)
    log(f"build: {', '.join(lib.name for lib in libraries)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libraries:
        if lib.build_log:
            log(lib.build_log.strip())
    build_report = check_build(libraries)

    gen = torch.Generator().manual_seed(SEED)
    max_err, timings, prefix_floor = check_prefix_scan(gen)
    ctc_errs, ctc_timings, ctc_library = check_ctc_loss()
    cif_err, cif_timing = check_cif_fire()
    flash_err, lse_err, flash_timings = check_flash_attention()
    ln_err, ln_ulps, ln_raw, ln_timings = check_layer_norm()
    flash_bwd_errs, flash_bwd_timings = check_flash_bwd()
    ln_bwd_errs, ln_bwd_timings = check_ln_bwd()
    check_agreement()
    check_train_agreement()
    check_train_agreement(use_pallas=True)
    check_cif_agreement()
    check_pallas_agreement()
    prefix_caps = {}
    launches = run_serving(card, prefix_caps)
    captures = {}
    cif_serving = run_cif_serving(card, captures)
    flash_caps, ln_caps = {}, {}
    flash_serving, ln_serving = run_pallas_serving(card, flash_caps, ln_caps)
    t0 = time.perf_counter()
    data = synthetic_aishell()
    log(f"training: {len(data[0])} + {len(data[1])} synthetic utterances "
        f"made in {time.perf_counter() - t0:.1f} s")
    training, bwd_caps, ctc_caps = {}, {"flash": {}, "ln": {}}, {}
    pallas = f"{PRESET} use_pallas"
    for key, preset, overrides in ((PRESET, PRESET, None),
                                   ("cif", "cif", None),
                                   (pallas, PRESET, {"use_pallas": True})):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as wd:
            training[key] = run_training(card, wd, preset, data, captures,
                                         overrides, bwd_caps, ctc_caps)
    path_err, path_timings = check_cif_fire_on_paths(captures)
    flash_path, ln_path, path_errs = check_flash_ln_on_paths(flash_caps,
                                                             ln_caps)
    flash_bwd_path, ln_bwd_path, bwd_path_errs = check_bwd_on_paths(bwd_caps)
    prefix_path, ctc_path, ctc_path_errs = check_ctc_on_paths(prefix_caps,
                                                              ctc_caps)

    def ctc_build(symbol):
        return {k: v for k, v in build_report.items() if symbol in k}

    main_t = timings[(249, True)]          # 1000-frame bucket, one-pass
    kernels = [{
        "name": "ctc_prefix_scan",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/ctc_prefix_scan.cu",
        "replaces": "tpu_asr/ops/pallas/ctc_prefix.py:114",
        "launches": launches,
        "max_abs_err": max(max_err, ctc_path_errs["prefix"]),
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "kernel_device_ms": main_t["kernel_device_ms"],
        "chain_floor_ms": prefix_floor,
        "bound_us": main_t["bound_ms"] * 1e3,
        "shape": "N=40 T=249 K=11 with histories",
        "design": "a block a beam, the chain's operands staged through a "
                  "ring of shared-memory tiles by cp.async",
        "build": ctc_build(ctc_prefix.KERNEL_SYMBOL),
        "path_max_abs_err": ctc_path_errs["prefix"],
        "other_shapes": dict({f"T={t} hist={h}": v for (t, h), v
                              in timings.items() if (t, h) != (249, True)},
                             **{f"path {k}": v
                                for k, v in prefix_path.items()}),
    }]
    designs = {"fwd": "warp route: a chain warp an utterance, two positions "
                      "a lane, shuffles up; a helper warp stages rows of E "
                      "through a shared-memory ring by cp.async, stores "
                      "alpha and runs the last position of S = 32 P + 1",
               "bwd": "warp route: a warp an utterance, two positions a "
                      "lane, rows of E and alpha staged through a "
                      "shared-memory ring by cp.async"}
    for name, line in (("fwd", 176), ("bwd", 211)):
        t = ctc_timings[(name, 49)]
        by_path = {f"{p} training": training[p][f"ctc_loss_{name}"]
                   for p in training}
        other = {"B=32 T=249 S=61 (U=30)": dict(
            ctc_timings[(name, 61)], library_ms=ctc_library[61][name]),
                 "B=32 T=249 S=65 (U=32)": ctc_timings[(name, 65)]}
        other.update({f"path {k}": v[name] for k, v in ctc_path.items()})
        kernels.append({
            "name": f"ctc_loss_{name}",
            "route": "cuda",
            "source": "tpu_asr_torch/csrc/ctc_loss.cu",
            "replaces": f"tpu_asr/ops/pallas/ctc.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(ctc_errs[name], ctc_path_errs[name]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": ctc_library[49][name],
            "kernel_device_ms": t["kernel_device_ms"],
            "chain_floor_ms": t["chain_floor_ms"],
            "ctc_route": t["route"],     # "route" is the contract's "cuda"
            "design": designs[name],
            "build": ctc_build(t["symbol"]),
            "path_max_abs_err": ctc_path_errs[name],
            "shape": "B=32 T=249 S=49 (U=24)",
            "other_shapes": other,
            "ctc_loss_kernel_e2e_ms": ctc_library[49]["port_e2e"],
            "library_e2e_ms": ctc_library[49]["lib_e2e"],
        })
    by_path = {"cif serving": cif_serving,
               "cif training": training["cif"]["cif_fire"]}
    # the main numbers at serving's 1000-frame bucket, as served
    main_label = max((k for k in path_timings if k.startswith("cif serving")),
                     key=lambda k: captures[k][0].shape[1])
    cif_t = path_timings[main_label]
    other = {k: v for k, v in path_timings.items() if k != main_label}
    other["bench B=32 T=249 D=512 U=25 scaled"] = cif_timing
    kernels.append({
        "name": "cif_fire",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/cif_fire.cu",
        "replaces": "tpu_asr/ops/pallas/cif.py:54",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(cif_err, path_err),
        "ms": cif_t["ms"],
        "plain_ms": cif_t["plain_ms"],
        "bound_ms": cif_t["bound_ms"],
        "bound_by": cif_t["bound_by"],
        "library_ms": cif_t["library_ms"],
        "library_call": "torch.bmm(W^T, h), W materialized beforehand",
        "kernel_device_ms": cif_t["kernel_device_ms"],
        "design": "a block per (utterance, 8 outputs), a warp per output: "
                  "c and c - alpha staged in shared memory once, each "
                  "warp's frame range by ballots over a per-frame rule, "
                  "8 frames of 16-byte loads of h in flight",
        "build": {k: v for k, v in build_report.items()
                  if cif_fire.KERNEL_SYMBOL in k},
        "shape": f"{main_label}: {cif_t['shape']}",
        "other_shapes": other,
    })
    # the main numbers: the largest call of each kernel in use_pallas
    # serving's 1000-frame bucket, as served
    for name, source, replaces, path_t, synthetic, n, err, extra in (
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:110", flash_path, flash_timings,
             {"use_pallas serving": flash_serving,
              "use_pallas training": training[pallas]["flash_attention_fwd"]},
             max(flash_err, path_errs["flash"]),
             {"lse_max_abs_err": max(lse_err, path_errs["lse"]),
              "library_call": "F.scaled_dot_product_attention, boolean "
                              "attn_mask, [B, H, T, dh] inputs",
              "design": "sm90 wgmma",
              "build": {k: v for k, v in build_report.items()
                        if "fwd_wgmma" in k}}),
            ("layer_norm_residual_fwd", "layer_norm_residual.cu",
             "layernorm.py:79", ln_path, ln_timings,
             {"use_pallas serving": ln_serving,
              "use_pallas training":
                  training[pallas]["layer_norm_residual_fwd"]},
             max(ln_err, path_errs["ln"]),
             {"bf16_ulps_at_output_scale": max(ln_ulps,
                                               path_errs["ln_ulps"]),
              "bf16_raw_ulps_max": max(ln_raw, path_errs["ln_raw"]),
              "library_call": None})):
        main_label = max(path_t, key=lambda k: (    # labels "T'=<t> ..."
            int(k.split()[0][3:]), path_t[k]["bound_ms"]))
        t = path_t[main_label]
        other = {k: v for k, v in path_t.items() if k != main_label}
        other.update({f"synthetic {k}": v for k, v in synthetic.items()})
        kernels.append(dict({
            "name": name,
            "route": "cuda",
            "source": f"tpu_asr_torch/csrc/{source}",
            "replaces": f"tpu_asr/ops/pallas/{replaces}",
            "launches": sum(n.values()),
            "launches_by_path": n,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "kernel_device_ms": t["kernel_device_ms"],
            "shape": t["shape"],
            "other_shapes": other,
        }, **extra))
    # the backward kernels' main numbers: their largest call in use_pallas
    # training (by bound), on the inputs it gave them
    on_path = bwd_path_errs["flash"]
    flash_bwd_rows = (
        ("flash_attention_bwd_dq", "dq", "flash_attention.py:171",
         {"dq": flash_bwd_errs["dq"], "path dq": on_path["dq"]}),
        ("flash_attention_bwd_dkv", "dkv", "flash_attention.py:203",
         {"dk": flash_bwd_errs["dk"], "dv": flash_bwd_errs["dv"],
          "path dk": on_path["dk"], "path dv": on_path["dv"]}))
    for name, which, replaces, errs in flash_bwd_rows:
        path_t = {k: v[which] for k, v in flash_bwd_path.items()}
        main_label = max(path_t, key=lambda k: path_t[k]["bound_ms"])
        t = path_t[main_label]
        other = {k: v for k, v in path_t.items() if k != main_label}
        other.update({f"synthetic {k}": v[which]
                      for k, v in flash_bwd_timings.items()})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_asr_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"tpu_asr/ops/pallas/{replaces}",
            "launches": training[pallas][name],
            "launches_by_path": {"use_pallas training":
                                 training[pallas][name]},
            "max_abs_err": max(e for e, _ in errs.values()),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": "torch.autograd.grad of "
                            "F.scaled_dot_product_attention (dq, dk, dv "
                            "together), boolean attn_mask, forward outside",
            "plain_computes": "dq, dk and dv together",
            "kernel_device_ms": t["kernel_device_ms"],
            "backward_ms": t["backward_ms"],
            "bf16_ulps_at_gradient_scale": {k: u for k, (_, u)
                                            in errs.items()},
            "shape": t["shape"],
            "other_shapes": other,
        })
        kernels[-1].update(
            design="sm90 wgmma",
            build={k: v for k, v in build_report.items()
                   if f"{which}_wgmma" in k})
    main_label = max(ln_bwd_path, key=lambda k: ln_bwd_path[k]["bound_ms"])
    t = ln_bwd_path[main_label]
    other = {k: v for k, v in ln_bwd_path.items() if k != main_label}
    other.update({f"synthetic {k}": v for k, v in ln_bwd_timings.items()})
    n = training[pallas]["layer_norm_residual_bwd"]
    kernels.append({
        "name": "layer_norm_residual_bwd",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/layer_norm_residual.cu",
        "replaces": "tpu_asr/ops/pallas/layernorm.py:51",
        "launches": n,
        "launches_by_path": {"use_pallas training": n},
        "max_abs_err": max(ln_bwd_errs["dx"], bwd_path_errs["ln"]["dx"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library_call": "torch.ops.aten.native_layer_norm_backward on x = "
                        "residual + h made beforehand",
        "kernel_device_ms": t["kernel_device_ms"],
        "ms_l2_flushed": t["ms_l2_flushed"],
        "kernel_device_ms_l2_flushed": t["kernel_device_ms_l2_flushed"],
        "device_events": t["device_events"],
        "design": "persistent cooperative grid, 16-byte loads, one launch "
                  "with the dgamma/dbeta sums",
        "build": {k: v for k, v in build_report.items()
                  if "layer_norm_residual_bwd_kernel" in k},
        "errors": {"synthetic": ln_bwd_errs, "path": bwd_path_errs["ln"]},
        "shape": t["shape"],
        "other_shapes": other,
    })
    log(f"before their present design, the kernels alone took (constants "
        f"recorded in PERF.md, runs D, E, F and I, not measured in this "
        f"run): "
        f"{json.dumps(PREVIOUS_ALONE_MS)} ms")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
