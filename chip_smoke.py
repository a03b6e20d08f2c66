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
     CPU. The small hybrid model with a small seeded LM: joint and
     ctc_beam with LM fusion give equal tokens on the card and the CPU,
     scores within 1e-3; attn_rescore with the LM term and use_pallas
     equal tokens. A small conformer (conformer_dev) as the hybrid:
     joint and attn_rescore tokens equal, two train steps' losses within
     1e-4 and step 1's grad norm within 1e-3 relative. The transducer
     (transducer_dev, conformer_transducer_dev, and the latter with
     enc_chunk_size 4): transducer_greedy, transducer_beam 4 and
     transducer_rescore tokens equal (greedy's times too, in order and
     below each encoder length), beam and rescore scores within 1e-3;
     two train steps' losses within 1e-4, step 1's grad norm within 1e-3
     relative, the CTC kernels once a step on the card. The streaming
     recognizers (STREAMING_AGREEMENT: greedy CTC and CTC beam 4 on
     hybrid_dev, greedy CTC on conformer_dev, CIF on cif_dev on the
     incremental and the recompute paths, the transducer on
     transducer_dev; all with enc_chunk_size 4) stream the same features
     in pushes of 37 frames on the card and on the CPU: every push's
     return, the final hypothesis and the times equal. The reference's
     own inputs: a small attention_lfr-shaped model (the linear input
     layer, LFR 4/3) and hybrid_dev with 83-dim fbank + pitch inputs, on
     features the CPU made once: beam (joint) tokens equal, two train
     steps' losses within 1e-4 and step 1's grad norm within 1e-3
     relative.
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
 10. LM fusion and the decode CLIs, on phase 8's data and checkpoints:
     `python -m tpu_asr_torch.train_lm` (main) on the card trains the LM
     at its published width (d256, d_inner 1024, h4, 4 layers, vocab
     4233, float32) on the 461 + 51 transcripts, batch 64, for >= 20
     steps: finite losses, the train loss falling, the best cv loss below
     the first and not below the corpus's floor (lm_cv_floor, less
     LM_FLOOR_MARGIN); step times, peak memory. The same run with dropout
     0 for LM_CPU_EPOCHS epochs on the card and on the CPU: equal losses
     within LM_CPU_ATOL. A profile of 8 train steps with its host ops.
     `python -m tpu_asr_torch.recognize` on a wav manifest of the 51 cv
     utterances with the LM: the hybrid checkpoint in joint beam 5 (lm
     0.3; ctc_prefix_scan launches once per LM-fused step) and ctc_beam
     10 (lm 0.1), the use_pallas checkpoint in attn_rescore 10 (lm 0.3;
     the flash and LN forward kernels launch once per use_pallas
     full-pass attention and fused post-norm call); a hypothesis per
     utterance and a summary with cer each; `python -m
     tpu_asr_torch.score` on the joint output agrees with its cer. The
     kernels' inputs on these paths (PathLabels) are then held against
     their plain versions, timed. The joint beam and ctc_beam timed with
     and without the LM on one batch (wall, profiler device and host
     time, a reading); the server with --dict (4233 lines) and --lm-ckpt
     answers POST /recognize with a text.
 11. the aishell recipe with the conformer preset (d512, h8, 6 conformer
     + 6 decoder layers, conv kernel 15, conv (32, 128), vocab 4233,
     bf16, dropout 0.1, SpecAugment, 32000-frame batches) through the
     port's CLIs on phase 8's corpus, written as the recipe's Kaldi
     splits (16-bit .wav files, wav.scp, text): `python -m
     tpu_asr_torch.prepare_data` as egs/aishell/run.sh runs it
     (--dict-out on train, --dict on dev);
     `python -m tpu_asr_torch.compute_cmvn` on the train manifest (the
     card's stats of the first 64 utterances equal the CPU frontend's
     within 5e-5); the trainer with --dict, --cmvn global and
     --cmvn-stats for >= 20 steps (as phase 8: finite losses, the CTC
     kernels once per step on their warp route, a profile, the fixed
     shape; frontend.json says global; the train loss falls), printed
     beside phase 8's aishell numbers; `python -m tpu_asr_torch.recognize
     --ckpt` on the cv manifest in attn_rescore beam 10 and joint beam 5
     (a hypothesis per utterance, a cer, the inverse RTF;
     ctc_prefix_scan once per joint step); the server with --ckpt
     --restore latest holds the latest step's weights and the stats
     file's mean and istd, and answers POST /recognize with submit()'s
     tokens; then the CTC pair and the
     prefix scan on the inputs this path gave them against their plain
     versions, timed.
 12. the transducer family: the transducer preset at full width (d512,
     h8, 6 encoder layers, conv 256, 2 predictor layers, d_joint 512,
     vocab 4233, float32, dropout 0.1, aux CTC 0.3, 16000-frame batches)
     through the Solver of `python -m tpu_asr_torch.train --preset
     transducer` on phase 8's corpus for >= 20 steps (as phase 8: every
     step's losses, loss_rnnt and loss_ctc included, and grad norm
     finite, the CTC kernels once per step and cv batch on their warp
     route, a profile of one step, 5 steps at the fixed shape, the
     checkpoint restore; the train loss falls), beside phase 8's aishell
     numbers; the loss (the
     checkpointed joint and the lattice) and the lattice recursion alone
     on the first train batch's inputs: device time, share of a step,
     peak memory against all frames' logits materialized; `python -m
     tpu_asr_torch.recognize --ckpt` on the first 26 utterances of phase
     10's cv manifest in
     transducer_greedy, transducer_beam 5, transducer_beam 5 with phase
     10's LM (lm 0.3) and transducer_rescore 10 (ctc weight 0.5): a
     hypothesis per utterance, a cer and an inverse RTF each, no kernel
     launched, greedy's times non-decreasing and below each encoder
     length; the server with --ckpt answers POST /recognize with
     submit()'s tokens; the full-width conformer_transducer preset
     (chunk 16) takes 4 train steps (finite losses, the CTC kernels once
     a step) and one greedy decode batch (a hypothesis per row, times in
     order and range); then the CTC pair on the inputs the transducer
     training gave it against the plain versions, timed.
 13. streaming: 13a, the `streaming` preset at full width (d512, h8, 6
     encoder layers, conv 256, vocab 4233, float32, chunk 16, unbounded
     left context, 16000-frame batches) through the Solver of `python -m
     tpu_asr_torch.train --preset streaming` on phase 8's corpus (as
     phase 8: >= 20 steps and cv, finite losses, the CTC kernels once a
     step on their warp route, a profile, the fixed shape), beside phase
     8's aishell numbers; 13b, on 13a's checkpoint (the first 26 of
     phase 10's 51 cv utterances) and on random weights of the preset
     (seed 0; the first 16 of them), each utterance pushed
     64 feature frames at a time through StreamingCTCRecognizer: tokens
     and times equal the offline greedy_ctc of the Recognizer on the
     card, confidences within 1e-4, the streamed encode_chunk frames
     within 1e-4 of Encoder.forward's; StreamingCTCBeamRecognizer beam 5
     against the offline ctc_beam 5 (the 1-best equal, its score within
     1e-3); the full-recompute path on 8 utterances; no kernel launched;
     13c, `python -m tpu_asr_torch.stream_demo --ckpt <13a> --manifest
     <cv> --chunk-frames 64 --limit 26`, greedy and --beam 5: 13b's
     hypotheses and
     the summary; 13d, random full-width transducer_streaming and
     conformer_transducer (chunk 16) streamed against the offline
     transducer_greedy on 8 cv utterances (tokens and times equal,
     confidences within 1e-4); 13e, make_http_server with StreamSessions
     on 13b's random model: 4 concurrent /stream sessions answer 13b's
     tokens with times and confidence, a push after final answers 410,
     /healthz shows streaming and active_streams; the per-push latency,
     each session's inverse RTF, and one session under torch.profiler
     (device ms and events a chunk step, busy share); then the CTC pair
     on the inputs 13a's training gave it against the plain versions.
 14. the reference's own inputs, forced alignment and averaging: 14a,
     pitch of phase 8's first 64 train utterances on the card against
     the CPU, with the --pitch default (per-frame picks) and with the
     Viterbi track (smooth weight 4.0), under the margin rule
     (compare_pitch: the NCCF within 1e-4, a lag may differ only where
     the CPU's own decision was within a stated margin of flipping, the
     features within 1e-3 on every utterance without a flip, at most 1%
     of the frames flipped; the CPU's Viterbi track over the card's own
     band equal to the card's bit for bit); wav_to_features with and without pitch on
     one ~32000-frame batch (ms, device ms and events, peak memory);
     14b, `python -m tpu_asr_torch.train --preset aishell --pitch` at
     full width on phase 8's corpus (as phase 8, >= 3 epochs; d_input 83
     in model_config.json, add_pitch in frontend.json) beside phase 8's
     aishell numbers, recognize --ckpt on phase 10's cv manifest in
     joint beam 5 (ctc_prefix_scan once a joint step; CER, inverse RTF),
     serve --ckpt (POST /recognize == submit()), then the CTC pair and
     the prefix scan on this path's inputs against their plain versions;
     14c, phase 8's corpus as a Kaldi dump (80-dim fbank written with
     write_mat into one .ark, espnet data.json files, prepare_data
     --espnet-json), compute_cmvn on it equal to the .npy features'
     bitwise and to the wav manifest's within 5e-5, the attention_lfr
     preset at full width (d512, h8, 6+6, linear input 320 -> 512, vocab
     4233, float32, 16000-frame batches) trained from the ark manifests
     with --cmvn global (as phase 8; no kernel), recognize beam 5 tokens
     equal on the ark and the .npy cv manifests; 14d, `python -m
     tpu_asr_torch.align` on 14b's checkpoint over the cv manifest:
     spans well formed and equal to the CPU's ctc_viterbi_align on the
     card's logits; 14e, `python -m tpu_asr_torch.average_checkpoints
     --last 3` on 14b's folder: every float weight the float32 mean of
     the three steps, frontend.json kept, recognize decodes the output.
 15. parallelism (tpu_asr_torch.parallel; 2 ranks share the one card,
     so they take gloo, which sums the CUDA tensors as they lie): 15a,
     one step of the aishell preset's model (bf16, dropout 0, seeded
     random weights) on parallel_batch (lengths, tokens and real rows
     uneven across the shards) on a dp 2 mesh, held to the same step in
     this process (PARALLEL_BOUNDS: each loss, the grad norm and every
     gradient gathered whole, grad_tree_gap), the CTC pair once on each
     rank, and the same step through a 1-rank NCCL group (its NCCL
     collectives in the trace); 15b, the use_pallas step on a tp 2 mesh
     (4 heads a rank: 18 flash forward, dq and dk/dv and 30 LN forward
     and backward launches on each rank), held likewise; each with
     device ms, busy share and peak memory for 1 process and for each
     rank; 15c, `python -m tpu_asr_torch.train --num-devices 2` on phase
     8's first 32 train utterances for 2 epochs: rank 0 alone wrote the
     metrics (2 cv lines) and the 2 checkpoints, which load into one
     process; 15d, `recognize --dp 2` in joint beam 5 on phase 8's
     aishell checkpoint (bf16) and the cv manifest against one process
     decoding each rank's shards alone (shard_decodes): the 1-best equal
     and every score within 1e-5 (compare_shard_hyps); the prefix scan
     launches on each rank. The ranks of 15c and 15d run the CLIs' own
     rank functions through counted_rank. Every rank records its
     kernels' inputs (record_rank_inputs) and holds each call against
     its plain version as phases 3-14 do (rank_kernel_errs); the errors
     join each kernel's max_abs_err.
 16. checkpoints in and out, and the recipe as users run it: 16a,
     `python -m tpu_asr_torch.export_torch` on phase 8's aishell
     checkpoint (the original PyTorch repo's .pth.tar), then `recognize
     --torch-ckpt <file> --ckpt <folder>` and `recognize --ckpt <folder>`
     in joint beam 5 (n-best 2) on phase 10's cv manifest: hypothesis
     files equal bit for bit, scores included, ctc_prefix_scan once a
     decoder step, its calls on the --torch-ckpt path against the plain
     version; two reference-named fixtures (the export under the other
     spellings KEY_ALIASES reads, and a full-width untied linear-input
     hybrid with a `model.` head) imported on the card give the logits of
     the files they came from bit for bit, every KEY_ALIASES rule fired;
     16b, `bash egs_torch/aishell/run.sh --data <tmp> --synthetic
     RECIPE_SCRIPT_UTTS --preset RECIPE_SCRIPT_PRESET --epochs
     RECIPE_SCRIPT_EPOCHS --device cuda` in a process of its own, stages
     -1 to 4 with the recipe's own CER-vs-beam gate, exit 0; its $PYTHON
     is a client of a fork server (`chip_smoke.py --fork-server`, torch
     and the port imported once), whose child for each `python -m` run
     counts the kernels' launches (the CTC pair once a train step and cv
     batch, the prefix scan once a joint decoder step, nothing else) and
     holds the calls it records against their plain versions;
     data/aishell and exp/ are left as they were.
 17. Whisper large-v3 (phase 17, run_whisper_phase): flash_attention_fwd
     at the shape its encoder gives it as served (32 windows, Tq = Tk =
     1500, 20 heads of 64, no mask, bf16) against its plain version at
     FLASH_BF16_TOL, timed beside it with its bound; the model at its
     published widths on random weights behind the AsrServer that `python
     -m tpu_asr_torch.serve --random-init --preset whisper_large_v3`
     builds (beam 5, batch 32, one 1000-frame bucket, maxlenratio
     0.0625), 32 wav requests at once, then again under torch.profiler:
     the flash kernel launches once an encoder layer a batch (32) and
     nowhere else, counted from 0 before each run and, in the second, as
     many events in the trace; every beam step a graph replay; each
     1-best within the vocabulary and its cap; the path's first flash
     call against the plain version, timed.
Then one JSON line for the kernels, the card line, and the last line
{"ok": true, "device": {...}}.

  python3 chip_smoke.py --whisper

runs phases 1, 2 (the flash forward's library alone) and 17 only.

  python3 chip_smoke.py --beam-ties N

measures instead, and checks nothing: 13b's streamed beam 5 against the
offline one on N streaming checkpoints trained as 13a (seeds 0 .. N-1),
logging where the two searches part for every 1-best that differs.

  python3 chip_smoke.py --parallel-faults

runs 15a and 15b once with each fault of PARALLEL_FAULTS injected into
the ranks, and exits 0 only if every fault exceeds a bound of
PARALLEL_BOUNDS (it logs which).

  python3 chip_smoke.py --fork-server <socket> <dir>

serves phase 16b's $PYTHON (fork_server): each `python -m <module>` run
it forks has its kernel launches counted and its kernel calls held
against their plain versions, and writes its record to <dir>.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
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


def device_events(fn, name: str, reps: int = 10) -> tuple[dict, int]:
    """({kernel name: count} of every device-side event (kernels, copies,
    memsets) that calls of fn() leave in a torch.profiler trace, the
    number of calls): what a wrapper launches besides its kernel. A trace
    without the kernel whose name contains `name` is taken again with
    twice the calls, up to 4 times (reps, 2 reps, 4 reps, 8 reps), as
    kernel_device_ms does; if none holds it, this fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        calls = reps << attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if any(name in k for k in found):
            return found, calls
        log(f"profiler: no launch of {name} traced in {calls} calls (trace "
            f"{attempt + 1} of 4)")
    raise AssertionError(f"the profiler saw no launch of {name} in 4 traces")


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
        *args, return_hist=hist), reps=5, warmup=1)
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
        # a call while a CUDA graph is captured runs nothing: its inputs
        # hold no values yet, and a clone would join the graph
        if key is not None and key not in captures and not (
                torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
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


# the joint beam's later call of ctc_prefix_scan kept in each bucket,
# beside its first: a step whose prefixes are no longer empty
LATER_PREFIX_CALL = 10


class PathLabels:
    """The labels under which record_inputs keeps a path's kernel inputs:
    ctc_prefix_scan's first and LATER_PREFIX_CALL-th call at each T', and
    at each encoder T' the first flash call of each kind and the first
    post-norm LN call of the encoder and of the decoder. A flash call that
    is not causal and has as many queries as keys is the encoder's
    self-attention and sets the T'; the next causal or cross-attention
    call starts the decoder."""

    def __init__(self, path=None):
        self.head = f"{path} " if path else ""
        self.calls, self.t, self.part = {}, None, "encoder"

    def prefix(self, x_cand, *_, **__):
        t = x_cand.shape[1]
        self.calls[t] = self.calls.get(t, 0) + 1
        if self.calls[t] in (1, LATER_PREFIX_CALL):
            return f"{self.head}T'={t} call {self.calls[t]}"
        return None

    def flash(self, q, k, v, valid, causal):
        if causal:
            kind, self.part = "decoder self-attention (causal)", "decoder"
        elif q.shape[1] == k.shape[1]:
            kind, self.part, self.t = ("encoder self-attention", "encoder",
                                       q.shape[1])
        else:
            kind, self.part = "decoder cross-attention", "decoder"
        return f"{self.head}T'={self.t} {kind}"

    def ln(self, r, *_):
        return f"{self.head}T'={self.t} {self.part} LN"


@contextlib.contextmanager
def record_prefix_inputs(caps: dict, labels: PathLabels):
    """record_inputs of ctc_prefix_scan into caps under labels.prefix, on
    a path whose Recognizer may replay its beam step as a CUDA graph. A
    replay calls no Python wrapper, so while a T' has had fewer than
    LATER_PREFIX_CALL calls, each joint search made with a graph runs once
    more with its step eager: its launches are taken back off the kernels'
    counters, and it must give the graphed search's tokens, lengths,
    scores and steps bit for bit."""
    from tpu_asr_torch.decode import beam, ctc_prefix as scorer_module
    from tpu_asr_torch.decode import recognizer as rec_module
    installed = rec_module.attention_beam_search

    def searched(decoder, enc_out, *args, graphs=None, **kwargs):
        out = installed(decoder, enc_out, *args, graphs=graphs, **kwargs)
        ctc_logp = kwargs.get("ctc_logp")
        if graphs is None or ctc_logp is None or labels.calls.get(
                ctc_logp.shape[1], 0) >= LATER_PREFIX_CALL:
            return out
        kernels = beam._step_kernels()
        before = [getattr(m, name).launches for m, name in kernels]
        eager = beam.attention_beam_search(decoder, enc_out, *args, **kwargs)
        for (m, name), n in zip(kernels, before):
            getattr(m, name).launches = n
        differ = [k for k in ("tokens", "lengths", "scores")
                  if not torch.equal(out[k], eager[k])]
        if differ or out["steps"] != eager["steps"]:
            raise AssertionError(
                f"the graphed joint beam at T'={ctc_logp.shape[1]} is not "
                f"the eager one's: {differ}, steps {out['steps']} / "
                f"{eager['steps']}")
        return out
    with record_inputs(scorer_module, "ctc_prefix_scan", caps,
                       labels.prefix):
        rec_module.attention_beam_search = searched
        try:
            yield
        finally:
            rec_module.attention_beam_search = installed


def check_prefix_labels(caps: dict, what: str):
    """Every T' at which a path kept prefix-scan inputs kept both its
    first call and its LATER_PREFIX_CALL-th, so that a lost label fails
    the check instead of shrinking it."""
    kept = {}
    for label in caps:
        head, _, n = label.rpartition(" call ")
        kept.setdefault(head, set()).add(int(n))
    short = sorted(h for h, calls in kept.items()
                   if calls != {1, LATER_PREFIX_CALL})
    if short:
        raise AssertionError(f"{what}: calls 1 and {LATER_PREFIX_CALL} of "
                             f"the prefix scan not both kept at {short}")


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


def check_flash_ln_on_paths(flash_caps, ln_caps,
                            path="the use_pallas serving path"):
    """Both kernels against their plain versions, timed, on the inputs a
    path gave them (after its counts were read). -> ({label: flash
    timings}, {label: LN timings}, errors); each label's timings carry
    its shape and max abs error."""
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
                              shape=what, max_abs_err=oe, lse_max_abs_err=le)
    for label, (r, h, g, b, _eps) in ln_caps.items():
        what = f"{label}: {list(r.shape)} {r.dtype}"
        e, u, w = compare_ln(r, h, g, b, what)
        errs["ln"], errs["ln_ulps"] = max(errs["ln"], e), max(errs["ln_ulps"],
                                                              u)
        errs["ln_raw"] = max(errs["ln_raw"], w)
        ln_t[label] = dict(time_ln(r, h, g, b, what), shape=what,
                           max_abs_err=e, bf16_ulps_at_output_scale=u)
    log(f"flash_attention_fwd and layer_norm_residual_fwd vs plain on "
        f"{path}'s inputs: {len(flash_caps)} + {len(ln_caps)} calls agree: "
        + json.dumps(errs))
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
    events, reps = device_events(fn, symbol)
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


def check_prefix_on_paths(prefix_caps):
    """ctc_prefix_scan on the inputs a path gave it (recorded while the
    path ran, after its counts were read) against its plain version,
    timed and bounded. -> ({label: timings, shape and max abs error},
    max abs error)."""
    check_prefix_labels(prefix_caps, "the paths")
    err, prefix_t = 0.0, {}
    for label, args in prefix_caps.items():
        lengths = args[6]
        what = (f"{label}: N={args[0].shape[0]} T={args[0].shape[1]} "
                f"K={args[0].shape[2]}, lengths {int(lengths.min())}-"
                f"{int(lengths.max())}")
        e = compare_prefix(list(args), what)
        err = max(err, e)
        prefix_t[label] = dict(time_prefix(list(args), True, what),
                               shape=what, max_abs_err=e)
    return prefix_t, err


def check_ctc_pair_on_paths(ctc_caps):
    """ctc_loss_fwd and ctc_loss_bwd on the first backward's inputs of
    each training (recorded while the paths ran, after their counts were
    read; the forward's are the first five, and its alpha and nll must
    equal the path's forward's bit for bit), against their plain
    versions, timed and bounded. -> ({label: {"fwd": forward timings,
    "bwd": backward timings}}, {"fwd", "bwd": max abs error}, the number
    of labels whose forward gave the plain version's bits)."""
    errs = dict(fwd=0.0, bwd=0.0)
    ctc_t = {}
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
    return ctc_t, errs, bitwise


def check_ctc_on_paths(prefix_caps, ctc_caps):
    """ctc_prefix_scan on the inputs the joint beam gave it (each bucket's
    first call and a later one), and the CTC pair on the first backward's
    inputs of each training (check_ctc_pair_on_paths), against their
    plain versions, timed and bounded. -> ({label: prefix timings},
    {label: {"fwd": forward timings, "bwd": backward timings}},
    errors)."""
    prefix_t, prefix_err = check_prefix_on_paths(prefix_caps)
    ctc_t, errs, bitwise = check_ctc_pair_on_paths(ctc_caps)
    errs["prefix"] = prefix_err
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
    """`steps` TrainSteps (with the model's LFR) from the same seeded init
    on one batch, on the card and on the CPU. -> {"card" | "cpu":
    (metrics of each step, step 1's update, kernel launches)}."""
    from tpu_asr_torch.train import NoamAdam, TrainStep
    from tpu_asr_torch.train.loop import model_lfr
    from tpu_asr_torch.weights import init_random
    out = {}
    for key, dev in (("card", DEVICE), ("cpu", "cpu")):
        model = init_random(model_cls(cfg), SEED).to(dev)
        ts = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model, 100),
                       device=dev, seed=SEED, lfr=model_lfr(cfg))
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


def check_conformer_agreement():
    """conformer_dev in float32 (dropout 0), as hybrid_dev is held: the
    same batch decodes to the same tokens on the card and on the CPU in
    joint (the prefix-scan kernel on the card) and attn_rescore; two
    TrainSteps from the same init on one batch: both steps' losses within
    1e-4, step 1's grad norm within 1e-3 relative, the CTC kernels
    launched once a step on the card."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("conformer_dev").model,
                              vocab_size=64)
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    wavs = {"wav": wav, "wav_lengths": lens}
    score_gap = {}
    for mode in ("joint", "attn_rescore"):
        out = {}
        for dev in (DEVICE, "cpu"):
            rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                             mode=mode, device=dev,
                             beam=BeamConfig(beam=4, max_len=12,
                                             ctc_weight=0.3, nbest=4))
            out[dev] = rec.decode_batch_nbest(wavs)
        tokens = {d: [[h["yseq"] for h in row] for row in out[d]]
                  for d in out}
        if tokens[DEVICE] != tokens["cpu"]:
            raise AssertionError(f"conformer_dev {mode}: card {tokens[DEVICE]}"
                                 f" != CPU {tokens['cpu']}")
        score_gap[mode] = max(abs(a["score"] - b["score"])
                              for ra, rb in zip(out[DEVICE], out["cpu"])
                              for a, b in zip(ra, rb))

    batch = train_batch(rng, 4, 200, [200, 151, 0, 97], [8, 5, 0, 3], 8)
    runs = train_on_both(Transformer, cfg, batch, 2)
    (card, card2), (cpu, cpu2) = (runs[d][0] for d in ("card", "cpu"))
    losses = ("loss", "loss_att", "loss_ctc", "acc")
    bad = [k for k in losses if abs(card[k] - cpu[k]) > 1e-4]
    bad += [f"step 2 {k}" for k in losses if abs(card2[k] - cpu2[k]) > 1e-4]
    if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
            1e-3 * abs(cpu["grad_norm"]):
        raise AssertionError(f"conformer_dev train step on the card {card} "
                             f"{card2} != on the CPU {cpu} {cpu2}: {bad}")
    launches = {k: n for k, n in runs["card"][2].items() if n}
    if launches != {"ctc_loss_fwd": 2, "ctc_loss_bwd": 2}:
        raise AssertionError(f"conformer_dev train steps launched {launches}")

    log("agreement: conformer_dev joint and attn_rescore beam-4 tokens on "
        "the card == on the CPU (largest score gap "
        f"{json.dumps(score_gap)}); train steps on the card == on the CPU "
        "(losses of steps 1 and 2 within 1e-4, grad norm within 1e-3 "
        "relative; CTC kernels once a step on the card): "
        + json.dumps({"step1": {k: [card[k], cpu[k]] for k in sorted(card)},
                      "step2": {k: [card2[k], cpu2[k]] for k in losses}}))


def check_input_agreement():
    """Phase 4, the reference's own inputs: a small attention_lfr-shaped
    model (hybrid_dev widths, model_type transformer, the linear input
    layer, LFR (4, 3)) and hybrid_dev with 83-dim (fbank + pitch) inputs,
    each on a feats batch whose features the CPU made once (so pitch's
    lag decisions cannot flip between the two runs): beam (joint for the
    hybrid) beam-4 tokens equal on the card and on the CPU, scores within
    1e-3; two TrainSteps from the same init: both steps' losses within
    1e-4, step 1's grad norm within 1e-3 relative; the CTC kernels once a
    step on the card for the hybrid, no kernel for the attention-only
    model."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import init_random

    dev = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64)
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    tlens = np.array([8, 5, 3, 0], np.int32)
    targets = np.full((4, 8), -1, np.int32)
    for i, n in enumerate(tlens):
        targets[i, :n] = rng.integers(2, 62, n)
    cases = (
        ("attention_lfr-shaped (linear input, LFR 4/3)",
         dataclasses.replace(dev, model_type="transformer",
                             input_layer="linear", lfr_m=4, lfr_n=3),
         FrontendConfig(), "beam", {}),
        ("hybrid_dev with 83-dim fbank + pitch",
         dataclasses.replace(dev, d_input=83),
         FrontendConfig(add_pitch=True), "joint",
         {"ctc_loss_fwd": 2, "ctc_loss_bwd": 2}))
    for name, cfg, fcfg, mode, want_launches in cases:
        feats, flens = wav_to_features(torch.from_numpy(wav),
                                       torch.from_numpy(lens), fcfg)
        batch = {"feats": feats.numpy(), "feat_lengths": flens.numpy()}
        out = {}
        for d in (DEVICE, "cpu"):
            rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                             mode=mode, device=d,
                             beam=BeamConfig(beam=4, max_len=12, nbest=4,
                                             ctc_weight=0.3 if mode ==
                                             "joint" else 0.0))
            out[d] = rec.decode_batch_nbest(batch)
        for a, b in zip(out[DEVICE], out["cpu"]):
            for ha, hb in zip(a, b):
                if ha["yseq"] != hb["yseq"] or \
                        abs(ha["score"] - hb["score"]) > 1e-3:
                    raise AssertionError(f"{name} {mode}: card {ha} != CPU "
                                         f"{hb}")
        runs = train_on_both(Transformer, cfg, dict(
            batch, targets=targets, target_lengths=tlens), 2)
        (card, card2), (cpu, cpu2) = (runs[d][0] for d in ("card", "cpu"))
        losses = [k for k in ("loss", "loss_att", "loss_ctc", "acc")
                  if k in card]
        bad = [k for k in losses if abs(card[k] - cpu[k]) > 1e-4]
        bad += [f"step 2 {k}" for k in losses
                if abs(card2[k] - cpu2[k]) > 1e-4]
        if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
                1e-3 * abs(cpu["grad_norm"]):
            raise AssertionError(f"{name} train step on the card {card} "
                                 f"{card2} != on the CPU {cpu} {cpu2}: {bad}")
        launches = {k: n for k, n in runs["card"][2].items() if n}
        if launches != want_launches:
            raise AssertionError(f"{name} train steps launched {launches}, "
                                 f"expected {want_launches}")
        log(f"agreement: {name}: {mode} beam-4 tokens on the card == on the "
            f"CPU (features made once on the CPU, D = {feats.shape[2]}); "
            f"train steps on the card == on the CPU (losses of steps 1 and "
            f"2 within 1e-4, grad norm within 1e-3 relative; card launches "
            f"{json.dumps(launches)}): "
            + json.dumps({"step1": {k: [card[k], cpu[k]] for k in
                                    sorted(card)},
                          "step2": {k: [card2[k], cpu2[k]] for k in
                                    losses}}))


# the transducer presets phase 4 holds card against CPU: (preset, fields
# changed); the conformer's also with the offline chunk mask
TRANSDUCER_AGREEMENT = (("transducer_dev", {}),
                        ("conformer_transducer_dev", {}),
                        ("conformer_transducer_dev", {"enc_chunk_size": 4}))


def check_greedy_times(card_out, cpu_out, wav_lengths, cfg, name):
    """transducer_greedy's times on the card equal the CPU's, and each
    row's are non-decreasing and below its encoder length."""
    from tpu_asr_torch.frontend import FrontendConfig
    frames = FrontendConfig().num_frames
    for i, (a, b) in enumerate(zip(card_out, cpu_out)):
        times = a[0]["times"]
        enc = cfg.subsampled_length(frames(int(wav_lengths[i]))) \
            if wav_lengths[i] else 0
        if times != b[0]["times"] or times != sorted(times) or \
                any(not 0 <= x < enc for x in times):
            raise AssertionError(f"{name} greedy row {i}: times {times} "
                                 f"(CPU {b[0]['times']}), encoder length "
                                 f"{enc}")


def check_transducer_agreement():
    """transducer_dev and conformer_transducer_dev (the latter also with
    enc_chunk_size 4) in float32, dropout 0: transducer_greedy,
    transducer_beam 4 and transducer_rescore 4 give equal tokens on the
    card and on the CPU (greedy's times too, non-decreasing and below
    each encoder length), beam and rescore scores within 1e-3; two
    TrainSteps from the same init on one batch: both steps' losses within
    1e-4, step 1's grad norm within 1e-3 relative, the CTC kernels (the
    aux head) launched once a step on the card."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transducer import TransducerModel
    from tpu_asr_torch.weights import init_random

    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    wavs = {"wav": wav, "wav_lengths": lens}
    batch = train_batch(rng, 4, 200, [200, 151, 0, 97], [8, 5, 0, 3], 8)
    modes = (("transducer_greedy", BeamConfig(beam=1, max_len=12)),
             ("transducer_beam", BeamConfig(beam=4, max_len=12, nbest=4)),
             ("transducer_rescore", BeamConfig(beam=4, max_len=12, nbest=4,
                                               ctc_weight=0.5)))
    report = {}
    for preset, fields in TRANSDUCER_AGREEMENT:
        cfg = dataclasses.replace(get_preset(preset).model, vocab_size=64,
                                  **fields)
        name = preset + "".join(f" {k}={v}" for k, v in fields.items())
        gaps = {}
        for mode, beam in modes:
            out = {}
            for dev in (DEVICE, "cpu"):
                rec = Recognizer(cfg, init_random(TransducerModel(cfg), SEED),
                                 mode=mode, device=dev, beam=beam)
                out[dev] = rec.decode_batch_nbest(wavs)
            tokens = {d: [[h["yseq"] for h in row] for row in out[d]]
                      for d in out}
            gap = max(abs(a["score"] - b["score"])
                      for ra, rb in zip(out[DEVICE], out["cpu"])
                      for a, b in zip(ra, rb) if b["score"] > -1e29)
            if tokens[DEVICE] != tokens["cpu"] or gap > 1e-3:
                raise AssertionError(f"{name} {mode}: card {tokens[DEVICE]} "
                                     f"!= CPU {tokens['cpu']}, or a score "
                                     f"gap {gap} > 1e-3")
            gaps[mode] = gap
            if mode == "transducer_greedy":
                check_greedy_times(out[DEVICE], out["cpu"], lens, cfg, name)
        runs = train_on_both(TransducerModel, cfg, batch, 2)
        (card, card2), (cpu, cpu2) = (runs[d][0] for d in ("card", "cpu"))
        losses = ("loss", "loss_rnnt", "loss_ctc")
        bad = [k for k in losses if abs(card[k] - cpu[k]) > 1e-4]
        bad += [f"step 2 {k}" for k in losses
                if abs(card2[k] - cpu2[k]) > 1e-4]
        if bad or abs(card["grad_norm"] - cpu["grad_norm"]) > \
                1e-3 * abs(cpu["grad_norm"]):
            raise AssertionError(f"{name} train step on the card {card} "
                                 f"{card2} != on the CPU {cpu} {cpu2}: {bad}")
        launches = {k: n for k, n in runs["card"][2].items() if n}
        if launches != {"ctc_loss_fwd": 2, "ctc_loss_bwd": 2} or \
                any(runs["cpu"][2].values()):
            raise AssertionError(f"{name} train steps launched {launches}")
        report[name] = {"score_gap": gaps,
                        "step1": {k: [card[k], cpu[k]] for k in sorted(card)},
                        "step2": {k: [card2[k], cpu2[k]] for k in losses}}
    log("agreement: transducer_dev, conformer_transducer_dev and "
        "conformer_transducer_dev with enc_chunk_size 4: greedy, beam-4 "
        "and rescore-4 tokens on the card == on the CPU (scores within "
        "1e-3); train steps on the card == on the CPU (losses of steps 1 "
        "and 2 within 1e-4, grad norm within 1e-3 relative; CTC kernels "
        "once a step on the card): " + json.dumps(report))


# the streaming recognizers phase 4 holds card against CPU: (name,
# preset, recognizer, its keyword arguments)
STREAMING_AGREEMENT = (
    ("greedy CTC", "hybrid_dev", "StreamingCTCRecognizer", {}),
    ("CTC beam 4", "hybrid_dev", "StreamingCTCBeamRecognizer", {"beam": 4}),
    ("conformer greedy CTC", "conformer_dev", "StreamingCTCRecognizer", {}),
    ("CIF", "cif_dev", "StreamingCIFRecognizer", {}),
    ("CIF recompute", "cif_dev", "StreamingCIFRecognizer",
     {"incremental": False}),
    ("transducer", "transducer_dev", "StreamingTransducerRecognizer", {}))


def check_streaming_agreement():
    """Each STREAMING_AGREEMENT recognizer on its dev preset with
    enc_chunk_size 4 (float32, random weights from SEED) streams the same
    features in pushes of 37 frames on the card and on the CPU: every
    push's return and the final hypothesis equal, and the times where the
    recognizer gives them."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode import streaming
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random

    rng = np.random.default_rng(SEED)
    feats = (rng.standard_normal((300, 80)) * 3).astype(np.float32)
    report = {}
    for name, preset, cls, kw in STREAMING_AGREEMENT:
        cfg = dataclasses.replace(get_preset(preset).model, vocab_size=64,
                                  enc_chunk_size=4)
        out = {}
        for dev in (DEVICE, "cpu"):
            rec = getattr(streaming, cls)(
                cfg, init_random(build_model(cfg), SEED), max_frames=320,
                device=dev, **kw)
            outs, hyp, _ = stream_pushes(rec, feats, 37)
            out[dev] = (outs, hyp, getattr(rec, "hypothesis_times", None))
        if out[DEVICE] != out["cpu"] or not out["cpu"][1]:
            raise AssertionError(f"streaming {name} ({preset}, chunk 4): "
                                 f"card {out[DEVICE]} != CPU {out['cpu']}")
        report[name] = len(out["cpu"][1])
    log("agreement: streaming with enc_chunk_size 4, pushes of 37 frames: "
        "every push and the final hypothesis (and the times) on the card =="
        " on the CPU; tokens by recognizer " + json.dumps(report))


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


def small_lm(vocab):
    """A seeded random LM (d32, h2, 2 layers, float32) and its config."""
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.weights import init_random
    cfg = LMConfig(vocab_size=vocab, d_model=32, d_inner=64, num_heads=2,
                   num_layers=2, dropout=0.0)
    return cfg, init_random(TransformerLM(cfg), SEED + 1)


def check_lm_agreement():
    """hybrid_dev in float32 with a small LM: joint (ctc_prefix_scan
    kernel) and ctc_beam with LM fusion give equal tokens on the card and
    on the CPU, scores within 1e-3; attn_rescore with the LM term and
    use_pallas (flash and LN kernels on the card) gives equal tokens."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import init_random

    counters = kernel_counters()
    names = ("ctc_prefix_scan", "flash_attention_fwd",
             "layer_norm_residual_fwd")
    rng = np.random.default_rng(SEED)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = synth_wav(int(n), rng)
    batch = {"wav": wav, "wav_lengths": lens}
    launches = {}
    # beam 8 in attn_rescore: 4 x 8 x 24 = 768 decoder rows, so the LN
    # kernel runs as well as the flash kernel
    for mode, use_pallas, lw, beam, max_len in (
            ("joint", False, 0.3, 4, 12), ("ctc_beam", False, 0.1, 4, 12),
            ("attn_rescore", True, 0.3, 8, 24)):
        cfg = dataclasses.replace(get_preset("hybrid_dev").model,
                                  vocab_size=64, use_pallas=use_pallas)
        out = {}
        for dev in ("cuda", "cpu"):
            lm_cfg, lm = small_lm(cfg.vocab_size)
            rec = Recognizer(cfg, init_random(Transformer(cfg), SEED),
                             mode=mode, device=dev, lm_cfg=lm_cfg, lm=lm,
                             beam=BeamConfig(beam=beam, max_len=max_len,
                                             ctc_weight=0.3, nbest=beam,
                                             lm_weight=lw))
            before = {k: counters[k].launches for k in names}
            out[dev] = rec.decode_batch_nbest(batch)
            launches[mode, dev] = {k: counters[k].launches - before[k]
                                   for k in names}
        for a, b in zip(out["cuda"], out["cpu"]):
            for ha, hb in zip(a, b):
                if ha["yseq"] != hb["yseq"] or (
                        mode != "attn_rescore"
                        and abs(ha["score"] - hb["score"]) > 1e-3):
                    raise AssertionError(f"LM-fused {mode}: card {ha} != "
                                         f"CPU {hb}")
    card = {m: launches[m, "cuda"] for m in ("joint", "ctc_beam",
                                             "attn_rescore")}
    if not (card["joint"]["ctc_prefix_scan"] > 0
            and card["attn_rescore"]["flash_attention_fwd"] > 0
            and card["attn_rescore"]["layer_norm_residual_fwd"] > 0
            and not any(v for m in card for k, v in
                        launches[m, "cpu"].items())):
        raise AssertionError(f"LM agreement launches: {launches}")
    log("agreement: hybrid_dev with a small LM (d32, 2 layers): joint "
        "(lm 0.3) and ctc_beam (lm 0.1) beam 4 on the card == on the CPU "
        "(tokens equal, scores within 1e-3), use_pallas attn_rescore beam "
        "8 (lm 0.3) tokens equal; card launches " + json.dumps(card))


def profile_device(fn, what, card, host_top=0, warmup=False):
    """Run fn() under torch.profiler: device time by kernel, and the
    device's busy share of the wall time (-> wall ms, device ms, device
    events, {device event: count}; with host_top, also the host's self
    CPU ms and its host_top largest ops by self CPU time are logged). Only device-side events
    (kernels, copies, memsets) count: a CPU op's self device time is the
    time of the kernels it launched, which are listed themselves, and a
    record_function range (Optimizer.step) spans its kernels and the gaps
    between them. With warmup, fn() runs once first as the profiler's
    warm-up step, whose events are dropped: a call of a few ms late in a
    long process otherwise loses its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    steps = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup \
        else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=steps) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        wall0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        if warmup:
            prof.step()
    averages = prof.key_averages()
    avg = [e for e in averages if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in avg)
    top = sorted(avg, key=lambda e: -e.self_device_time_total)[:20]
    events = sum(e.count for e in avg)
    log(f"profile {what}: wall {wall * 1e3:.1f} ms (profiler on), device "
        f"busy {busy_us / 1e3:.1f} ms = {busy_us / 1e4 / wall:.1f}%, "
        f"{events} device events [{card}]")
    for e in top:
        log(f"profile {what}:   {e.key[:70]:70s} "
            f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count}")
    out = {"wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
           "device_events": events,
           "kernels": {e.key: e.count for e in avg}}
    if host_top:
        ops = [e for e in averages if e.device_type == DeviceType.CPU]
        out["host_self_ms"] = sum(e.self_cpu_time_total for e in ops) / 1e3
        log(f"profile {what}: host self CPU {out['host_self_ms']:.1f} ms "
            f"(profiler on); largest host ops:")
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            log(f"profile {what}:   {e.key[:70]:70s} "
                f"{e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count}")
    return out


def profile_serving(server, wavs, card, what="serving", threads=8):
    """The same requests again under torch.profiler (not counted above),
    from `threads` threads -> what profile_device gives."""
    def run():
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda w: server.submit("wav", w, timeout=600.0),
                          wavs))
    return profile_device(run, what, card)


def post_recognize(server, wav, chars=None):
    """One POST /recognize of `wav` through make_http_server in front of
    a started AsrServer (`chars`: the --dict tokens) -> (status, body).
    The HTTP server is shut down after; the AsrServer keeps running."""
    from tpu_asr_torch.serve import make_http_server
    httpd = make_http_server("127.0.0.1", 0, server, chars)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize"
        req = urllib.request.Request(
            url, data=json.dumps({"wav": wav.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def serve_requests(server, wavs, threads=8):
    """The requests from `threads` threads -> ([(nbest, latency s)],
    wall s)."""
    def one(wav):
        start = time.perf_counter()
        nbest = server.submit("wav", wav, timeout=600.0)
        return nbest, time.perf_counter() - start

    wall0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
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

    labels = PathLabels()

    # main path: counts from 0 just before, read just after
    flash_fwd, ln_fwd = fa.flash_attention_fwd, ln.layer_norm_residual_fwd
    flash_fwd.launches = ln_fwd.launches = 0
    with record_inputs(fa, "flash_attention_fwd", flash_caps,
                       labels.flash), \
            record_inputs(ln, "layer_norm_residual_fwd", ln_caps, labels.ln):
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


def eager_beam_inputs(server, wavs, caps, labels):
    """The server's recognizer decodes `wavs` once more, a batch a bucket
    padded as the server pads it, with its beam step run eagerly, and
    ctc_prefix_scan's inputs are kept under labels.prefix: the replay of
    the step's CUDA graph calls no Python wrapper, and the graphed step
    gives the eager one's bits (tests/test_torch_gpu.py)."""
    from tpu_asr_torch.decode import ctc_prefix as scorer_module
    rec = server.rec
    graphs, rec.beam_graphs = rec.beam_graphs, None
    try:
        with record_inputs(scorer_module, "ctc_prefix_scan", caps,
                           labels.prefix):
            for bucket, t in enumerate(server.bucket_frames):
                mine = [w for w in wavs if server._bucket_for(
                    len(w) // server.frontend.frame_shift) == bucket]
                if not mine:
                    continue
                wav = np.zeros((server.batch_size,
                                t * server.frontend.frame_shift), np.float32)
                lens = np.zeros(server.batch_size, np.int32)
                for i, w in enumerate(mine[:server.batch_size]):
                    wav[i, :len(w)] = w
                    lens[i] = len(w)
                rec.decode_batch_nbest({"wav": wav, "wav_lengths": lens})
    finally:
        rec.beam_graphs = graphs


def run_serving(card, prefix_caps):
    """The aishell-width hybrid model in joint beam 5 behind AsrServer;
    the inputs of ctc_prefix_scan's first call and its LATER_PREFIX_CALL-th
    call in each bucket go into prefix_caps (eager_beam_inputs). ->
    launches."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops.ctc_prefix import KERNEL_SYMBOL, ctc_prefix_scan
    from tpu_asr_torch.serve import AsrServer
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

    labels = PathLabels("joint beam")

    # main path: counts from 0 just before, read just after
    ctc_prefix_scan.launches = 0
    rec.decode_steps = 0
    results, wall = serve_requests(server, wavs)
    launches, steps = ctc_prefix_scan.launches, rec.decode_steps
    eager_beam_inputs(server, wavs, prefix_caps, labels)

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
    # the kernels the card ran, as its trace counts them (a graph replay's
    # too), against the steps and the wrapper's count, which replays add
    rec.decode_steps = rec.graph_steps = 0
    counted = ctc_prefix_scan.launches
    kernels = profile_serving(server, wavs, card)["kernels"]
    traced = sum(n for k, n in kernels.items() if KERNEL_SYMBOL in k)
    counted = ctc_prefix_scan.launches - counted
    if not (traced == counted == rec.decode_steps > 0) or \
            rec.graph_steps != rec.decode_steps:
        raise AssertionError(
            f"serving under the profiler: {traced} {KERNEL_SYMBOL} events "
            f"traced, {counted} launches counted, {rec.decode_steps} "
            f"decode steps ({rec.graph_steps} replayed)")
    log(f"serving under the profiler: {traced} {KERNEL_SYMBOL} events "
        f"traced == launches counted == decode steps, all replayed from "
        f"a graph [{card}]")

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
    try:
        status, body = post_recognize(server, wavs[0])
    finally:
        server.stop()
    if status != 200 or "tokens" not in body:
        raise AssertionError(f"/recognize answered {status}: {body}")
    if body["tokens"] != results[0][0][0]["yseq"]:
        raise AssertionError("/recognize disagrees with submit()")
    log(f"http: POST /recognize -> 200, {len(body['tokens'])} tokens")
    return launches


# ---- phase 8: training ----

class TimedLoader:
    """A train loader that records a CUDA event (no sync) at every batch
    boundary, so each step's time on the device's timeline is read after
    the run, and counts the real utterances and audio samples of each
    batch (a feature frame is the frontend's frame_shift samples)."""

    def __init__(self, loader, frame_shift: int):
        self.loader = loader
        self.frame_shift = frame_shift
        self.steps = []          # (start event, end event, utts, samples)

    def __iter__(self):
        prev = None
        for batch in self.loader:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if prev is not None:
                self.steps.append((prev[0], ev) + prev[1:])
            samples = (int(batch["wav_lengths"].sum()) if "wav" in batch
                       else int(batch["feat_lengths"].sum())
                       * self.frame_shift)
            prev = (ev, len(batch["ids"]), samples)
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


def fixed_shape_batch(b=32, t=1000, u=24, v=4233, d=80):
    rng = np.random.default_rng(SEED)
    return {"feats": rng.standard_normal((b, t, d)).astype(np.float32),
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
                 model_overrides=None, bwd_caps=None, ctc_caps=None,
                 argv=(), stats=None, profiled_steps=4, min_epochs=2,
                 fixed_steps=20):
    """The Solver that `python -m tpu_asr_torch.train --preset <preset>
    <argv>` builds (with `model_overrides` to its ModelConfig, as
    build_solver takes them), on `data` (None: the manifests argv names),
    for >= MIN_TRAIN_STEPS steps and >= min_epochs epochs (a checkpoint
    an epoch); then a checkpoint restore, a profile
    of `profiled_steps` steps (the profiler takes about half a
    millisecond of host time an event to read its trace) and
    `fixed_steps` steps at the fixed shape; `stats` (a dict) gets the epochs'
    history, the step times, throughput, peak memory and the profile.
    A CIF model's firing inputs of its first train and cv batch go into
    `captures`; with use_pallas, the inputs of the flash and LN backward
    of the first train batch of each bucket into bwd_caps["flash"] and
    bwd_caps["ln"]; the inputs of the first ctc_loss_bwd into ctc_caps.
    Every ctc_loss_fwd and ctc_loss_bwd must take the warp route; an
    attention-only model (model_type transformer) launches neither. ->
    {kernel name: launches in the Solver run}."""
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.modules import FUSED_LN_MIN_ROWS, PostNormBlock
    from tpu_asr_torch.ops import ctc_loss as ctc_module
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln
    from tpu_asr_torch.train.__main__ import build_solver, parse_args

    args = parse_args(["--preset", preset, "--save-folder", workdir]
                      + list(argv))
    solver = build_solver(args, data, model_overrides)
    epochs = max(min_epochs,
                 -(-MIN_TRAIN_STEPS // len(solver.train_loader)))
    solver.epochs = epochs
    ts = solver.train_step
    timed = TimedLoader(solver.train_loader, ts.frontend.frame_shift)
    solver.train_loader = timed
    cfg = ts.model.cfg
    what = f"{preset} training" + (" with use_pallas" if cfg.use_pallas
                                   else "") + (
        " with pitch" if ts.frontend.add_pitch else "")
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
    step_metrics = []      # every train step's losses and grad norm
    wall0 = time.perf_counter()
    with records, wrap_method(type(ts), "__call__",
                              after=step_metrics.append):
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
    if steps < MIN_TRAIN_STEPS or ts.optimizer.count != steps or \
            len(step_metrics) != steps:
        raise AssertionError(f"{steps} steps, {ts.optimizer.count} updates,"
                             f" {len(step_metrics)} step metrics")
    loss_keys = sorted(k for k in step_metrics[0]
                       if k.startswith("loss") or k == "grad_norm")
    per_step = torch.stack([torch.stack([m[k].float() for k in loss_keys])
                            for m in step_metrics]).cpu()
    if not torch.isfinite(per_step).all():
        raise AssertionError(f"{what}: a non-finite {loss_keys} in "
                             f"{per_step.tolist()}")
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
    ctc = int(cfg.model_type != "transformer")
    expect = {"ctc_loss_fwd": ctc * (steps + cv_batches),
              "ctc_loss_bwd": ctc * steps,
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
    audio_s = sum(x for _, _, _, x in steady) / ts.frontend.sample_rate
    second = (f"{cfg.num_pred_layers} predictor layers, d_joint "
              f"{cfg.d_joint}" if cfg.model_type == "transducer" else
              "no decoder" if cfg.model_type == "ctc" else
              f"{cfg.num_dec_layers} decoder layers")
    front = (f"conv {cfg.conv_channels}" if cfg.input_layer == "conv2d"
             else f"LFR ({cfg.lfr_m}, {cfg.lfr_n}) + linear "
                  f"{cfg.encoder_input_dim} -> {cfg.d_model}")
    log(f"{what}: {cfg.model_type} model (d{cfg.d_model}, h{cfg.num_heads},"
        f" {cfg.encoder_type} x{cfg.num_enc_layers} + {second}, {front}, "
        f"d_input {cfg.d_input}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"dropout {cfg.dropout}, SpecAugment "
        f"{'on' if ts.specaug else 'off'}) {epochs} epochs, {steps} steps + "
        f"{cv_batches} cv batches in {wall:.2f} s; kernel launches "
        f"{json.dumps(launches)} (CTC by route {json.dumps(routes)}); "
        f"post-norm calls of >= {FUSED_LN_MIN_ROWS}"
        f" rows {json.dumps(fused)}")
    log(f"{what}: per epoch " + json.dumps(solver.history))
    log(f"{what}: every step's {loss_keys} finite; first and last step "
        + json.dumps({k: [float(per_step[0, i]), float(per_step[-1, i])]
                      for i, k in enumerate(loss_keys)}))
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
    batches = [next(it) for _ in range(profiled_steps)]
    it.close()
    prof = profile_device(lambda: [ts(b) for b in batches], what, card)

    batch = fixed_shape_batch(d=cfg.d_input)
    for _ in range(3):
        ts(batch)
    n = fixed_steps
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for i in range(n):
        ts(batch)
        events[i + 1].record()
    torch.cuda.synchronize()
    fixed = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    total_s = events[0].elapsed_time(events[-1]) / 1e3
    log(f"{what}: fixed shape feats [32, 1000, {cfg.d_input}], U=24: {n} "
        f"steps, step ms median {statistics.median(fixed):.2f}, min "
        f"{min(fixed):.2f}; {n / total_s:.2f} steps/s, "
        f"{n * 32 / total_s:.1f} utterances/s, {n * 32 * 10 / total_s:.1f}"
        f" audio s/s [{card}]")
    if stats is not None:
        stats.update(
            history=solver.history, steps=steps, cv_batches=cv_batches,
            step_ms_median=statistics.median(step_ms),
            steps_per_s=len(steady) / steady_s,
            audio_s_per_s=audio_s / steady_s, peak_gib=peak / 2**30,
            profiled_steps=len(batches),
            device_ms_per_step=prof["device_ms"] / len(batches),
            busy_share=prof["device_ms"] / prof["wall_ms"],
            device_events_per_step=prof["device_events"] / len(batches),
            fixed_step_ms_median=statistics.median(fixed))
    return launches


# ---- phase 10: LM fusion and the decode CLIs ----

# train_lm on phase 8's transcripts with its default schedule (Noam,
# warmup 1000, k 0.5): 461 train utterances are 8 batches of 64 an epoch,
# so 13 epochs are 104 steps. The transcripts are uniform random tokens
# with uniform lengths 8-30, so what a model can learn of a held-out
# sequence is its length: lm_cv_floor, ~8.05 nats a target on the cv set,
# is the least cv loss such a model can reach, and an LM that goes below
# it by more than LM_FLOOR_MARGIN sees the tokens it predicts. The LM does
# not reach it: it learns the train set before the lengths, and its cv
# loss stops near ln 4233 (PERF.md). So the card's training is held to
# the CPU's instead: the same run (dropout 0, LM_CPU_EPOCHS epochs) on
# both, every epoch's train and cv loss within LM_CPU_ATOL.
LM_EPOCHS = 13
LM_CPU_EPOCHS = 2
LM_CPU_ATOL = 1e-4
LM_FLOOR_MARGIN = 0.05
LM_DECODES = (   # (name, checkpoint key, recognize flags)
    ("joint", "aishell", ["--mode", "joint", "--beam", "5", "--max-len",
                          "40", "--lm-weight", "0.3"]),
    ("ctc_beam", "aishell", ["--mode", "ctc_beam", "--beam", "10",
                             "--lm-weight", "0.1"]),
    ("attn_rescore", "use_pallas", ["--mode", "attn_rescore", "--beam",
                                    "10", "--lm-weight", "0.3"]))
PATH_KERNELS = ("ctc_prefix_scan", "flash_attention_fwd",
                "layer_norm_residual_fwd")
LM_PATHS = {"joint": "LM-fused joint (recognize)",
            "ctc_beam": "LM-fused ctc_beam (recognize)",
            "attn_rescore": "LM-rescored attn_rescore (recognize)"}


def lm_cv_floor(seqs, n_tokens: int) -> float:
    """The mean loss a target (eos included) on `seqs` of a model that
    draws each token uniformly from n_tokens ids and knows the length
    distribution of `seqs` itself: after k tokens it gives eos the share
    of the sequences of length k among those of length >= k. No model of
    i.i.d. uniform tokens does better on them in expectation."""
    import math
    lens = np.array([len(x) for x in seqs])
    total = 0.0
    for k in range(int(lens.max()) + 1):
        at, past = int((lens == k).sum()), int((lens > k).sum())
        if at:                       # eos after k tokens
            total -= at * math.log(at / (at + past))
        if past:                     # a token after k tokens
            total -= past * (math.log(past / (at + past))
                             - math.log(n_tokens))
    return total / float((lens + 1).sum())


def write_wav_manifest(utts, waves, directory) -> str:
    """Each utterance's wave as <directory>/wavs/<id>.npy and a manifest
    naming them (with their token transcripts) -> its path."""
    from tpu_asr_torch.data import save_manifest
    os.makedirs(os.path.join(directory, "wavs"), exist_ok=True)
    out = []
    for u in utts:
        path = os.path.join(directory, "wavs", f"{u.id}.npy")
        np.save(path, waves[u.id])
        out.append(dataclasses.replace(u, wav=path,
                                       num_samples=len(waves[u.id])))
    manifest = os.path.join(directory, "manifest.jsonl")
    save_manifest(out, manifest)
    return manifest


def last_json_line(text: str) -> dict:
    lines = [x for x in text.splitlines() if x.strip()]
    if not lines:
        raise AssertionError("the command printed nothing")
    return json.loads(lines[-1])


def run_cli(main_fn, argv):
    """main_fn(argv) with its standard output captured (and echoed) ->
    (what it returned, the JSON of the last line it printed)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    sys.stdout.write(buf.getvalue())
    return result, last_json_line(buf.getvalue())


def check_launches(what, got: dict, want: dict):
    """Each kernel launched exactly as often as the path called for it,
    and every kernel the path must run ran."""
    if got != want or not all(v > 0 for v in want.values()):
        raise AssertionError(f"{what}: kernel launches {got}, expected "
                             f"{want}")


@contextlib.contextmanager
def count_beam_steps(steps: list):
    """steps[0] += the decoder steps of each attention beam search that a
    Recognizer runs while this is on, as the search reports them (on the
    card most steps replay the step's CUDA graph, and no Python method of
    the decoder runs in those)."""
    from tpu_asr_torch.decode import recognizer as rec_module
    search = rec_module.attention_beam_search

    def counted(*args, **kwargs):
        out = search(*args, **kwargs)
        steps[0] += out["steps"]
        return out
    rec_module.attention_beam_search = counted
    try:
        yield
    finally:
        rec_module.attention_beam_search = search


@contextlib.contextmanager
def wrap_method(owner, name, before=None, after=None):
    """owner.<name> calls before() and after(result) around itself while
    this runs."""
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        if before is not None:
            before()
        out = fn(*args, **kwargs)
        if after is not None:
            after(out)
        return out

    setattr(owner, name, wrapped)
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def count_full_passes(counts):
    """Count, in every module while this runs, the full-pass attentions
    that take the flash formulation (use_pallas) and the post-norm calls
    that take the fused LN (use_pallas, >= 512 rows): what the flash and
    LN forward kernels must launch for."""
    from tpu_asr_torch.models.attention import MultiHeadAttention
    from tpu_asr_torch.models.decoder import Decoder
    from tpu_asr_torch.models.modules import FUSED_LN_MIN_ROWS, PostNormBlock

    def hook(module, inputs):
        if isinstance(module, MultiHeadAttention) and module.use_pallas:
            counts["flash_attention_fwd"] += 1
        elif isinstance(module, PostNormBlock) and module.use_pallas and \
                inputs[0].numel() // inputs[0].shape[-1] >= \
                FUSED_LN_MIN_ROWS:
            counts["layer_norm_residual_fwd"] += 1
        elif isinstance(module, Decoder):
            counts["decoder_passes"] += 1
    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def lm_losses(lm_dir) -> list[dict]:
    """The per-epoch lines train_lm wrote to <lm_dir>/metrics.jsonl."""
    with open(os.path.join(lm_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


def check_lm_on_cpu(card, workdir, argv):
    """train_lm with `argv`, dropout 0 and LM_CPU_EPOCHS epochs, on the
    card and on the CPU: every epoch's train and cv loss within
    LM_CPU_ATOL. -> the largest difference."""
    from tpu_asr_torch import train_lm
    runs, walls = {}, {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(workdir, f"lm_{device}")
        t0 = time.perf_counter()
        train_lm.main(argv + ["--dropout", "0", "--epochs",
                              str(LM_CPU_EPOCHS), "--save-folder", folder,
                              "--device", device])
        walls[device] = time.perf_counter() - t0
        runs[device] = lm_losses(folder)
    diffs = [abs(a[k] - b[k]) for a, b in zip(runs["cuda"], runs["cpu"])
             for k in ("train_loss", "loss")]
    if len(diffs) != 2 * LM_CPU_EPOCHS or not max(diffs) <= LM_CPU_ATOL:
        raise AssertionError(f"train_lm on the card {runs['cuda']} and on "
                             f"the CPU {runs['cpu']} differ by more than "
                             f"{LM_CPU_ATOL}")
    log(f"train_lm card == CPU (dropout 0, {LM_CPU_EPOCHS} epochs): train "
        f"and cv losses {[(x['train_loss'], x['loss']) for x in runs['cpu']]}"
        f", largest difference {max(diffs):.2e} (atol {LM_CPU_ATOL}); wall "
        f"{walls['cuda']:.2f} s on the card, {walls['cpu']:.2f} s on "
        f"{torch.get_num_threads()} CPU threads [{card}]")
    return max(diffs)


def profile_lm_steps(card, train_manifest, n=8):
    """n steps of a fresh LMTrainStep at the published width on one
    train batch of 64 under torch.profiler (after 3 unprofiled), with its
    largest host ops: what a train_lm step costs."""
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.train.optim import NoamAdam
    from tpu_asr_torch.train_lm import LMTrainStep, make_batches
    from tpu_asr_torch.weights import init_random
    cfg = LMConfig(vocab_size=4233)
    lm = init_random(TransformerLM(cfg), SEED)
    step = LMTrainStep(lm, NoamAdam(lm.parameters(), cfg.d_model, 1000,
                                    0.5, 5.0), device=DEVICE, seed=SEED)
    seqs = [u.tokens for u in load_manifest(train_manifest)]
    ys_in, tgt = make_batches(seqs, 64, max(map(len, seqs)),
                              cfg.vocab_size - 2, cfg.vocab_size - 1)[0]

    def run(k):
        for _ in range(k):
            step(ys_in, tgt)
        torch.cuda.synchronize()
    run(3)
    return profile_device(lambda: run(n), f"train_lm {n} steps", card,
                          host_top=12)


def train_lm_on_card(card, workdir, train_manifest, cv_manifest):
    """python -m tpu_asr_torch.train_lm at the LM's published width
    (LMConfig defaults: d256, d_inner 1024, h4, 4 layers, vocab 4233,
    float32), batch 64, on the card (its default device); the same run
    with dropout 0 on the card and the CPU (check_lm_on_cpu); a profile of
    its steps. -> the LM folder."""
    import math
    from tpu_asr_torch import train_lm
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.models.lm import LMConfig, load_lm_config

    argv = ["--train-manifest", train_manifest, "--cv-manifest",
            cv_manifest, "--vocab-size", "4233", "--batch-size", "64"]
    lm_dir = os.path.join(workdir, "lm")
    events = []

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with wrap_method(train_lm.LMTrainStep, "__call__", before=record,
                     after=lambda _: record()):
        train_lm.main(argv + ["--epochs", str(LM_EPOCHS), "--save-folder",
                              lm_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg = load_lm_config(lm_dir)
    if cfg != LMConfig(vocab_size=4233):
        raise AssertionError(f"train_lm wrote {cfg}, not the published "
                             f"width")
    lines = lm_losses(lm_dir)
    cv = [x["loss"] for x in lines]
    floor = lm_cv_floor([u.tokens for u in load_manifest(cv_manifest)],
                        cfg.vocab_size - 4)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[::2], events[1::2])]
    losses = [x[k] for x in lines for k in ("loss", "train_loss")]
    if len(step_ms) < MIN_TRAIN_STEPS or not np.isfinite(losses).all() or \
            not lines[-1]["train_loss"] < lines[0]["train_loss"] or \
            not min(cv) < cv[0] or not min(cv) > floor - LM_FLOOR_MARGIN:
        raise AssertionError(f"train_lm: {len(step_ms)} steps, cv lines "
                             f"{lines}; want >= {MIN_TRAIN_STEPS} steps, "
                             f"finite losses, the train loss falling, the "
                             f"best cv loss below the first and above the "
                             f"corpus floor {floor:.4f} less "
                             f"{LM_FLOOR_MARGIN}")
    log(f"train_lm: LM (d{cfg.d_model}, d_inner {cfg.d_inner}, "
        f"h{cfg.num_heads}, {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}) {len(step_ms)} steps of batch 64 "
        f"in {wall:.2f} s (cv included); step ms median "
        f"{statistics.median(step_ms):.2f}, min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}; peak memory {peak / 2**30:.2f} GiB [{card}]; "
        f"cv loss by epoch {cv} (ln 4233 = {math.log(4233):.4f}, corpus "
        f"floor {floor:.4f}: best {min(cv):.4f} at epoch "
        f"{cv.index(min(cv))}), train loss "
        f"{[x['train_loss'] for x in lines]}")
    check_lm_on_cpu(card, workdir, argv)
    profile_lm_steps(card, train_manifest)
    return lm_dir


def run_lm_decodes(card, workdir, ckpts, lm_dir, cv_manifest, n_cv):
    """python -m tpu_asr_torch.recognize with the LM in each of
    LM_DECODES, then python -m tpu_asr_torch.score on the joint output;
    then the kernels that ran on these paths against their plain versions
    on the inputs the paths gave them (ctc_prefix_scan on the LM-fused
    joint path, the flash and LN forwards on LM-rescored attn_rescore;
    see PathLabels), timed. -> ({decode name: {kernel: launches}}, their
    counts from 0 just before each decode, read just after; {"prefix",
    "flash", "ln": {label: timings, shape and max abs error}}; errors)."""
    from tpu_asr_torch import recognize, score
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln

    counters = kernel_counters()
    out = {}
    caps = {"prefix": {}, "flash": {}, "ln": {}}
    for name, ckpt, flags in LM_DECODES:
        hyp = os.path.join(workdir, f"hyp_{name}.jsonl")
        calls = {"flash_attention_fwd": 0, "layer_norm_residual_fwd": 0,
                 "decoder_passes": 0}
        beam_steps = [0]          # LM-fused joint steps
        labels = PathLabels(LM_PATHS[name])
        # main path: counts from 0 just before, read just after
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with count_full_passes(calls), count_beam_steps(beam_steps), \
                record_prefix_inputs(caps["prefix"], labels), \
                record_inputs(fa, "flash_attention_fwd", caps["flash"],
                              labels.flash), \
                record_inputs(ln, "layer_norm_residual_fwd", caps["ln"],
                              labels.ln):
            summary, printed = run_cli(recognize.main, [
                "--ckpt", ckpts[ckpt], "--manifest", cv_manifest,
                "--lm-ckpt", lm_dir, "--output", hyp] + flags)
        wall = time.perf_counter() - t0
        launches = {k: counters[k].launches for k in PATH_KERNELS}
        hyps = [json.loads(x) for x in open(hyp)]
        if printed != summary or summary["n_utts"] != n_cv or \
                len(hyps) != n_cv or "cer" not in summary:
            raise AssertionError(f"recognize {name}: summary {summary}, "
                                 f"printed {printed}, {len(hyps)} "
                                 f"hypotheses for {n_cv} utterances")
        want = {"ctc_prefix_scan": beam_steps[0]} if name == "joint" \
            else {}
        if name == "attn_rescore":
            want = {k: calls[k] for k in PATH_KERNELS[1:]}
        check_launches(f"recognize {name}", {k: v for k, v in
                                             launches.items() if v}, want)
        per_batch = ({k: v / calls["decoder_passes"] for k, v in
                      want.items()} if calls["decoder_passes"] else {})
        log(f"recognize {name} with the LM: {json.dumps(summary)}; "
            f"{wall:.2f} s with model load and warm-up; kernel launches "
            f"{json.dumps(launches)} for {beam_steps[0]} LM-fused joint "
            f"steps and {calls['decoder_passes']} decoder passes (per "
            f"pass {json.dumps(per_batch)}) [{card}]")
        out[name] = (launches, summary)
    joint_hyp = os.path.join(workdir, "hyp_joint.jsonl")
    scored, printed = run_cli(score.main, ["--manifest", cv_manifest,
                                           "--hyp", joint_hyp])
    if printed != scored or scored["cer"] != out["joint"][1]["cer"] or \
            scored["n_utts"] != n_cv:
        raise AssertionError(f"score {scored} disagrees with recognize "
                             f"{out['joint'][1]}")
    log(f"score: {json.dumps(scored)} == recognize joint's cer")
    paths, errs = {}, {}
    paths["prefix"], errs["prefix"] = check_prefix_on_paths(caps["prefix"])
    paths["flash"], paths["ln"], fl_errs = check_flash_ln_on_paths(
        caps["flash"], caps["ln"], LM_PATHS["attn_rescore"])
    errs.update(fl_errs)
    if not all(paths.values()):
        raise AssertionError(f"the LM paths recorded "
                             f"{ {k: len(v) for k, v in paths.items()} } "
                             f"prefix, flash and LN calls")
    log(f"ctc_prefix_scan vs plain on {LM_PATHS['joint']}'s inputs: "
        f"{len(paths['prefix'])} calls agree, max abs err "
        f"{errs['prefix']}")
    return ({name: launches for name, (launches, _) in out.items()}, paths,
            errs)


def time_lm_fusion(card, ckpt, lm_dir, utts, waves):
    """The joint beam 5 (max_len 40, LM weight 0.3) and ctc_beam 10 (LM
    weight 0.1) of the aishell checkpoint on one batch of 8 cv utterances
    padded to 1000 frames, without and with the LM: wall ms (median of 3
    after a warm-up) and the decode steps; for the joint beam also,
    under torch.profiler, device ms, device events and the host's self
    CPU ms (ctc_beam's traces hold 27000-56000 events, which the
    profiler takes about half a ms each to read). A reading, not a
    gate."""
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.lm import load_lm
    from tpu_asr_torch.train.checkpoints import Checkpointer

    ck = Checkpointer(ckpt)
    cfg = ck.load_config()
    batch_wav = np.zeros((BATCH, BUCKETS[-1] * 160), np.float32)
    lens = np.zeros(BATCH, np.int32)
    for i, u in enumerate(utts[:BATCH]):
        w = waves[u.id][: BUCKETS[-1] * 160]
        batch_wav[i, :len(w)] = w
        lens[i] = len(w)
    batch = {"wav": batch_wav, "wav_lengths": lens}
    readings = {}
    for key, mode, beam, weight in (
            ("joint 5 without LM", "joint", 5, 0.0),
            ("joint 5 with LM", "joint", 5, 0.3),
            ("ctc_beam 10 without LM", "ctc_beam", 10, 0.0),
            ("ctc_beam 10 with LM", "ctc_beam", 10, 0.1)):
        model = build_model(cfg)
        model.load_state_dict(ck.restore(ck.best_step())["model"])
        lm = load_lm(lm_dir)
        rec = Recognizer(cfg, model, mode=mode, device=DEVICE,
                         lm_cfg=lm.cfg, lm=lm,
                         beam=BeamConfig(beam=beam, max_len=40,
                                         ctc_weight=0.3, lm_weight=weight))
        rec.decode_batch_nbest(batch)
        rec.decode_steps = 0
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            rec.decode_batch_nbest(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
        steps = rec.decode_steps // 3
        prof = profile_device(lambda: rec.decode_batch_nbest(batch), key,
                              card, host_top=10) if mode == "joint" else {}
        readings[key] = dict(prof, wall_ms_median=statistics.median(walls),
                             steps=steps)
    log("LM fusion cost on 8 cv utterances (a reading): "
        + json.dumps(readings) + f" [{card}]")
    return readings


def run_lm_serving(card, ckpt, lm_dir, workdir, wav, want_tokens=None):
    """python -m tpu_asr_torch.serve's build_server with --dict (a
    4233-line dict) and --lm-ckpt on the aishell checkpoint; one POST
    /recognize must answer with a non-null text."""
    from tpu_asr_torch.serve import build_server, load_char_list, parse_args
    from tpu_asr_torch.utils.vocab import Vocab

    dict_path = os.path.join(workdir, "dict.txt")
    Vocab.build(chr(0x4E00 + i) for i in range(4229)).save(dict_path)
    args = parse_args(["--ckpt", ckpt, "--mode", "joint", "--beam", "5",
                       "--max-len", "40", "--lm-ckpt", lm_dir,
                       "--lm-weight", "0.3", "--dict", dict_path,
                       "--bucket-frames", ",".join(map(str, BUCKETS)),
                       "--batch-size", str(BATCH), "--restore", "latest"])
    server = build_server(args)
    server.warmup(kinds=("wav",))
    server.start()
    chars = load_char_list(args)
    try:
        status, body = post_recognize(server, wav, chars)
    finally:
        server.stop()
    if status != 200 or body.get("text") is None or \
            body["text"] != "".join(chars[i] for i in body["tokens"]):
        raise AssertionError(f"/recognize with --dict --lm-ckpt answered "
                             f"{status}: {body}")
    log(f"http with --dict --lm-ckpt: POST /recognize -> 200, "
        f"{len(body['tokens'])} tokens, text {body['text'][:16]!r}...")


def run_lm_phase(card, workdir, data, ckpts):
    """Phase 10: train_lm, three LM decodes through recognize and their
    score, the cost of fusion in the joint beam, and the server with
    --dict --lm-ckpt. -> (what run_lm_decodes returns, the LM folder,
    the cv wav manifest)."""
    from tpu_asr_torch.data import save_manifest
    train_utts, cv_utts, _, waves = data
    train_manifest = os.path.join(workdir, "lm_train.jsonl")
    save_manifest(train_utts, train_manifest)
    cv_manifest = write_wav_manifest(cv_utts, waves,
                                     os.path.join(workdir, "cv"))
    lm_dir = train_lm_on_card(card, workdir, train_manifest, cv_manifest)
    decodes = run_lm_decodes(card, workdir, ckpts, lm_dir, cv_manifest,
                             len(cv_utts))
    time_lm_fusion(card, ckpts["aishell"], lm_dir, cv_utts, waves)
    run_lm_serving(card, ckpts["aishell"], lm_dir, workdir,
                   waves[cv_utts[0].id])
    return decodes, lm_dir, cv_manifest


# ---- phase 11: the conformer recipe through the CLIs ----

# stage 0 of egs/aishell/run.sh for phase 8's corpus: token t is the
# character U+4E00 + t in the Kaldi text, its waves 16-bit PCM at this gain
RECIPE_CHAR0 = 0x4E00
RECIPE_GAIN = 0.5             # the tones peak near 1.3; PCM holds [-1, 1)
# the card's frontend against the CPU's: both run the same port code; on
# these 16-bit waves they differ by 4.8e-6 in mean and 7.9e-6 relative in
# istd (an H100), so the limit is 5e-5: room of 6x and more
CMVN_CHECK_UTTS = 64          # the card's stats against the CPU's on these
CMVN_MEAN_ATOL, CMVN_ISTD_RTOL = 5e-5, 5e-5
RECIPE_DECODES = (            # (name, recognize flags)
    ("attn_rescore", ["--mode", "attn_rescore", "--beam", "10"]),
    ("joint", ["--mode", "joint", "--beam", "5", "--max-len", "40"]))
RECIPE_PATH = "conformer joint (recognize)"


def write_kaldi_split(data_dir, split, utts, waves) -> tuple[str, str]:
    """`utts` as a Kaldi split, as the recipe's stage 0 writes AISHELL's:
    each wave a 16 kHz 16-bit mono .wav (RECIPE_GAIN, clipped), the
    wav.scp and the text (token t as chr(RECIPE_CHAR0 + t)).
    -> (wav.scp path, text path)."""
    import wave
    wav_dir = os.path.join(data_dir, "wav", split)
    os.makedirs(wav_dir, exist_ok=True)
    scp, text = [], []
    for u in utts:
        path = os.path.join(wav_dir, f"{u.id}.wav")
        pcm = np.clip(np.round(waves[u.id] * RECIPE_GAIN * 32768.0),
                      -32768, 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        scp.append(f"{u.id} {path}")
        text.append(f"{u.id} " + "".join(chr(RECIPE_CHAR0 + t)
                                         for t in u.tokens))
    paths = (os.path.join(data_dir, f"{split}.wav.scp"),
             os.path.join(data_dir, f"{split}.text"))
    for path, lines in zip(paths, (scp, text)):
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return paths


def prepare_recipe_data(workdir, data) -> tuple[str, str, str, list]:
    """Stages 0 and 1 of egs/aishell/run.sh on phase 8's corpus (`data`,
    synthetic_aishell's): write_kaldi_split for train and dev, then
    python -m tpu_asr_torch.prepare_data on each as run.sh runs it
    (--dict-out on train, --dict on dev). Every train transcript must
    come back through the dict as its tokens' characters, every dev one
    likewise or as <unk>. -> (train manifest, dev manifest, dict, dev
    utterances)."""
    from tpu_asr_torch import prepare_data
    from tpu_asr_torch.utils.vocab import Vocab
    train, cv, _, waves = data
    out = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    dict_path = os.path.join(out, "dict.txt")
    manifests, got = {}, {}
    for split, utts, dict_flag in (("train", train, "--dict-out"),
                                   ("dev", cv, "--dict")):
        scp, text = write_kaldi_split(out, split, utts, waves)
        manifests[split] = os.path.join(out, f"{split}.jsonl")
        got[split] = prepare_data.main([
            "--wav-scp", scp, "--text", text, dict_flag, dict_path,
            "--out", manifests[split]])
    vocab = Vocab.load(dict_path)
    for split, utts in (("train", train), ("dev", cv)):
        for u, g in zip(utts, got[split]):
            want = [chr(RECIPE_CHAR0 + t) for t in u.tokens]
            back = [vocab.tokens[i] for i in g.tokens]
            if g.id != u.id or g.num_samples != len(waves[u.id]) or any(
                    b != w and (split == "train" or b != "<unk>")
                    for b, w in zip(back, want)) or len(back) != len(want):
                raise AssertionError(f"prepare_data {split}: {g} from "
                                     f"{u.id} ({len(waves[u.id])} samples,"
                                     f" tokens {u.tokens})")
        if len(got[split]) != len(utts):
            raise AssertionError(f"prepare_data {split}: "
                                 f"{len(got[split])} of {len(utts)} "
                                 f"utterances")
    unk = sum(vocab.tokens[i] == "<unk>" for g in got["dev"]
              for i in g.tokens)
    log(f"prepare_data (wav.scp + text, as egs/aishell/run.sh): "
        f"{len(train)} train + {len(cv)} dev utterances, dict of "
        f"{len(vocab)} tokens from the train text, {unk} dev tokens <unk>,"
        f" in {time.perf_counter() - t0:.1f} s")
    return manifests["train"], manifests["dev"], dict_path, got["dev"]


def recipe_cmvn(card, workdir, train_manifest) -> str:
    """python -m tpu_asr_torch.compute_cmvn on the train manifest (the
    card's frontend); the card's stats over the first CMVN_CHECK_UTTS
    utterances against the CPU frontend's: frames equal, mean and istd
    within CMVN_MEAN_ATOL and CMVN_ISTD_RTOL. -> the stats path."""
    from tpu_asr_torch import compute_cmvn
    stats = os.path.join(workdir, "cmvn.npz")
    t0 = time.perf_counter()
    full = compute_cmvn.main(["--manifest", train_manifest, "--out", stats])
    wall = time.perf_counter() - t0
    few = {dev: compute_cmvn.main([
        "--manifest", train_manifest, "--limit", str(CMVN_CHECK_UTTS),
        "--out", os.path.join(workdir, f"cmvn_{dev}.npz"), "--device", dev])
        for dev in (DEVICE, "cpu")}
    card_s, cpu_s = few[DEVICE], few["cpu"]
    mean_gap = float(np.abs(card_s["mean"] - cpu_s["mean"]).max())
    istd_gap = float(np.abs(card_s["istd"] / cpu_s["istd"] - 1.0).max())
    if card_s["frames"] != cpu_s["frames"] or not (
            mean_gap <= CMVN_MEAN_ATOL and istd_gap <= CMVN_ISTD_RTOL):
        raise AssertionError(f"compute_cmvn on the card and on the CPU "
                             f"differ: frames {card_s['frames']} vs "
                             f"{cpu_s['frames']}, mean {mean_gap}, istd "
                             f"{istd_gap} relative")
    if not (np.isfinite(full["mean"]).all() and np.isfinite(
            full["istd"]).all() and full["frames"] > 0):
        raise AssertionError(f"compute_cmvn wrote {full}")
    log(f"compute_cmvn: {int(full['frames'])} frames in {wall:.2f} s "
        f"[{card}]; the first {CMVN_CHECK_UTTS} utterances on the card == "
        f"on the CPU ({int(cpu_s['frames'])} frames, mean within "
        f"{mean_gap:.2e} (atol {CMVN_MEAN_ATOL}), istd within {istd_gap:.2e}"
        f" relative (rtol {CMVN_ISTD_RTOL}))")
    return stats


def run_recipe_decodes(card, ckpt, cv_manifest, n_cv, workdir,
                       decodes=RECIPE_DECODES, path=RECIPE_PATH,
                       what="conformer"):
    """python -m tpu_asr_torch.recognize --ckpt on the cv manifest in
    each of `decodes` (name, flags): a hypothesis per utterance and a
    summary with cer each; ctc_prefix_scan launches once per joint step
    (a decoder step) and nothing launches in the other modes. The first
    joint decode's first and later prefix-scan call of each T' are kept
    (PathLabels(path)). -> ({decode name: summary}, prefix launches, the
    kept calls)."""
    from tpu_asr_torch import recognize

    counters = kernel_counters()
    summaries, caps, prefix_launches = {}, {}, 0
    for name, flags in decodes:
        hyp = os.path.join(workdir, f"hyp_{name}.jsonl")
        joint = flags[flags.index("--mode") + 1] == "joint"
        steps = [0]
        records = contextlib.ExitStack()
        if joint:
            records.enter_context(record_prefix_inputs(
                caps, PathLabels(path)))
        # main path: counts from 0 just before, read just after
        for fn in counters.values():
            fn.launches = 0
        with records, count_beam_steps(steps):
            summary, printed = run_cli(recognize.main, [
                "--ckpt", ckpt, "--manifest", cv_manifest, "--output",
                hyp] + flags)
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        with open(hyp) as f:
            hyps = [json.loads(x) for x in f]
        if printed != summary or summary["n_utts"] != n_cv or \
                len(hyps) != n_cv or "cer" not in summary or \
                not all("hyp_tokens" in h for h in hyps):
            raise AssertionError(f"recognize {name}: summary {summary}, "
                                 f"{len(hyps)} hypotheses for {n_cv} "
                                 f"utterances")
        want = {"ctc_prefix_scan": steps[0]} if joint else {}
        check_launches(f"recognize {name} ({what})", launches, want)
        prefix_launches += launches.get("ctc_prefix_scan", 0)
        log(f"recognize {name} ({what} checkpoint): "
            f"{json.dumps(summary)}; kernel launches {json.dumps(launches)} "
            f"for {steps[0]} decoder steps [{card}]")
        summaries[name] = summary
    return summaries, prefix_launches, caps


def run_recipe_serving(card, ckpt, stats_path, wav):
    """python -m tpu_asr_torch.serve's build_server with --ckpt
    --restore latest (the model type's mode: joint); one POST
    /recognize must answer with the tokens that submit() gives for the
    same wav. The server must hold the stats file's mean and istd, and
    the latest checkpoint's weights (cast as the Recognizer casts)."""
    from tpu_asr_torch.serve import build_server, parse_args
    from tpu_asr_torch.train.checkpoints import Checkpointer
    server = build_server(parse_args([
        "--ckpt", ckpt, "--restore", "latest", "--bucket-frames",
        ",".join(map(str, BUCKETS)), "--batch-size", str(BATCH)]))
    ck = Checkpointer(ckpt)
    saved = ck.restore(ck.latest_step())["model"]
    served = server.rec.model.state_dict()
    stale = [k for k, v in served.items() if not torch.equal(
        saved[k].to(device=v.device, dtype=v.dtype), v)]
    with np.load(stats_path) as z:
        want_stats = (z["mean"], z["istd"])
    got_stats = server.rec.cmvn_stats
    if set(saved) != set(served) or stale or got_stats is None or not all(
            np.array_equal(g.cpu().numpy(), w)
            for g, w in zip(got_stats, want_stats)):
        raise AssertionError(f"serve --ckpt --restore latest (conformer): "
                             f"weights not the latest step's {stale[:4]}, "
                             f"or CMVN stats {got_stats} not {stats_path}'s")
    server.warmup(kinds=("wav",))
    server.start()
    try:
        status, body = post_recognize(server, wav)
        want = server.submit("wav", wav, timeout=600.0)
    finally:
        server.stop()
    if status != 200 or "tokens" not in body or \
            server.frontend.cmvn_mode != "global" or \
            body["tokens"] != want[0]["yseq"]:
        raise AssertionError(f"serve --ckpt (conformer): /recognize "
                             f"answered {status}: {body}, submit() "
                             f"{want[0]['yseq']}; frontend "
                             f"{server.frontend}")
    log(f"serve --ckpt --restore latest (conformer, {server.rec.mode}, "
        f"global CMVN, step {ck.latest_step()}'s weights, the stats "
        f"file's mean and istd): POST /recognize -> 200, "
        f"{len(body['tokens'])} tokens, == submit()")


def run_recipe_phase(card, workdir, data, aishell_stats):
    """Phase 11: the aishell recipe with the conformer preset through the
    port's CLIs, on phase 8's corpus (`data`) written as Kaldi splits:
    prepare_data, compute_cmvn, the trainer with --cmvn global and the
    recipe's dict (run_training: the Solver that python -m
    tpu_asr_torch.train builds from these flags; --vocab-size 4233 keeps
    the preset's output width, since 461 train transcripts do not hold
    every token), recognize in attn_rescore and joint, serve;
    then the CTC pair and the prefix scan on the inputs this path gave
    them against their plain versions. -> (training launches, joint
    prefix-scan launches, {"prefix", "ctc": path timings}, errors)."""
    from tpu_asr_torch.data.audio import read_wav
    from tpu_asr_torch.train.checkpoints import Checkpointer
    train_m, cv_m, dict_path, cv = prepare_recipe_data(workdir, data)
    stats_path = recipe_cmvn(card, workdir, train_m)
    ckpt = os.path.join(workdir, "conformer")
    ctc_caps, stats = {}, {}
    launches = run_training(card, ckpt, "conformer", None, {}, None, None,
                            ctc_caps, argv=[
                                "--train-manifest", train_m,
                                "--cv-manifest", cv_m, "--dict",
                                dict_path, "--vocab-size", "4233",
                                "--cmvn", "global", "--cmvn-stats",
                                stats_path], stats=stats)
    frontend = Checkpointer(ckpt).load_frontend()
    train_loss = [h["train_loss"] for h in stats["history"]]
    if frontend is None or frontend.cmvn_mode != "global" or \
            frontend.cmvn_stats_path != os.path.abspath(stats_path) or \
            not train_loss[-1] < train_loss[0]:
        raise AssertionError(f"conformer training: frontend.json {frontend},"
                             f" train loss by epoch {train_loss}")
    keys = ("step_ms_median", "steps_per_s", "audio_s_per_s", "peak_gib",
            "device_ms_per_step", "busy_share", "device_events_per_step",
            "fixed_step_ms_median")
    log("conformer training beside aishell (phase 8), same corpus shape: "
        + json.dumps({"conformer": {k: stats[k] for k in keys},
                      "aishell": {k: aishell_stats[k] for k in keys}})
        + f"; conformer train loss by epoch {train_loss}, frontend.json "
        f"cmvn_mode {frontend.cmvn_mode} [{card}]")
    summaries, prefix_launches, prefix_caps = run_recipe_decodes(
        card, ckpt, cv_m, len(cv), workdir)
    log("conformer recognize inverse RTF: " + json.dumps(
        {k: v["inverse_rtf"] for k, v in summaries.items()}) + f" [{card}]")
    run_recipe_serving(card, ckpt, stats_path, read_wav(cv[0].wav))
    paths, errs = {}, {}
    paths["prefix"], errs["prefix"] = check_prefix_on_paths(prefix_caps)
    paths["ctc"], pair_errs, bitwise = check_ctc_pair_on_paths(ctc_caps)
    errs.update(pair_errs)
    if not paths["prefix"] or len(paths["ctc"]) != 1:
        raise AssertionError(f"the conformer path recorded "
                             f"{len(paths['prefix'])} prefix scans and "
                             f"{len(paths['ctc'])} CTC backwards")
    log(f"ctc_prefix_scan, ctc_loss_fwd and ctc_loss_bwd vs plain on the "
        f"conformer path's inputs: {len(paths['prefix'])} + 1 + 1 calls "
        f"agree (the forward's bits the plain version's: {bitwise}): "
        + json.dumps(errs))
    return launches, prefix_launches, paths, errs


# ---- phase 12: the transducer family ----

TRANSDUCER_DECODES = (        # (name, recognize flags; "LM": phase 10's)
    ("transducer_greedy", ["--mode", "transducer_greedy"]),
    ("transducer_beam", ["--mode", "transducer_beam", "--beam", "5"]),
    ("transducer_beam_lm", ["--mode", "transducer_beam", "--beam", "5",
                            "--lm-ckpt", "LM", "--lm-weight", "0.3"]),
    ("transducer_rescore", ["--mode", "transducer_rescore", "--beam", "10",
                            "--ctc-weight", "0.5"]))
TRANSDUCER_DECODE_UTTS = 26   # phase 10's first cv utterances decoded
#                               (26 of the 51)
CONFORMER_TRANSDUCER_STEPS = 4
LATTICE_CHUNK_FRAMES = 32     # frames a no-grad chunk of the log-probs


def transducer_loss_label(*_, **__):
    """record_inputs' label for models.transducer.transducer_loss: one
    label for the train steps (autograd on), so the first is kept; none
    for a cv batch."""
    return "transducer training" if torch.is_grad_enabled() else None


def time_transducer_lattice(card, args, step_device_ms):
    """The transducer loss on the first train batch's inputs, as the
    model gave them to transducer_loss (f, g, w_out, b_out, labels,
    lengths): forward and backward of the whole loss (the chunked,
    checkpointed joint and the lattice recursion) and of the recursion
    alone on the same log-probs, each timed by CUDA events; the
    recursion also under torch.profiler (device time, events), and its
    share of a train step's device time (the whole loss is not traced:
    the profiler takes about half a ms to read each of its ~35000
    events);
    the peak memory of the loss with the checkpointed joint against the
    joint's logits materialized for all frames (what the checkpoint
    saves). -> the numbers."""
    from tpu_asr_torch.ops.transducer import (joint_log_probs,
                                              transducer_forward,
                                              transducer_loss,
                                              transducer_loss_from_logits)
    f, g, w, b, labels, ll, ul = args[:7]
    params = (f, g, w, b)

    def loss_fwd_bwd():
        xs = [x.detach().requires_grad_(True) for x in params]
        nll = transducer_loss(*xs, labels, ll, ul, reduction="none")
        torch.autograd.grad(nll.sum(), xs)

    with torch.no_grad():
        parts = [joint_log_probs(f[:, s: s + LATTICE_CHUNK_FRAMES], g, w, b,
                                 labels)
                 for s in range(0, f.shape[1], LATTICE_CHUNK_FRAMES)]
        blank = torch.cat([p[0] for p in parts], 1)
        emit = torch.cat([p[1] for p in parts], 1)

    def lattice_fwd_bwd():
        xs = [x.detach().requires_grad_(True) for x in (blank, emit)]
        torch.autograd.grad(transducer_forward(*xs, ll, ul).sum(), xs)

    def materialized_fwd_bwd():
        xs = [x.detach().requires_grad_(True) for x in params]
        joint = torch.tanh(xs[0][:, :, None, :] + xs[1][:, None])
        nll = transducer_loss_from_logits(joint @ xs[2] + xs[3], labels, ll,
                                          ul)
        torch.autograd.grad(nll.sum(), xs)

    out = {"shape": f"B={f.shape[0]} T'={f.shape[1]} U+1={g.shape[1]} "
                    f"V={w.shape[1]} d_joint={w.shape[0]}"}
    for key, fn in (("loss", loss_fwd_bwd), ("lattice", lattice_fwd_bwd),
                    ("materialized", materialized_fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[f"{key}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                  - base) / 2**30
        if key != "materialized":
            out[f"{key}_ms"] = cuda_ms(fn, reps=3, warmup=0)
        if key == "lattice":
            prof = profile_device(fn, f"transducer {key} fwd+bwd "
                                  f"({out['shape']})", card)
            out[f"{key}_device_ms"] = prof["device_ms"]
            out[f"{key}_device_events"] = prof["device_events"]
            out[f"{key}_share_of_step"] = prof["device_ms"] / step_device_ms
    log("transducer loss on the first train batch's inputs (joint + "
        "lattice, and the lattice recursion alone), forward and backward; "
        "peak memory above the inputs with the checkpointed joint against "
        "all frames' logits materialized: " + json.dumps(out)
        + f" [{card}]")
    return out


def run_transducer_decodes(card, ckpt, lm_dir, cv_manifest, cv_utts,
                           workdir):
    """python -m tpu_asr_torch.recognize --ckpt on the cv manifest in
    each of TRANSDUCER_DECODES: a hypothesis per utterance and a summary
    with cer and inverse RTF each; no kernel launches on these paths (the
    transducer lattice and the CTC prefix beam have none); greedy's times
    non-decreasing and below each utterance's encoder length. -> {name:
    summary}."""
    from tpu_asr_torch import recognize
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.train.checkpoints import Checkpointer

    cfg = Checkpointer(ckpt).load_config()
    frontend = FrontendConfig()
    enc_len = {u.id: cfg.subsampled_length(frontend.num_frames(
        u.num_samples)) for u in cv_utts}
    counters = kernel_counters()
    summaries = {}
    for name, flags in TRANSDUCER_DECODES:
        hyp = os.path.join(workdir, f"hyp_{name}.jsonl")
        flags = [lm_dir if x == "LM" else x for x in flags]
        # main path: counts from 0 just before, read just after
        for fn in counters.values():
            fn.launches = 0
        summary, printed = run_cli(recognize.main, [
            "--ckpt", ckpt, "--manifest", cv_manifest, "--output",
            hyp] + flags)
        launches = {k: f.launches for k, f in counters.items() if f.launches}
        with open(hyp) as f:
            hyps = [json.loads(x) for x in f]
        if printed != summary or summary["n_utts"] != len(cv_utts) or \
                len(hyps) != len(cv_utts) or "cer" not in summary or \
                "inverse_rtf" not in summary or \
                not all("hyp_tokens" in h for h in hyps):
            raise AssertionError(f"recognize {name}: summary {summary}, "
                                 f"{len(hyps)} hypotheses for "
                                 f"{len(cv_utts)} utterances")
        check_launches(f"recognize {name}", launches, {})
        if name == "transducer_greedy":
            bad = [h["id"] for h in hyps
                   if len(h["times"]) != len(h["hyp_tokens"])
                   or h["times"] != sorted(h["times"])
                   or any(not 0 <= x < enc_len[h["id"]] for x in h["times"])]
            if bad:
                raise AssertionError(f"greedy times out of order or past "
                                     f"the encoder length: {bad[:4]}")
        n_tokens = sum(len(h["hyp_tokens"]) for h in hyps)
        log(f"recognize {name} (transducer checkpoint): "
            f"{json.dumps(summary)}; {n_tokens} tokens in all [{card}]")
        summaries[name] = summary
    return summaries


def run_ckpt_serving(card, ckpt, wav, what, mode):
    """python -m tpu_asr_torch.serve's build_server with --ckpt
    --restore latest (the model type's mode, which must be `mode`); one
    POST /recognize must answer with the tokens that submit() gives."""
    from tpu_asr_torch.serve import build_server, parse_args
    server = build_server(parse_args([
        "--ckpt", ckpt, "--restore", "latest", "--bucket-frames",
        ",".join(map(str, BUCKETS)), "--batch-size", str(BATCH)]))
    server.warmup(kinds=("wav",))
    server.start()
    try:
        status, body = post_recognize(server, wav)
        want = server.submit("wav", wav, timeout=600.0)
    finally:
        server.stop()
    if status != 200 or server.rec.mode != mode or \
            body.get("tokens") != want[0]["yseq"]:
        raise AssertionError(f"serve --ckpt ({what}, "
                             f"{server.rec.mode}): /recognize answered "
                             f"{status}: {body}, submit() {want[0]}")
    log(f"serve --ckpt --restore latest ({what}, {server.rec.mode}): "
        f"POST /recognize -> 200, {len(body['tokens'])} tokens, == "
        f"submit()")


def run_conformer_transducer(card, workdir, data):
    """The full-width conformer_transducer preset (chunk 16) from the
    Solver that `python -m tpu_asr_torch.train --preset
    conformer_transducer` builds: CONFORMER_TRANSDUCER_STEPS train steps
    on its first batches (losses and grad norms finite, the CTC kernels
    once a step) and one greedy decode of a cv batch (a hypothesis per
    row, its times non-decreasing and below the row's encoder length).
    -> kernel launches of the steps."""
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.train.__main__ import build_solver, parse_args

    solver = build_solver(parse_args([
        "--preset", "conformer_transducer", "--save-folder",
        os.path.join(workdir, "conformer_transducer")]), data)
    ts = solver.train_step
    cfg = ts.model.cfg
    it = iter(solver.train_loader)
    batches = [next(it) for _ in range(CONFORMER_TRANSDUCER_STEPS)]
    it.close()
    counters = kernel_counters()
    # main path: counts from 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = [ts(b) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    keys = ("loss", "loss_rnnt", "loss_ctc", "grad_norm")
    got = torch.stack([torch.stack([m[k].float() for k in keys])
                       for m in metrics]).cpu()
    steps = CONFORMER_TRANSDUCER_STEPS
    check_launches("conformer_transducer training", launches,
                   {"ctc_loss_fwd": steps, "ctc_loss_bwd": steps})
    if not torch.isfinite(got).all():
        raise AssertionError(f"conformer_transducer: {keys} {got.tolist()}")
    it = iter(solver.cv_loader)
    cv = next(it)
    it.close()
    rec = Recognizer(cfg, ts.model, mode="transducer_greedy", device=DEVICE,
                     frontend=ts.frontend, beam=BeamConfig(beam=1,
                                                           max_len=100))
    hyps = rec.decode_batch_nbest(cv)
    if len(hyps) != len(cv["wav_lengths"]) or not all(
            len(h) == 1 and "times" in h[0] for h in hyps):
        raise AssertionError(f"conformer_transducer greedy: {len(hyps)} "
                             f"hypotheses for {len(cv['wav_lengths'])} rows")
    # no CPU decode here: only the times' order and range are checked
    check_greedy_times(hyps, hyps, cv["wav_lengths"], cfg,
                       "conformer_transducer")
    log(f"conformer_transducer (d{cfg.d_model}, h{cfg.num_heads}, "
        f"conformer x{cfg.num_enc_layers} chunk {cfg.enc_chunk_size} + "
        f"{cfg.num_pred_layers} predictor layers, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}): {steps} train steps in {wall:.2f} s, "
        + json.dumps({k: got[:, i].tolist() for i, k in enumerate(keys)})
        + f"; launches {json.dumps(launches)}; greedy decode of a cv batch "
        f"of {len(hyps)} rows: "
        f"{[len(h[0]['yseq']) for h in hyps]} tokens [{card}]")
    return launches


def run_transducer_phase(card, workdir, data, aishell_stats, lm_dir,
                         cv_manifest):
    """Phase 12: the transducer preset at full width through the Solver
    that python -m tpu_asr_torch.train --preset transducer builds, on
    phase 8's corpus (run_training: >= 20 steps, the CTC kernels once a
    step on their warp route and once per cv batch, a profile, the fixed
    shape, the checkpoint restore), beside phase 8's aishell numbers, the
    train loss falling; the loss and the lattice alone on the first train
    batch's inputs (time_transducer_lattice); recognize in the four
    TRANSDUCER_DECODES on phase 10's cv manifest (with phase 10's LM),
    serve --ckpt; conformer_transducer; then the CTC pair on the inputs
    the transducer training gave it against the plain versions. ->
    ({"transducer", "conformer_transducer": training launches},
    {"ctc": path timings}, errors)."""
    from tpu_asr_torch.models import transducer as transducer_module
    _, cv_utts, _, waves = data
    ckpt = os.path.join(workdir, "transducer")
    ctc_caps, loss_caps, stats = {}, {}, {}
    wall = {"start": time.perf_counter()}      # seconds by part, logged

    def lap(part):
        wall[part] = time.perf_counter() - wall["start"] - sum(
            v for k, v in wall.items() if k != "start")
    with record_inputs(transducer_module, "transducer_loss", loss_caps,
                       transducer_loss_label):
        # ~51000 device events a step and ~1 s a fixed-shape step on an
        # H100 (PERF.md), and a trace reads at ~0.5 ms an event: one
        # profiled step and 5 at the fixed shape keep the run in time
        launches = run_training(card, ckpt, "transducer", data, {}, None,
                                None, ctc_caps, stats=stats,
                                profiled_steps=1, fixed_steps=5)
    lap("training")
    train_loss = [h["train_loss"] for h in stats["history"]]
    if not train_loss[-1] < train_loss[0] or len(loss_caps) != 1:
        raise AssertionError(f"transducer training: train loss by epoch "
                             f"{train_loss}; {len(loss_caps)} loss inputs "
                             f"kept")
    keys = ("step_ms_median", "steps_per_s", "audio_s_per_s", "peak_gib",
            "device_ms_per_step", "busy_share", "device_events_per_step",
            "fixed_step_ms_median")
    log("transducer training beside aishell (phase 8), same corpus: "
        + json.dumps({"transducer": {k: stats[k] for k in keys},
                      "aishell": {k: aishell_stats[k] for k in keys}})
        + f"; transducer train loss by epoch {train_loss} [{card}]")
    lattice = time_transducer_lattice(card, next(iter(loss_caps.values())),
                                      stats["device_ms_per_step"])
    lap("lattice")
    from tpu_asr_torch.data import load_manifest, save_manifest
    decode_utts = load_manifest(cv_manifest)[:TRANSDUCER_DECODE_UTTS]
    decode_manifest = os.path.join(workdir, "transducer_cv.jsonl")
    save_manifest(decode_utts, decode_manifest)
    summaries = run_transducer_decodes(card, ckpt, lm_dir, decode_manifest,
                                       decode_utts, workdir)
    log("transducer recognize inverse RTF: " + json.dumps(
        {k: v["inverse_rtf"] for k, v in summaries.items()}) + f" [{card}]")
    lap("decodes")
    run_ckpt_serving(card, ckpt, waves[cv_utts[0].id], "transducer",
                     "transducer_greedy")
    lap("serving")
    conformer = run_conformer_transducer(card, workdir, data)
    lap("conformer_transducer")
    paths, errs, bitwise = check_ctc_pair_on_paths(ctc_caps)
    lap("ctc_pair")
    del wall["start"]
    log("phase 12 wall seconds by part: " + json.dumps(wall))
    if len(paths) != 1:
        raise AssertionError(f"the transducer path recorded {len(paths)} "
                             f"CTC backwards")
    log(f"ctc_loss_fwd and ctc_loss_bwd vs plain on the transducer path's "
        f"inputs: 1 + 1 calls agree (the forward's bits the plain "
        f"version's: {bitwise}): " + json.dumps(errs))
    stats["lattice"] = lattice
    return ({"transducer": launches, "conformer_transducer": conformer},
            {"ctc": paths}, errs)


# ---- phase 13: streaming ----

STREAM_PUSH_FRAMES = 64       # feature frames a push (0.64 s)
STREAM_BEAM = 5
STREAM_FRAME_TOL = 1e-4       # encode_chunk against Encoder.forward, float32
STREAM_CONF_TOL = 1e-4
STREAM_SCORE_TOL = 1e-3
STREAM_TIE_MARGIN = 1e-4      # top-2 logit or beam parting margin of a tie
STREAM_RECOMPUTE_UTTS = 8     # utterances the full-recompute oracle streams
STREAM_CV_UTTS = 26           # cv utterances 13b and 13c stream on 13a's
#                               checkpoint (the first 26 of the 51)
STREAM_RANDOM_UTTS = 16       # cv utterances 13b streams on random weights
STREAM_COMPOSE_UTTS = 8       # utterances of the one-search beam check
STREAM_TRANSDUCER_UTTS = 8    # utterances of each transducer comparison
STREAM_SESSIONS = 4           # concurrent HTTP /stream sessions
STREAM_MAX_TOKENS = 100       # the streaming presets' decode max_len


def stream_pushes(rec, feats, step=STREAM_PUSH_FRAMES):
    """Push feats a step at a time, then finish -> (each push's return,
    the final hypothesis, each push's wall seconds)."""
    outs, waits = [], []
    for p in range(0, len(feats), step):
        t0 = time.perf_counter()
        outs.append(rec.push(feats[p:p + step]))
        waits.append(time.perf_counter() - t0)
    return outs, rec.finish(), waits


def latency_summary(seconds) -> dict:
    """Wall latencies in seconds -> {"n", "p50_ms", "max_ms"}."""
    ms = sorted(s * 1e3 for s in seconds)
    return {"n": len(ms), "p50_ms": statistics.median(ms) if ms else None,
            "max_ms": ms[-1] if ms else None}


def top2_margins(logits, streamed_ids) -> list:
    """The frames where the streamed argmax differs from the offline
    logits' [T, V] argmax -> [(frame, offline top-1 - top-2 margin)]."""
    top = torch.topk(logits.float(), 2, dim=-1)
    ids = top.indices[:, 0].cpu().tolist()
    gap = (top.values[:, 0] - top.values[:, 1]).cpu().tolist()
    return [(t, gap[t]) for t, (a, b) in enumerate(zip(ids, streamed_ids))
            if a != b]


def compare_streamed(what, streamed, offline, eos, margins=None) -> dict:
    """streamed {id: (tokens, times or None, confidences or None)} against
    offline {id: n-best hypothesis dict} (eos stripped, as Recognizer
    cleans it): the tokens equal with the stream's eos dropped, the times
    equal, the confidences within STREAM_CONF_TOL. margins(id), when
    given, lists the frames where the streamed decode's decisions part
    from the offline one's with the margin of that decision (greedy: the
    offline top-2 margin, top2_margins; beam: where the two searches
    prune apart, beam_tie): an utterance that differs only at frames whose
    margin is at most STREAM_TIE_MARGIN is a rounding tie, reported and
    not failed; the margins of any other go into the failure's report. ->
    {"n_utts", "n_tokens", "max_conf_gap", "ties": {id: margins}}."""
    bad, ties, conf_gap, n_tokens = [], {}, 0.0, 0
    for uid, (toks, times, confs) in streamed.items():
        want = offline[uid]
        keep = [j for j, t in enumerate(toks) if t != eos]
        got = [toks[j] for j in keep]
        n_tokens += len(got)
        if got != want["yseq"] or (times is not None and [
                times[j] for j in keep] != want["times"]):
            frames = margins(uid) if margins else []
            if frames and all(m <= STREAM_TIE_MARGIN for _, m in frames):
                ties[uid] = frames
            else:
                bad.append(uid)
            continue
        if confs is not None:
            # Both sides round confidences to 4 places, so one step of
            # that rounding differs by 1e-4 plus the subtraction's float
            # error; rounding the gap to 9 places drops only that error.
            gaps = [round(abs(confs[j] - c), 9)
                    for j, c in zip(keep, want["confidence"])]
            conf_gap = max([conf_gap] + gaps)
    if bad or conf_gap > STREAM_CONF_TOL:
        detail = {uid: {"streamed": streamed[uid][0],
                        "offline": offline[uid]["yseq"],
                        "margins": margins(uid) if margins else None}
                  for uid in bad[:3]}
        raise AssertionError(f"{what}: {len(bad)} of {len(streamed)} "
                             f"utterances differ from the offline decode, "
                             f"confidence gap {conf_gap}: "
                             + json.dumps(detail))
    return {"n_utts": len(streamed), "n_tokens": n_tokens,
            "max_conf_gap": conf_gap, "ties": ties}


def stream_features(cfg, frontend, utts):
    """{id: [T, D] features} of the cv utterances, made on the card as
    python -m tpu_asr_torch.stream_demo makes them."""
    from tpu_asr_torch.frontend import cmvn_stats_for
    from tpu_asr_torch.stream_demo import utterance_features
    stats = cmvn_stats_for(frontend, DEVICE)
    return {u.id: utterance_features(u, frontend, DEVICE, stats)
            for u in utts}


def offline_decode(cfg, model, feats, mode, beam):
    """{id: 1-best hypothesis dict} of the port's Recognizer on the card,
    one utterance a batch."""
    from tpu_asr_torch.decode.recognizer import Recognizer
    rec = Recognizer(cfg, model, mode=mode, device=DEVICE, beam=beam)
    return {uid: rec.decode_batch_nbest({
        "feats": x[None], "feat_lengths": np.asarray([len(x)], np.int32)}
        )[0][0] for uid, x in feats.items()}


def beam_states_prefixes(state) -> dict:
    """{prefix tuple: total log score} of a CTC prefix beam state's live
    beams (row 0)."""
    from tpu_asr_torch.decode.ctc_beam import _logaddexp
    prefixes, lens, pb, pnb = (x[0] for x in state[:4])
    totals = _logaddexp(pb, pnb).tolist()
    return {tuple(prefixes[w, :int(lens[w])].tolist()): totals[w]
            for w in range(len(totals)) if totals[w] > -1e29}


def beam_divergence(logp_a, logp_b, n_frames: int, beam: int):
    """Two CTC prefix beams stepped a frame at a time over frame
    log-probs [1, T, V] (the streamed frames' and the full pass's) ->
    None when they hold the same prefixes after every frame, else (the
    first frame where they differ, the margin there): the largest |total
    of a prefix one beam kept - the other beam's weakest survivor|, how
    near the dropped prefix came to surviving."""
    from tpu_asr_torch.decode.ctc_beam import beam_advance, beam_init
    dev = logp_a.device
    states = [beam_init(1, beam, n_frames, device=dev) for _ in range(2)]
    valid = torch.ones((1, 1), dtype=torch.bool, device=dev)
    for t in range(n_frames):
        states = [beam_advance(st, lp[:, t:t + 1], valid)
                  for st, lp in zip(states, (logp_a, logp_b))]
        a, b = (beam_states_prefixes(st) for st in states)
        if set(a) != set(b):
            margin = max((abs((a if p in a else b)[p]
                              - min((b if p in a else a).values()))
                          for p in set(a) ^ set(b)))
            return t, margin
    return None


def chunk_log_probs(model, frames, n: int):
    """CTC log-probs [1, n, V] of the streamed encoder frames (every
    chunk's rows, [k C, D]) as the streaming beam makes them: the head
    a chunk at a time."""
    chunk = model.cfg.enc_chunk_size
    logits = torch.cat([model.ctc_logits(frames[None, i:i + chunk])
                        for i in range(0, len(frames), chunk)], dim=1)
    return torch.log_softmax(logits[:, :n].float(), dim=-1)


def beam_tie(model, x, frames):
    """beam_divergence of the streamed beam search (on the streamed
    encoder frames `frames`) and the offline one (on the full pass over
    the features x [T, D]) -> None, or (frame, margin) where they part."""
    with torch.inference_mode():
        enc, el = model.encode(torch.from_numpy(x[None]).to(DEVICE),
                               torch.tensor([len(x)], device=DEVICE))
        n = int(el[0])
        return beam_divergence(
            chunk_log_probs(model, frames, n),
            torch.log_softmax(model.ctc_logits(enc).float(), dim=-1),
            n, STREAM_BEAM)


def check_beam_scores(name, model, feats, stream_frames, streamed, offline):
    """The streamed beam's 1-best score against the offline ctc_beam's
    ({id: score} each), within STREAM_SCORE_TOL, unless the two searches
    pruned differently at a near-tie: an utterance over the limit is
    stepped again a frame at a time on both sets of frames
    (beam_divergence), and passes only when the beams part at a frame
    where the dropped prefix stood within STREAM_SCORE_TOL of the
    weakest survivor. -> (the largest gap, {id: that tie})."""
    ties, worst = {}, 0.0
    for uid, score in streamed.items():
        gap = abs(score - offline[uid])
        worst = max(worst, gap)
        if gap <= STREAM_SCORE_TOL:
            continue
        div = beam_tie(model, feats[uid], stream_frames[uid])
        if div is None or div[1] > STREAM_SCORE_TOL:
            raise AssertionError(f"{name}: streamed beam score {score} vs "
                                 f"offline {offline[uid]} on {uid}; the "
                                 f"beams part at {div} (frame, margin)")
        ties[uid] = {"score_gap": gap, "frame": div[0], "margin": div[1]}
    return worst, ties


def check_beam_composition(name, model, stream_frames, lengths, beams,
                           scores, also=()):
    """On the first STREAM_COMPOSE_UTTS utterances and those named in
    `also` (the streamed beam's rounding ties), one beam search over
    all the streamed frames' log-probs (chunk_log_probs, the first
    lengths[id] frames: the same inputs) gives the streamed beam's 1-best
    and its score (within STREAM_SCORE_TOL): advancing a chunk at a time
    composes to the whole search. -> the largest score gap."""
    from tpu_asr_torch.decode.ctc_beam import (beam_advance, beam_finalize,
                                               beam_init)
    worst = 0.0
    uids = list(stream_frames)[:STREAM_COMPOSE_UTTS]
    for uid in uids + [u for u in also if u not in uids]:
        frames = stream_frames[uid]
        with torch.inference_mode():
            logp = chunk_log_probs(model, frames, lengths[uid])
            state = beam_init(1, STREAM_BEAM, 200, device=frames.device)
            toks, lens, sc = beam_finalize(beam_advance(
                state, logp, torch.ones(logp.shape[:2], dtype=torch.bool,
                                        device=frames.device)))
        got = toks[0, 0, :int(lens[0, 0])].tolist()
        worst = max(worst, abs(float(sc[0, 0]) - scores[uid]))
        if got != beams[uid][0] or worst > STREAM_SCORE_TOL:
            raise AssertionError(f"{name}: the beam over the streamed frames "
                                 f"in one call gives {got} ({float(sc[0, 0])})"
                                 f", the streamed beam {beams[uid][0]} "
                                 f"({scores[uid]}) on {uid}")
    return worst


def check_stream_ctc(card, name, cfg, model, feats):
    """13b on one model: StreamingCTCRecognizer (64-frame pushes) on every
    utterance against the offline greedy_ctc of the port's Recognizer on
    the card (tokens, times equal; confidences within 1e-4); the streamed
    encode_chunk frames against Encoder.forward (within 1e-4);
    StreamingCTCBeamRecognizer beam 5 against the offline ctc_beam 5 (the
    1-best equal unless the searches part at a rounding tie, within
    STREAM_TIE_MARGIN; its score within 1e-3 unless they part at a
    pruning tie, check_beam_scores) and against one search over the
    streamed frames (check_beam_composition, every tie included); the
    full-recompute path on STREAM_RECOMPUTE_UTTS utterances (the same
    tokens). No kernel
    launches on these paths. -> ({id: greedy tokens}, {id: beam tokens},
    the numbers)."""
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.ctc_beam import beam_finalize
    from tpu_asr_torch.decode.streaming import (StreamingCTCBeamRecognizer,
                                                StreamingCTCRecognizer)
    eos = cfg.vocab_size - 1
    counters = kernel_counters()
    # main path: counts from 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    greedy, frames_gap, chunks, waits = {}, 0.0, [0], []
    streamed_ids, stream_frames = {}, {}
    t0 = time.perf_counter()
    for uid, x in feats.items():
        rows = []
        with wrap_method(model.encoder, "encode_chunk",
                         after=lambda out: rows.append(out[0][0])):
            rec = StreamingCTCRecognizer(cfg, model, max_frames=3000,
                                         device=DEVICE)
            _, hyp, w = stream_pushes(rec, x)
        waits += w
        chunks[0] += len(rows)
        el = cfg.subsampled_length(len(x))
        with torch.inference_mode():
            enc, _ = model.encode(torch.from_numpy(x[None]).to(DEVICE),
                                  torch.tensor([len(x)], device=DEVICE))
            got = torch.cat(rows)
            frames_gap = max(frames_gap,
                             float((got[:el] - enc[0, :el]).abs().max()))
            streamed_ids[uid] = chunk_log_probs(model, got, el)[0].argmax(
                -1).tolist()
            stream_frames[uid] = got
        greedy[uid] = (hyp, rec.hypothesis_times, rec.hypothesis_confidence)
    stream_s = time.perf_counter() - t0
    beams, beam_scores = {}, {}
    t0 = time.perf_counter()
    for uid, x in feats.items():
        rec = StreamingCTCBeamRecognizer(cfg, model, beam=STREAM_BEAM,
                                         max_frames=3000, device=DEVICE)
        _, hyp, _ = stream_pushes(rec, x)
        beams[uid] = (hyp, None, None)
        beam_scores[uid] = float(beam_finalize(rec._bstate)[2][0, 0])
    beam_s = time.perf_counter() - t0
    recompute = {}
    for uid in list(feats)[:STREAM_RECOMPUTE_UTTS]:
        rec = StreamingCTCRecognizer(cfg, model, max_frames=3000,
                                     incremental=False, device=DEVICE)
        outs, hyp, _ = stream_pushes(rec, feats[uid])
        recompute[uid] = hyp
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    check_launches(f"{name}: streaming decodes", launches, {})
    if frames_gap > STREAM_FRAME_TOL:
        raise AssertionError(f"{name}: encode_chunk frames {frames_gap} from "
                             f"Encoder.forward's (limit {STREAM_FRAME_TOL})")
    bad = [u for u in recompute if recompute[u] != greedy[u][0]]
    if bad:
        raise AssertionError(f"{name}: the full-recompute path differs on "
                             f"{bad}")

    def margins(uid):
        with torch.inference_mode():
            x = feats[uid]
            enc, _ = model.encode(torch.from_numpy(x[None]).to(DEVICE),
                                  torch.tensor([len(x)], device=DEVICE))
            return top2_margins(model.ctc_logits(enc[0]), streamed_ids[uid])

    offline = offline_decode(cfg, model, feats, "greedy_ctc",
                             BeamConfig(beam=1))
    greedy_cmp = compare_streamed(f"{name}: streamed greedy CTC", greedy,
                                  offline, eos, margins)
    offline_beam = offline_decode(cfg, model, feats, "ctc_beam",
                                  BeamConfig(beam=STREAM_BEAM, max_len=200))
    def beam_margins(uid):
        div = beam_tie(model, feats[uid], stream_frames[uid])
        return [] if div is None else [div]

    # the 1-best is held equal unless the two searches part where the
    # prefix one drops stood within STREAM_TIE_MARGIN of the other's
    # weakest survivor: the frames round apart by ~1e-6, and a run's
    # trained checkpoint has parted at 0.0 and 1.5e-5 (python3
    # chip_smoke.py --beam-ties measures how often); a tied utterance's
    # streamed 1-best is then held to one search over its own frames
    beam_cmp = compare_streamed(f"{name}: streamed CTC beam "
                                f"{STREAM_BEAM}", beams, offline_beam, eos,
                                beam_margins)
    score_gap, ties = check_beam_scores(
        name, model, feats, stream_frames, beam_scores,
        {u: h["score"] for u, h in offline_beam.items()})
    compose_gap = check_beam_composition(
        name, model, stream_frames,
        {u: cfg.subsampled_length(len(x)) for u, x in feats.items()}, beams,
        beam_scores, also=beam_cmp["ties"])
    audio_s = sum(len(x) for x in feats.values()) / 100.0
    out = {"utterances": len(feats), "audio_s": audio_s,
           "chunk_steps": chunks[0], "frames_max_abs_gap": frames_gap,
           "greedy": greedy_cmp,
           "beam": dict(beam_cmp, max_score_gap=score_gap,
                        pruning_ties=ties,
                        same_frames_max_score_gap=compose_gap),
           "recompute_utts": len(recompute),
           "greedy_stream_s": stream_s, "greedy_inverse_rtf":
               audio_s / stream_s, "beam_stream_s": beam_s,
           "push_latency": latency_summary(waits)}
    log(f"13b {name}: streamed (pushes of {STREAM_PUSH_FRAMES} frames) == "
        f"offline on the card: " + json.dumps(out) + f" [{card}]")
    return ({u: v[0] for u, v in greedy.items()},
            {u: v[0] for u, v in beams.items()}, out)


def run_stream_demo(card, ckpt, cv_manifest, greedy, beams):
    """13c: python -m tpu_asr_torch.stream_demo on 13a's checkpoint and
    the first len(greedy) utterances of the cv manifest (--limit),
    greedy and --beam 5: each utterance's hypothesis is 13b's on that
    checkpoint. -> the two summaries."""
    import io
    from tpu_asr_torch import stream_demo
    summaries = {}
    for name, flags, want in (("greedy", [], greedy),
                              (f"beam {STREAM_BEAM}",
                               ["--beam", str(STREAM_BEAM), "--quiet"],
                               beams)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            summary = stream_demo.main([
                "--ckpt", ckpt, "--manifest", cv_manifest, "--chunk-frames",
                str(STREAM_PUSH_FRAMES), "--limit", str(len(want))] + flags)
        lines = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
        pushes = [x for x in buf.getvalue().splitlines()
                  if x.strip().startswith("[")]
        hyps = {x["id"]: x["tokens"] for x in lines[:-1]}
        if lines[-1] != summary or summary["n_utts"] != len(want) or \
                hyps != want:
            diff = [u for u in want if hyps.get(u) != want[u]]
            raise AssertionError(f"stream_demo {name}: summary {summary}, "
                                 f"{len(hyps)} hypotheses, differing from "
                                 f"13b's on {diff[:4]}")
        log(f"13c stream_demo --ckpt <13a> {name}: {len(pushes)} push lines "
            f"(e.g. {pushes[:2]}), hypotheses == 13b's; summary "
            + json.dumps(summary) + f" [{card}]")
        summaries[name] = summary
    return summaries


def check_stream_transducers(card, utts, frontend):
    """13d: random full-width transducer_streaming and conformer_transducer
    (chunk 16) weights: StreamingTransducerRecognizer on
    STREAM_TRANSDUCER_UTTS cv utterances against the offline
    transducer_greedy of the port's Recognizer on the card (tokens and
    times equal, confidences within 1e-4). -> the numbers."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.streaming import StreamingTransducerRecognizer
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random
    out = {}
    for preset in ("transducer_streaming", "conformer_transducer"):
        cfg = get_preset(preset).model
        model = init_random(build_model(cfg), SEED)
        feats = stream_features(cfg, frontend,
                                utts[:STREAM_TRANSDUCER_UTTS])
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        streamed, waits = {}, []
        t0 = time.perf_counter()
        for uid, x in feats.items():
            rec = StreamingTransducerRecognizer(
                cfg, model, max_frames=3000, max_tokens=STREAM_MAX_TOKENS,
                device=DEVICE)
            outs, hyp, w = stream_pushes(rec, x)
            waits += w
            mid = [t for o in outs for t in o]
            if mid != hyp[:len(mid)]:
                raise AssertionError(f"{preset}: pushes {mid} are not a "
                                     f"prefix of {hyp}")
            streamed[uid] = (hyp, rec.hypothesis_times,
                             rec.hypothesis_confidence)
        wall = time.perf_counter() - t0
        check_launches(f"{preset} streaming", {
            k: f.launches for k, f in counters.items() if f.launches}, {})
        offline = offline_decode(cfg, model, feats, "transducer_greedy",
                                 BeamConfig(beam=1,
                                            max_len=STREAM_MAX_TOKENS))
        cmp = compare_streamed(f"{preset}: streamed transducer greedy",
                               streamed, offline, cfg.vocab_size - 1)
        audio_s = sum(len(x) for x in feats.values()) / 100.0
        out[preset] = dict(cmp, encoder=cfg.encoder_type,
                           chunk=cfg.enc_chunk_size, stream_s=wall,
                           inverse_rtf=audio_s / wall,
                           push_latency=latency_summary(waits))
    log("13d transducers (random full-width weights, seed 0): streamed == "
        "offline transducer_greedy on the card: " + json.dumps(out)
        + f" [{card}]")
    return out


def run_stream_serving(card, cfg, model, feats, want):
    """13e: make_http_server with StreamSessions on 13b's random-weight
    model: STREAM_SESSIONS concurrent sessions, one cv utterance each in
    64-frame pushes; each final reply's tokens are 13b's and carry times
    and confidence; a push after final answers 410; /healthz shows
    streaming and the active sessions. Then one session through
    StreamSessions.push under torch.profiler. -> the numbers."""
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.serve import (AsrServer, StreamSessions,
                                     make_http_server)
    rec = Recognizer(cfg, model, mode="greedy_ctc", device=DEVICE,
                     beam=BeamConfig(beam=1))
    server = AsrServer(rec, bucket_frames=BUCKETS, batch_size=BATCH,
                       device=DEVICE)
    streams = StreamSessions(cfg, rec.model, device=DEVICE)
    httpd = make_http_server("127.0.0.1", 0, server, None, streams)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, obj):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(obj).encode())
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    uids = list(feats)[:STREAM_SESSIONS]
    results = {}

    def session(uid):
        x, waits = feats[uid], []
        t0 = time.perf_counter()
        for p in range(0, len(x), STREAM_PUSH_FRAMES):
            s = time.perf_counter()
            code, body = post("/stream", {
                "session": uid, "feats": x[p:p + STREAM_PUSH_FRAMES].tolist()})
            waits.append(time.perf_counter() - s)
            if code != 200:
                raise AssertionError(f"/stream {uid}: {code} {body}")
        s = time.perf_counter()
        code, final = post("/stream", {"session": uid, "final": True})
        waits.append(time.perf_counter() - s)
        results[uid] = (code, final, waits, time.perf_counter() - t0)

    try:
        with concurrent.futures.ThreadPoolExecutor(STREAM_SESSIONS) as pool:
            list(pool.map(session, uids))
        code_late, _ = post("/stream", {"session": uids[0], "feats": []})
        post("/stream", {"session": "probe",
                         "feats": feats[uids[0]][:8].tolist()})
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        post("/stream", {"session": "probe", "final": True})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    for uid, (code, final, _, _) in results.items():
        if code != 200 or not final.get("final") or \
                final["tokens"] != want[uid] or \
                len(final.get("times", ())) != len(want[uid]) or \
                len(final.get("confidence", ())) != len(want[uid]):
            raise AssertionError(f"/stream {uid}: {code} {final}, 13b's "
                                 f"tokens {want[uid]}")
    if code_late != 410 or health.get("streaming") is not True or \
            health.get("active_streams") != 1:
        raise AssertionError(f"/stream after final answered {code_late}; "
                             f"/healthz {health}")
    sessions = {uid: {"pushes": len(w), "inverse_rtf":
                      len(feats[uid]) / 100.0 / wall,
                      "tokens": len(want[uid])}
                for uid, (_, _, w, wall) in results.items()}
    lat = latency_summary([s for r in results.values() for s in r[2]])

    # one session under the profiler, pushed in this thread
    uid = uids[0]
    steps = []
    local = StreamSessions(cfg, rec.model, device=DEVICE)
    with wrap_method(model.encoder, "encode_chunk",
                     after=lambda _: steps.append(1)):
        prof = profile_device(lambda: [local.push(
            "p", feats[uid][p:p + STREAM_PUSH_FRAMES]) for p in range(
                0, len(feats[uid]), STREAM_PUSH_FRAMES)] + [local.push(
                    "p", [], final=True)], "one /stream session", card)
    per_chunk = {"chunk_steps": len(steps),
                 "device_ms_per_chunk": prof["device_ms"] / len(steps),
                 "device_events_per_chunk": prof["device_events"]
                 / len(steps),
                 "busy_share": prof["device_ms"] / prof["wall_ms"]}
    out = {"sessions": sessions, "push_latency": lat, "late_push": code_late,
           "healthz": {k: health[k] for k in ("streaming",
                                              "active_streams")},
           "profiled_session": per_chunk}
    log(f"13e {STREAM_SESSIONS} concurrent HTTP /stream sessions == 13b's "
        f"tokens (with times and confidence): " + json.dumps(out)
        + f" [{card}]")
    return out


def run_streaming_phase(card, workdir, data, aishell_stats, cv_manifest):
    """Phase 13: the streaming preset trained at full width (13a), its
    checkpoint and random weights streamed against the offline decodes
    on the card (13b), python -m tpu_asr_torch.stream_demo (13c), the
    streaming transducers (13d), /stream serving (13e); then the CTC pair
    on the inputs 13a's training gave it against the plain versions. ->
    ({"streaming": training launches}, {"ctc": path timings}, errors)."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.weights import init_random
    ckpt = os.path.join(workdir, "streaming")
    ctc_caps, stats = {}, {}
    wall = {"start": time.perf_counter()}

    def lap(part):
        wall[part] = time.perf_counter() - wall["start"] - sum(
            v for k, v in wall.items() if k != "start")
    launches = run_training(card, ckpt, "streaming", data, {}, None, None,
                            ctc_caps, stats=stats, profiled_steps=2)
    keys = ("step_ms_median", "steps_per_s", "audio_s_per_s", "peak_gib",
            "device_ms_per_step", "busy_share", "device_events_per_step",
            "fixed_step_ms_median")
    log("13a streaming training beside aishell (phase 8), same corpus: "
        + json.dumps({"streaming": {k: stats[k] for k in keys},
                      "aishell": {k: aishell_stats[k] for k in keys}})
        + f"; train loss by epoch "
        f"{[h['train_loss'] for h in stats['history']]} [{card}]")
    lap("training")
    utts = load_manifest(cv_manifest)[:STREAM_CV_UTTS]
    ck = Checkpointer(ckpt)
    cfg = ck.load_config()
    trained = build_model(cfg)
    trained.load_state_dict(ck.restore(restore_step(ck, -1, "best"))
                            ["model"])
    frontend = ck.load_frontend() or FrontendConfig()
    feats = stream_features(cfg, frontend, utts)
    greedy, beams, numbers = check_stream_ctc(card, "13a's checkpoint", cfg,
                                              trained, feats)
    rcfg = get_preset("streaming").model
    random_model = init_random(build_model(rcfg), SEED)
    r_feats = dict(list(feats.items())[:STREAM_RANDOM_UTTS])
    r_greedy, _, r_numbers = check_stream_ctc(
        card, "random streaming weights (seed 0)", rcfg, random_model,
        r_feats)
    lap("streamed_vs_offline")
    demo = run_stream_demo(card, ckpt, cv_manifest, greedy, beams)
    lap("stream_demo")
    transducers = check_stream_transducers(card, utts, frontend)
    lap("transducers")
    serving = run_stream_serving(card, rcfg, random_model, r_feats,
                                 r_greedy)
    lap("serving")
    paths, errs, bitwise = check_ctc_pair_on_paths(ctc_caps)
    lap("ctc_pair")
    del wall["start"]
    log("phase 13 wall seconds by part: " + json.dumps(wall))
    if len(paths) != 1:
        raise AssertionError(f"the streaming training recorded {len(paths)} "
                             f"CTC backwards")
    log(f"ctc_loss_fwd and ctc_loss_bwd vs plain on the streaming "
        f"training's inputs: 1 + 1 calls agree (the forward's bits the "
        f"plain version's: {bitwise}): " + json.dumps(errs))
    stats.update(stream={"checkpoint": numbers, "random": r_numbers,
                         "demo": demo, "transducers": transducers,
                         "serving": serving})
    return {"streaming": launches}, {"ctc": paths}, errs


def measure_beam_ties(card, trials: int) -> int:
    """python3 chip_smoke.py --beam-ties N: 13b's streamed CTC beam 5
    against the offline ctc_beam 5 on N streaming checkpoints trained as
    13a (seeds 0 .. N-1), checking nothing: every utterance whose 1-best
    differs is logged with where the two searches part (beam_tie: frame,
    margin), the 1-best scores' gap and the offline top-2 gap. This
    measures the margins the phase's beam token check is set from."""
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.ctc_beam import beam_finalize
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.decode.streaming import StreamingCTCBeamRecognizer
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.ops import ctc_loss
    from tpu_asr_torch.ops.cuda_build import load_all
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer
    load_all(ctc_loss.LIBRARY)
    data = synthetic_aishell()
    found, n_utts = [], 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        utts = load_manifest(write_wav_manifest(
            data[1], data[3], os.path.join(workdir, "cv")))
        for seed in range(trials):
            ckpt = os.path.join(workdir, f"streaming_{seed}")
            run_training(card, ckpt, "streaming", data, {}, None, None, None,
                         argv=["--seed", str(seed)], profiled_steps=1,
                         fixed_steps=1)
            ck = Checkpointer(ckpt)
            cfg = ck.load_config()
            model = build_model(cfg)
            model.load_state_dict(ck.restore(restore_step(ck, -1, "best"))
                                  ["model"])
            feats = stream_features(cfg, ck.load_frontend()
                                    or FrontendConfig(), utts)
            offline = Recognizer(cfg, model, mode="ctc_beam", device=DEVICE,
                                 beam=BeamConfig(beam=STREAM_BEAM,
                                                 max_len=200))
            for uid, x in feats.items():
                rows = []
                with wrap_method(model.encoder, "encode_chunk",
                                 after=lambda out: rows.append(out[0][0])):
                    rec = StreamingCTCBeamRecognizer(
                        cfg, model, beam=STREAM_BEAM, max_frames=3000,
                        device=DEVICE)
                    _, hyp, _ = stream_pushes(rec, x)
                score = float(beam_finalize(rec._bstate)[2][0, 0])
                nbest = offline.decode_batch_nbest({
                    "feats": x[None],
                    "feat_lengths": np.asarray([len(x)], np.int32)})[0]
                n_utts += 1
                got = [t for t in hyp if t != cfg.vocab_size - 1]
                if got == nbest[0]["yseq"]:
                    continue
                found.append({
                    "seed": seed, "id": uid,
                    "part": beam_tie(model, x, torch.cat(rows)),
                    "score_gap": score - nbest[0]["score"],
                    "offline_top2_gap": (nbest[0]["score"]
                                         - nbest[1]["score"]
                                         if len(nbest) > 1 else None),
                    "is_offline_2nd": len(nbest) > 1
                    and got == nbest[1]["yseq"]})
                log(f"beam tie: {json.dumps(found[-1])}")
    log(f"beam ties: {len(found)} of {n_utts} utterances on {trials} "
        f"streaming checkpoints differ in their beam-{STREAM_BEAM} 1-best; "
        f"the searches part with margins "
        f"{[f['part'][1] if f['part'] else None for f in found]} [{card}]")
    return 0


# ---- phase 14: the reference's own inputs (pitch, LFR, Kaldi ark),
# forced alignment and checkpoint averaging ----

# pitch on one side (the card, or the port) against a reference side (the
# CPU, or tpu_asr in the tests): the picks are decisions a rounding can
# flip, so the lags are held equal except where the reference side's own
# decision is within a margin of flipping, and the features only on the
# utterances whose lags all agree. A flip shifts the utterance's
# POV-weighted log-pitch mean, so such an utterance is counted, not held.
PITCH_NCCF_ATOL = 1e-4        # the NCCF at every frame and lag
PITCH_MARGIN = 2e-4           # a band value this near peak - 0.025 may
#                               flip a pick (2 x the NCCF tolerance)
PITCH_VITERBI_MARGIN = 1e-3   # a predecessor this near the best may flip
#                               a Viterbi track (path sums of T frames)
PITCH_FEAT_ATOL = 1e-3        # POV, log-pitch and delta of a flip-free
#                               utterance (the parabolic refinement divides
#                               by the NCCF's curvature)
PITCH_MAX_FLIP_SHARE = 0.01   # of the valid frames, lags that may differ


def pitch_viterbi_gaps(band, lags, weight: float, min_lag: int):
    """The Viterbi track's decisions on band [B, T, L] (torch) whose
    track is lags [B, T]: [B, T] the best less the second-best score of
    the decision that picked each frame's lag (the predecessor choice of
    frame t + 1's state, the final argmax for the last frame), float32
    on band's device."""
    b, t, n = band.shape
    ll = np.log(np.arange(min_lag, min_lag + n, dtype=np.float64))
    trans = torch.from_numpy((-weight * (ll[:, None] - ll[None, :]) ** 2)
                             .astype(np.float32)).to(band.device)
    state = (lags - min_lag).long().to(band.device)
    gaps = torch.empty((b, t), device=band.device)
    carry = band[:, 0]
    for i in range(1, t):
        scores = carry[:, :, None] + trans                 # [B, prev, cur]
        col = scores.gather(2, state[:, i, None, None].expand(b, n, 1))
        top = col[..., 0].topk(2, dim=-1).values
        gaps[:, i - 1] = top[:, 0] - top[:, 1]
        carry = scores.max(dim=1).values + band[:, i]
    top = carry.topk(2, dim=-1).values
    gaps[:, t - 1] = top[:, 0] - top[:, 1]
    return gaps


def pitch_margins(nccf, lags, cfg, device="cpu"):
    """[B, T] numpy: how near each frame's lag pick on this side came to
    flipping. Per-frame picks (pitch_smooth_weight 0): the least distance
    of a band value from peak - 0.025; Viterbi: pitch_viterbi_gaps."""
    from tpu_asr_torch.frontend import _pitch_constants
    min_lag, max_lag = _pitch_constants(cfg)[:2]
    band = torch.tensor(nccf[..., min_lag:max_lag + 1], device=device,
                        dtype=torch.float32)
    if cfg.pitch_smooth_weight > 0.0:
        gaps = pitch_viterbi_gaps(band, torch.tensor(lags),
                                  cfg.pitch_smooth_weight, min_lag)
        return gaps.cpu().numpy()
    thr = band.max(dim=-1, keepdim=True).values - 0.025
    return (band - thr).abs().min(dim=-1).values.cpu().numpy()


def port_viterbi_lags(band, cfg):
    """The port's _viterbi_lags on the CPU over a numpy band [B, T, L]
    -> numpy lags [B, T]."""
    from tpu_asr_torch.frontend import _pitch_constants, _viterbi_lags
    min_lag, max_lag = _pitch_constants(cfg)[:2]
    return _viterbi_lags(torch.from_numpy(band), min_lag, max_lag,
                         cfg.pitch_smooth_weight).numpy()


def compare_pitch(what, ref, got, frame_lengths, cfg, device="cpu",
                  viterbi_lags=port_viterbi_lags) -> dict:
    """Pitch of one side `got` against a reference side `ref`, each a
    dict of numpy "nccf" [B, T, max_lag + 2], "lags" [B, T] (the integer
    picks) and "feats" [B, T, 3], over frame_lengths [B]: the NCCF within
    PITCH_NCCF_ATOL; every lag that differs explained by a near flip on
    the reference side (pitch_margins within PITCH_MARGIN at that frame;
    Viterbi: within PITCH_VITERBI_MARGIN anywhere on that row, whose
    track a flip re-routes); at most PITCH_MAX_FLIP_SHARE of the valid
    frames differing; the features within PITCH_FEAT_ATOL on every
    utterance whose lags all agree. The margins are computed on
    `device`. With the Viterbi track the decision is also held apart
    from the NCCF's rounding: the reference side's track
    (viterbi_lags(band, cfg), band [B, T, L] numpy) over got's own band
    must give got's lags bit for bit, as max and add are exact. -> the
    counts and gaps."""
    viterbi = cfg.pitch_smooth_weight > 0.0
    lens = np.asarray(frame_lengths)
    t = ref["lags"].shape[-1]
    valid = np.arange(t)[None, :] < lens[:, None]
    nccf_gap = float(np.abs(ref["nccf"] - got["nccf"]).max()) if t else 0.0
    margins = (pitch_margins(ref["nccf"], ref["lags"], cfg, device) if t
               else np.zeros((len(lens), 0)))
    differ = ref["lags"] != got["lags"]
    if viterbi:
        near_row = (margins <= PITCH_VITERBI_MARGIN).any(axis=-1)
        unexplained = differ & ~near_row[:, None]
    else:
        unexplained = differ & (margins > PITCH_MARGIN)
    flipped = differ.any(axis=-1)
    flips = int((differ & valid).sum())
    same = ~flipped
    feat_gap = (float(np.abs(ref["feats"][same] - got["feats"][same]).max())
                if same.any() and t else 0.0)
    out = {"utts": len(lens), "valid_frames": int(valid.sum()),
           "flipped_frames": flips, "flipped_utts": int(flipped.sum()),
           "near_flip_frames": int((margins <= (PITCH_VITERBI_MARGIN
                                               if viterbi else PITCH_MARGIN))
                                   .sum()),
           "nccf_max_abs_err": nccf_gap, "feat_max_abs_err": feat_gap}
    if viterbi and t:
        from tpu_asr_torch.frontend import _pitch_constants
        min_lag, max_lag = _pitch_constants(cfg)[:2]
        band = np.ascontiguousarray(got["nccf"][..., min_lag:max_lag + 1])
        track = viterbi_lags(band, cfg) != got["lags"]
        out["track_differs_frames"] = int(track.sum())
        if track.any():
            rows = sorted(set(np.nonzero(track)[0].tolist()))[:3]
            raise AssertionError(
                f"{what}: the reference side's Viterbi track over this "
                f"side's own band differs at {int(track.sum())} frames "
                f"(rows {rows}, frames "
                f"{[np.nonzero(track[r])[0][:5].tolist() for r in rows]})")
    if nccf_gap > PITCH_NCCF_ATOL or unexplained.any() or \
            flips > PITCH_MAX_FLIP_SHARE * max(int(valid.sum()), 1) or \
            feat_gap > PITCH_FEAT_ATOL:
        rows = sorted(set(np.nonzero(unexplained)[0].tolist()))[:3]
        raise AssertionError(
            f"{what}: pitch differs beyond the margin rule: {out}; "
            f"unexplained lag flips in rows {rows} at frames "
            f"{[np.nonzero(unexplained[r])[0][:5].tolist() for r in rows]}")
    return out


def pitch_run(wav, wav_lengths, cfg, device) -> dict:
    """The port's pitch of a padded batch on `device`: numpy "nccf",
    "lags" (pitch_track) and "feats" (pitch_from_track of them), and the
    frame lengths."""
    from tpu_asr_torch.frontend import pitch_from_track, pitch_track
    w = torch.as_tensor(wav, device=device)
    lens = torch.as_tensor(wav_lengths, device=device)
    flens = torch.where(lens < cfg.frame_length, 0, 1 + torch.clamp(
        lens - cfg.frame_length, min=0) // cfg.frame_shift)
    nccf, lags = pitch_track(w, cfg)
    feats = pitch_from_track(nccf, lags, flens, cfg)
    return {"nccf": nccf.cpu().numpy(), "lags": lags.cpu().numpy(),
            "feats": feats.cpu().numpy(), "frame_lengths":
            flens.cpu().numpy()}


PITCH_CHECK_UTTS = 64         # 14a: phase 8's first train utterances
PITCH_BATCH_FRAMES = 32000    # 14a: the batch wav_to_features is timed on
AVERAGE_LAST = 3              # 14e: average_checkpoints --last
PITCH_DECODES = (("joint", ["--mode", "joint", "--beam", "5", "--max-len",
                            "40"]),)
PITCH_PATH = "aishell --pitch joint (recognize)"
# a model of 40 steps ends every hypothesis at once; --minlenratio bans
# eos before 5% of the encoder length, so the two decodes emit tokens
LFR_BEAM = ["--mode", "beam", "--beam", "5", "--max-len", "40",
            "--minlenratio", "0.05"]


def padded_waves(utts, waves):
    """The utterances' waves as one zero-padded batch -> (wav [B, S]
    float32, lengths [B] int32)."""
    lens = np.array([len(waves[u.id]) for u in utts], np.int32)
    wav = np.zeros((len(utts), int(lens.max())), np.float32)
    for i, u in enumerate(utts):
        wav[i, :lens[i]] = waves[u.id]
    return wav, lens


def check_pitch_on_card(card, data) -> dict:
    """14a: pitch of phase 8's first PITCH_CHECK_UTTS train utterances on
    the card against the CPU (compare_pitch), with the --pitch default
    (pitch_smooth_weight 0: per-frame picks) and with 4.0 (the Viterbi
    track); then wav_to_features with and without pitch on one batch of
    about PITCH_BATCH_FRAMES frames: CUDA-event ms, device ms and events
    under the profiler, and the peak memory above the inputs."""
    from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
    train, _, _, waves = data
    wav, lens = padded_waves(train[:PITCH_CHECK_UTTS], waves)
    out = {}
    for weight in (0.0, 4.0):
        cfg = FrontendConfig(add_pitch=True, pitch_smooth_weight=weight)
        t0 = time.perf_counter()
        on_card = pitch_run(wav, lens, cfg, DEVICE)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = pitch_run(wav, lens, cfg, "cpu")
        cpu_s = time.perf_counter() - t0
        what = f"14a pitch, smooth weight {weight}, card vs CPU"
        res = compare_pitch(what, on_cpu, on_card, on_cpu["frame_lengths"],
                            cfg, device=DEVICE)
        out[f"smooth_weight_{weight}"] = dict(res, card_wall_s=card_s,
                                              cpu_wall_s=cpu_s)
        log(f"{what} on {len(wav)} utterances [{wav.shape[1]} samples]: "
            f"{json.dumps(res)} (NCCF atol {PITCH_NCCF_ATOL}, margins "
            f"{PITCH_MARGIN} / {PITCH_VITERBI_MARGIN}, features atol "
            f"{PITCH_FEAT_ATOL}, flips <= {PITCH_MAX_FLIP_SHARE} of the "
            f"frames); wall {card_s:.2f} s on the card, {cpu_s:.2f} s on "
            f"the CPU [{card}]")
    n, shift = 1, FrontendConfig().frame_shift
    while n < len(train) and (n + 1) * max(
            len(waves[u.id]) for u in train[:n + 1]) // shift <= \
            PITCH_BATCH_FRAMES:
        n += 1
    wav, lens = padded_waves(train[:n], waves)
    w = torch.as_tensor(wav, device=DEVICE)
    wl = torch.as_tensor(lens, device=DEVICE)
    frames = n * FrontendConfig().num_frames(wav.shape[1])
    for add_pitch in (False, True):
        cfg = FrontendConfig(add_pitch=add_pitch)
        what = f"14a wav_to_features {'with' if add_pitch else 'without'} " \
               f"pitch, [{n}, {wav.shape[1]}] ({frames} frames)"
        ms = cuda_ms(lambda: wav_to_features(w, wl, cfg), reps=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wav_to_features(w, wl, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        prof = profile_device(lambda: wav_to_features(w, wl, cfg), what,
                              card, warmup=True)
        out[f"features_pitch_{add_pitch}"] = dict(
            prof, ms=ms, peak_mib=peak / 2**20, frames=frames)
        log(f"{what}: {ms:.4f} ms by CUDA events (median of 10), device "
            f"{prof['device_ms']:.4f} ms in {prof['device_events']} events "
            f"under the profiler, peak {peak / 2**20:.1f} MiB above the "
            f"inputs [{card}]")
    return out


def run_pitch_path(card, workdir, data, aishell_stats, cv_manifest):
    """14b: `python -m tpu_asr_torch.train --preset aishell --pitch` at
    full width on phase 8's corpus (run_training: the phase 8 checks;
    AVERAGE_LAST epochs at least, a checkpoint each, for 14e):
    model_config.json's d_input 83 and frontend.json's add_pitch; beside
    phase 8's aishell numbers. recognize --ckpt on the cv manifest in
    joint beam 5 (ctc_prefix_scan once a joint step), serve --ckpt; then
    the CTC pair and the prefix scan on the inputs this path gave them,
    against their plain versions. -> (checkpoint folder, training
    launches, joint prefix-scan launches, {"prefix", "ctc": path
    timings}, errors, {decode: summary})."""
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.train.checkpoints import Checkpointer
    ckpt = os.path.join(workdir, "aishell_pitch")
    ctc_caps, stats = {}, {}
    launches = run_training(card, ckpt, PRESET, data, {}, None, None,
                            ctc_caps, argv=["--pitch"], stats=stats,
                            min_epochs=AVERAGE_LAST)
    ck = Checkpointer(ckpt)
    cfg, frontend = ck.load_config(), ck.load_frontend()
    if cfg.d_input != 83 or frontend is None or not frontend.add_pitch or \
            len(ck.all_steps()) < AVERAGE_LAST:
        raise AssertionError(f"aishell --pitch: model_config d_input "
                             f"{cfg.d_input}, frontend.json {frontend}, "
                             f"steps {ck.all_steps()}")
    keys = ("step_ms_median", "steps_per_s", "audio_s_per_s", "peak_gib",
            "device_ms_per_step", "busy_share", "device_events_per_step",
            "fixed_step_ms_median")
    log("14b aishell --pitch training beside aishell (phase 8), same "
        "corpus: " + json.dumps({"aishell --pitch": {k: stats[k]
                                                     for k in keys},
                                 "aishell": {k: aishell_stats[k]
                                             for k in keys}})
        + f"; d_input {cfg.d_input}, frontend.json add_pitch "
        f"{frontend.add_pitch} [{card}]")
    cv = load_manifest(cv_manifest)
    decode_dir = os.path.join(workdir, "aishell_pitch_decode")
    os.makedirs(decode_dir, exist_ok=True)
    summaries, prefix_launches, prefix_caps = run_recipe_decodes(
        card, ckpt, cv_manifest, len(cv), decode_dir, decodes=PITCH_DECODES,
        path=PITCH_PATH, what="aishell --pitch")
    log("14b aishell --pitch recognize: " + json.dumps(
        {k: {"cer": v["cer"], "inverse_rtf": v["inverse_rtf"]}
         for k, v in summaries.items()}) + f" [{card}]")
    run_ckpt_serving(card, ckpt, np.load(cv[0].wav), "aishell --pitch",
                     "joint")
    paths, errs = {}, {}
    paths["prefix"], errs["prefix"] = check_prefix_on_paths(prefix_caps)
    paths["ctc"], pair_errs, bitwise = check_ctc_pair_on_paths(ctc_caps)
    errs.update(pair_errs)
    if not paths["prefix"] or len(paths["ctc"]) != 1:
        raise AssertionError(f"the --pitch path recorded "
                             f"{len(paths['prefix'])} prefix scans and "
                             f"{len(paths['ctc'])} CTC backwards")
    log(f"ctc_prefix_scan, ctc_loss_fwd and ctc_loss_bwd vs plain on the "
        f"aishell --pitch path's inputs: {len(paths['prefix'])} + 1 + 1 "
        f"calls agree (the forward's bits the plain version's: {bitwise}): "
        + json.dumps(errs))
    return ckpt, launches, prefix_launches, paths, errs, summaries


def write_ark_corpus(workdir, data) -> dict:
    """Phase 8's corpus as a Kaldi dump holds it: each utterance's 80-dim
    fbank (not normalized), made on the card, written with the port's
    write_mat into one .ark; an espnet data.json a split pointing into
    it, turned into a manifest by python -m tpu_asr_torch.prepare_data
    --espnet-json; the same features as .npy files with a manifest a
    split. -> {split: {"ark", "npy": manifest path}}."""
    from tpu_asr_torch import prepare_data
    from tpu_asr_torch.data import Utterance, save_manifest
    from tpu_asr_torch.data.kaldi_io import write_mat
    from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
    train, cv, _, waves = data
    fcfg = FrontendConfig(cmvn_mode="none")
    out_dir = os.path.join(workdir, "ark")
    os.makedirs(out_dir, exist_ok=True)
    ark = os.path.join(out_dir, "feats.ark")
    out = {}
    t0 = time.perf_counter()
    with open(ark, "wb") as f:
        for split, utts in (("train", train), ("dev", cv)):
            entries, npy = {}, []
            for u in utts:
                w = torch.as_tensor(waves[u.id], device=DEVICE)[None]
                feats, fl = wav_to_features(
                    w, torch.tensor([w.shape[1]], device=DEVICE), fcfg)
                feats = feats[0, :int(fl[0])].cpu().numpy()
                offset = write_mat(f, feats, key=u.id)
                entries[u.id] = {
                    "input": [{"feat": f"{ark}:{offset}", "name": "input1",
                               "shape": list(feats.shape)}],
                    "output": [{"name": "target1",
                                "shape": [len(u.tokens), 4233],
                                "tokenid": " ".join(map(str, u.tokens))}]}
                path = os.path.join(out_dir, f"{u.id}.npy")
                np.save(path, feats)
                npy.append(Utterance(id=u.id, tokens=u.tokens, feat=path,
                                     num_frames=len(feats)))
            js = os.path.join(out_dir, f"data.{split}.json")
            with open(js, "w") as g:
                json.dump({"utts": entries}, g)
            out[split] = {"ark": os.path.join(out_dir, f"{split}.jsonl"),
                          "npy": os.path.join(out_dir, f"{split}.npy.jsonl")}
            prepare_data.main(["--espnet-json", js, "--out",
                               out[split]["ark"]])
            save_manifest(npy, out[split]["npy"])
    log(f"14c Kaldi dump: {len(train)} + {len(cv)} utterances of 80-dim "
        f"fbank in {ark} ({os.path.getsize(ark) / 2**20:.1f} MiB), "
        f"data.json + prepare_data --espnet-json, in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def run_ark_lfr(card, workdir, data, aishell_stats) -> dict:
    """14c: compute_cmvn on the ark train manifest equals it on the .npy
    one bitwise and on the wav manifest within CMVN_MEAN_ATOL /
    CMVN_ISTD_RTOL; the attention_lfr preset at full width trained from
    the ark manifests with --cmvn global (run_training: phase 8's checks,
    no kernel; the features of a feature manifest go in as they are, as
    in the reference, so the stats only reach frontend.json); recognize
    beam 5 gives equal tokens on the ark and the .npy cv manifests. ->
    the numbers."""
    from tpu_asr_torch import compute_cmvn, recognize
    manifests = write_ark_corpus(workdir, data)
    stats = {}
    for name, manifest in (("ark", manifests["train"]["ark"]),
                           ("npy", manifests["train"]["npy"]),
                           ("wav", write_wav_manifest(
                               data[0], data[3],
                               os.path.join(workdir, "train_wav")))):
        stats[name] = compute_cmvn.main([
            "--manifest", manifest, "--out",
            os.path.join(workdir, f"cmvn_{name}.npz")])
    ark_s, npy_s, wav_s = stats["ark"], stats["npy"], stats["wav"]
    mean_gap = float(np.abs(ark_s["mean"] - wav_s["mean"]).max())
    istd_gap = float(np.abs(ark_s["istd"] / wav_s["istd"] - 1.0).max())
    if not all(np.array_equal(ark_s[k], npy_s[k])
               for k in ("mean", "istd", "frames")) or \
            ark_s["frames"] != wav_s["frames"] or \
            not (mean_gap <= CMVN_MEAN_ATOL and istd_gap <= CMVN_ISTD_RTOL):
        raise AssertionError(f"compute_cmvn: ark {ark_s}, npy {npy_s}, wav "
                             f"mean gap {mean_gap}, istd gap {istd_gap}")
    log(f"14c compute_cmvn: the ark manifest's stats == the .npy one's "
        f"bitwise ({int(ark_s['frames'])} frames); the wav manifest's within"
        f" {mean_gap:.2e} (mean) and {istd_gap:.2e} (istd, relative)")
    ckpt = os.path.join(workdir, "attention_lfr")
    train_stats = {}
    launches = run_training(card, ckpt, "attention_lfr", None, {},
                            argv=["--train-manifest",
                                  manifests["train"]["ark"],
                                  "--cv-manifest", manifests["dev"]["ark"],
                                  "--vocab-size", "4233", "--cmvn",
                                  "global", "--cmvn-stats",
                                  os.path.join(workdir, "cmvn_ark.npz")],
                            stats=train_stats)
    if any(launches.values()):
        raise AssertionError(f"attention_lfr training launched {launches}")
    keys = ("step_ms_median", "steps_per_s", "audio_s_per_s", "peak_gib",
            "device_ms_per_step", "busy_share", "device_events_per_step",
            "fixed_step_ms_median")
    log("14c attention_lfr training (ark features) beside aishell (phase "
        "8): " + json.dumps({"attention_lfr": {k: train_stats[k]
                                               for k in keys},
                             "aishell": {k: aishell_stats[k]
                                         for k in keys}})
        + f"; train loss by epoch "
        f"{[h['train_loss'] for h in train_stats['history']]} [{card}]")
    counters = kernel_counters()
    hyps, summaries = {}, {}
    for name in ("ark", "npy"):
        hyp = os.path.join(workdir, f"hyp_lfr_{name}.jsonl")
        for fn in counters.values():
            fn.launches = 0
        summaries[name], _ = run_cli(recognize.main, [
            "--ckpt", ckpt, "--manifest", manifests["dev"][name],
            "--output", hyp] + LFR_BEAM)
        check_launches(f"recognize beam (attention_lfr, {name})",
                       {k: f.launches for k, f in counters.items()
                        if f.launches}, {})
        with open(hyp) as f:
            hyps[name] = {x["id"]: x["hyp_tokens"] for x in map(json.loads,
                                                                 f)}
    if hyps["ark"] != hyps["npy"] or len(hyps["ark"]) != len(data[1]):
        raise AssertionError(f"attention_lfr beam: the ark manifest's "
                             f"{len(hyps['ark'])} hypotheses differ from "
                             f"the .npy one's")
    log(f"14c attention_lfr recognize beam 5: tokens equal on the ark and "
        f"the .npy cv manifests ({len(hyps['ark'])} utterances, "
        f"{sum(map(len, hyps['ark'].values()))} tokens): "
        + json.dumps(summaries) + f" [{card}]")
    return {"training": train_stats, "recognize": summaries,
            "cmvn_gap": [mean_gap, istd_gap]}


def run_align_check(card, ckpt, cv_manifest, workdir) -> dict:
    """14d: python -m tpu_asr_torch.align on 14b's checkpoint over the cv
    manifest: a line an utterance; each call's spans well formed (0 <=
    start <= end < the encoder length, each token after the last), and
    equal to ctc_viterbi_align on the CPU given the card's logits copied
    to the host (max and add are exact, so bit for bit)."""
    from tpu_asr_torch import align
    from tpu_asr_torch.ops import ctc as ctc_ops
    real = ctc_ops.ctc_viterbi_align
    calls = []

    def recorded(logits, labels, logit_lengths, label_lengths, *a, **kw):
        out = real(logits, labels, logit_lengths, label_lengths, *a, **kw)
        calls.append(([x.cpu() for x in (logits, labels, logit_lengths,
                                         label_lengths)], out))
        return out
    out_path = os.path.join(workdir, "align.jsonl")
    ctc_ops.ctc_viterbi_align = recorded
    t0 = time.perf_counter()
    try:
        summary, printed = run_cli(align.main, [
            "--ckpt", ckpt, "--manifest", cv_manifest, "--output", out_path])
    finally:
        ctc_ops.ctc_viterbi_align = real
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        lines = [json.loads(x) for x in f]
    n_tokens = 0
    for args, (starts, ends) in calls:
        cpu = real(*args)
        if not (torch.equal(cpu[0], starts) and torch.equal(cpu[1], ends)):
            raise AssertionError("align: the card's spans differ from the "
                                 "CPU's on the same logits")
        for i in range(len(starts)):
            ul, el = int(args[3][i]), int(args[2][i])
            st, en = starts[i, :ul], ends[i, :ul]
            n_tokens += ul
            if not (bool((st >= 0).all()) and bool((en >= st).all()) and
                    bool((en < el).all()) and bool((st[1:] > en[:-1])
                                                   .all())):
                raise AssertionError(f"align: ill-formed spans {st} {en} "
                                     f"for encoder length {el}")
    if printed != summary or summary["n_utts"] != len(lines) or \
            sum(len(x["tokens"]) for x in lines) != n_tokens:
        raise AssertionError(f"align: {summary}, {len(lines)} lines")
    log(f"14d align: {json.dumps(summary)}; {len(calls)} batches, "
        f"{n_tokens} token spans well formed and equal to the CPU's on the "
        f"card's logits; wall {wall:.2f} s [{card}]")
    return dict(summary, batches=len(calls), tokens=n_tokens, wall_s=wall)


def run_average_check(card, ckpt, cv_manifest, workdir) -> dict:
    """14e: python -m tpu_asr_torch.average_checkpoints --last
    AVERAGE_LAST on 14b's folder: each floating-point weight equals the
    float32 mean of the loaded steps' cast back (others the newest
    step's); frontend.json kept; recognize --ckpt on the output decodes
    the cv manifest (greedy_ctc)."""
    from tpu_asr_torch import average_checkpoints, recognize
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.train.checkpoints import Checkpointer
    out = os.path.join(workdir, "aishell_pitch_avg")
    t0 = time.perf_counter()
    steps = average_checkpoints.main(["--ckpt", ckpt, "--out", out,
                                      "--last", str(AVERAGE_LAST)])
    wall = time.perf_counter() - t0
    src = Checkpointer(ckpt)
    states = [src.restore(s)["model"] for s in steps]
    got = Checkpointer(out).restore()["model"]
    for k, v in got.items():
        acc = sum(s[k].float() for s in states)
        want = ((acc / torch.full_like(acc, float(len(states)))).to(v.dtype)
                if v.is_floating_point() else states[-1][k])
        if not torch.equal(v, want):
            raise AssertionError(f"average_checkpoints: {k} is not the "
                                 f"mean of steps {steps}")
    frontend = Checkpointer(out).load_frontend()
    summary, _ = run_cli(recognize.main, [
        "--ckpt", out, "--manifest", cv_manifest, "--mode", "greedy_ctc",
        "--output", os.path.join(workdir, "hyp_avg.jsonl")])
    n_cv = len(load_manifest(cv_manifest))
    if len(steps) != AVERAGE_LAST or frontend is None or \
            not frontend.add_pitch or summary["n_utts"] != n_cv:
        raise AssertionError(f"average_checkpoints: steps {steps}, "
                             f"frontend {frontend}, recognize {summary}")
    log(f"14e average_checkpoints --last {AVERAGE_LAST}: steps {steps}, "
        f"{len(got)} tensors the float32 mean, frontend.json kept (add_pitch"
        f"), in {wall:.2f} s; recognize greedy_ctc on it: "
        f"{json.dumps(summary)} [{card}]")
    return {"steps": steps, "wall_s": wall, "recognize": summary}


def run_inputs_phase(card, workdir, data, aishell_stats, cv_manifest):
    """Phase 14: pitch on the card (14a), the aishell preset with --pitch
    trained, decoded and served (14b), the Kaldi ark dump and the
    attention_lfr preset (14c), forced alignment (14d) and checkpoint
    averaging (14e). -> ({"aishell --pitch": training launches}, joint
    prefix-scan launches, {"prefix", "ctc": path timings}, errors)."""
    wall = {"start": time.perf_counter()}

    def lap(part):
        wall[part] = time.perf_counter() - wall["start"] - sum(
            v for k, v in wall.items() if k != "start")
    numbers = {"pitch": check_pitch_on_card(card, data)}
    lap("14a")
    ckpt, launches, prefix_launches, paths, errs, numbers["decode"] = \
        run_pitch_path(card, workdir, data, aishell_stats, cv_manifest)
    lap("14b")
    numbers["lfr"] = run_ark_lfr(card, workdir, data, aishell_stats)
    lap("14c")
    numbers["align"] = run_align_check(card, ckpt, cv_manifest, workdir)
    lap("14d")
    numbers["average"] = run_average_check(card, ckpt, cv_manifest,
                                           workdir)
    lap("14e")
    del wall["start"]
    log("phase 14 wall seconds by part: " + json.dumps(wall))
    return {"aishell --pitch": launches}, prefix_launches, paths, errs


# ---- phase 15: data- and tensor-parallel training and decode ----

# bounds of a 2-rank step against the 1-process step, both bf16 at the
# aishell preset's widths on parallel_batch: each loss (absolute), the
# grad norm (relative) and every gradient, gathered whole
# (grad_tree_gap), set from the readings of run 15-7 (PERF.md) with
# margin. dp read 3.8e-6, 4.4e-7 and 5.0e-3; tp, whose local heads and
# columns change the GEMM shapes and so the bf16 roundings, 2.3e-3,
# 4.8e-4 and 8.1e-2 (a key projection's gradient, a sum that cancels),
# and keeps tests/test_torch_bf16.py's loss and norm bounds. The faults
# of PARALLEL_FAULTS read 0.71, 9.5e-2 and 0.26 (dp) and 8.6e-4, 3.2e-4
# and 0.74 (tp).
PARALLEL_BOUNDS = {
    "dp": {"loss_atol": 1e-3, "grad_norm_rtol": 1e-3, "grad_rtol": 2.5e-2},
    "tp": {"loss_atol": 1e-2, "grad_norm_rtol": 5e-3, "grad_rtol": 0.3}}
GRAD_FLOOR = 1e-3             # grad_tree_gap's floor, a share of |W|
PARALLEL_SCORE_TOL = 1e-5      # 15d: a rank's n-best against its shard's
PARALLEL_TRAIN_UTTS = 32      # 15c: phase 8's first train utterances
PARALLEL_RANKS = 2
PARALLEL_DECODE = ["--mode", "joint", "--beam", "5", "--nbest", "2",
                   "--max-len", "40", "--device", "cuda"]
PARALLEL_LAYOUTS = (          # (key, n_data, n_model, ModelConfig changes)
    ("dp", 2, 1, {}), ("tp", 1, 2, {"use_pallas": True}))
# faults phase 15's bounds must catch (measure_parallel_faults)
PARALLEL_FAULTS = {
    "mean_a_shard": "each rank divides its loss sums by its own shard's "
                    "counts, a mean taken a shard and then averaged",
    "no_sliced_sum": "the model-axis sum of the gradients of the "
                     "replicated parameters read by slice is left out"}
# the capture kinds of record_rank_inputs
RANK_CAPTURES = ("ctc", "flash", "ln", "flash_bwd", "ln_bwd", "prefix")


def parallel_cfg(overrides):
    """The aishell preset's model at full width (vocab 4233, 80-dim
    features), dropout 0, with `overrides`."""
    from tpu_asr_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset(PRESET).model, vocab_size=4233,
                               d_input=80, dropout=0.0, **overrides)


@functools.lru_cache(maxsize=1)
def parallel_weights() -> dict:
    """parallel_cfg's seeded random weights (use_pallas keeps the same
    parameters), made once a process."""
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random
    return init_random(build_model(parallel_cfg({})), SEED).state_dict()


def parallel_batch(b=32, t=1000, u=24):
    """fixed_shape_batch with lengths uneven across the two dp shards, as
    a loader pads a bucket: rows 0 to b/2 - 1 whole (t frames, u
    tokens); the next 3b/8 rows of 2t/5-t frames and 4-u tokens (zero
    features and IGNORE_ID targets past them); the last b/8 rows dummies
    (feat_lengths 0, no targets). The shards hold other frame, token and
    row counts, so a mean taken a shard weighs the rows otherwise than
    the global mean."""
    batch = fixed_shape_batch(b, t, u)
    rng = np.random.default_rng(SEED + 15)
    half, dummies = b // 2, b // 8
    flens, tlens = batch["feat_lengths"], batch["target_lengths"]
    flens[half:] = rng.integers(2 * t // 5, t + 1, b - half)
    tlens[half:] = rng.integers(4, u + 1, b - half)
    flens[b - dummies:] = tlens[b - dummies:] = 0
    for i in range(half, b):
        batch["feats"][i, flens[i]:] = 0.0
        batch["targets"][i, tlens[i]:] = -1
    return batch


def grad_tree_gap(got: dict, want: dict, floor=GRAD_FLOOR) -> dict:
    """Each gradient's L2 distance |g - w| over max(|w|, floor x |W|), W
    the whole tree ({name: tensor}, the same names on both sides): a
    gradient that is 0 in exact arithmetic (a key projection's bias:
    softmax ignores a shift shared by every key) is rounding noise on
    both sides and is measured against the floor. -> {"max", "worst"
    (its name), "top" (the 3 largest: name, gap, |w|, |g - w|),
    "tree_norm": |W|}."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradients {sorted(got.keys() ^ want.keys())}"
                             f" on one side only")
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    tree = sum(v * v for v in norms.values()) ** 0.5
    rows = []
    for name, w in want.items():
        diff = float((got[name].double().to(w.device) - w.double()).norm())
        rows.append((diff / max(norms[name], floor * tree, 1e-30), name,
                     norms[name], diff))
    rows.sort(reverse=True)
    return {"max": rows[0][0], "worst": rows[0][1],
            "top": [[n, g, w, d] for g, n, w, d in rows[:3]],
            "tree_norm": tree}


@contextlib.contextmanager
def record_rank_inputs(caps: dict, path: str):
    """record_inputs of every kernel wrapper a phase-15 path launches,
    into caps[kind] (RANK_CAPTURES): the first CTC backward (its
    forward's inputs and outputs), each kind of flash call and each
    post-norm LN part a T' (PathLabels), the flash and LN backward a
    shape, and the prefix scan's first and LATER_PREFIX_CALL-th call a
    T' (record_prefix_inputs)."""
    from tpu_asr_torch.ops import ctc_loss as ctc_module
    from tpu_asr_torch.ops import flash_attention as fa, layernorm as ln
    labels = PathLabels(path)
    with contextlib.ExitStack() as stack:
        for owner, name, kind, label in (
                (ctc_module, "ctc_loss_bwd", "ctc",
                 lambda *_, **__: f"{path}: first CTC backward"),
                (fa, "flash_attention_fwd", "flash", labels.flash),
                (ln, "layer_norm_residual_fwd", "ln", labels.ln),
                (fa, "flash_attention_bwd", "flash_bwd", flash_bwd_label),
                (ln, "layer_norm_residual_bwd", "ln_bwd", ln_bwd_label)):
            stack.enter_context(record_inputs(
                owner, name, caps.setdefault(kind, {}), label))
        stack.enter_context(record_prefix_inputs(
            caps.setdefault("prefix", {}), labels))
        yield


def rank_kernel_errs(caps: dict, what: str) -> dict:
    """Each kernel against its plain version on the inputs a rank's path
    gave it (record_rank_inputs, after the rank's counts were read),
    within the limits phases 3-14 hold; the CTC forward must give the
    path's nll and alpha bit for bit. -> {kernel name: max abs error}."""
    errs = {}

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)
    for label, args in caps.get("ctc", {}).items():
        at = f"{what}, {label}"
        got, _, err, _ = compare_ctc_fwd(args[:5], at)
        if not (torch.equal(got[0], args[6]) and torch.equal(got[1],
                                                            args[5])):
            raise AssertionError(f"ctc_loss_fwd at {at}: not the bits the "
                                 f"path's forward gave")
        keep("ctc_loss_fwd", err)
        keep("ctc_loss_bwd", compare_ctc_bwd(args[:5], args[5], args[6], at))
    for label, (q, k, v, valid, causal) in caps.get("flash", {}).items():
        keep("flash_attention_fwd", compare_flash(
            q, k, v, valid, causal, f"{what}, {label}")[0])
    for label, (r, h, g, b, _eps) in caps.get("ln", {}).items():
        keep("layer_norm_residual_fwd", compare_ln(r, h, g, b,
                                                   f"{what}, {label}")[0])
    for label, args in caps.get("flash_bwd", {}).items():
        got = compare_flash_bwd(*args, f"{what}, {label}")
        keep("flash_attention_bwd_dq", got["dq"][0])
        keep("flash_attention_bwd_dkv", max(got["dk"][0], got["dv"][0]))
    for label, args in caps.get("ln_bwd", {}).items():
        keep("layer_norm_residual_bwd", compare_ln_bwd(
            *args, f"{what}, {label}")[0])
    check_prefix_labels(caps.get("prefix", {}), what)
    for label, args in caps.get("prefix", {}).items():
        keep("ctc_prefix_scan", compare_prefix(list(args),
                                               f"{what}, {label}"))
    return errs


def parallel_step(card, what, overrides, mesh=None, nccl=False,
                  grads_path=None):
    """One TrainStep of the parallel_cfg model (seeded random weights) on
    parallel_batch (every rank of `mesh` with the same host batch) ->
    {"metrics", "launches" (the kernels that step launched), "stats"
    ({"device_ms", "busy_share", "peak_gib"} of a second step under
    torch.profiler; with `nccl`, also the NCCL ops and kernels that step
    ran), "kernel_errs" (each kernel of the step against its plain
    version on its inputs there), "grad_gap" (under a mesh: the
    gathered gradients against those that the 1-process step saved to
    grads_path, grad_tree_gap)}. Without a mesh the step's gradients
    are saved to grads_path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tpu_asr_torch.train import NoamAdam, TrainStep
    from tpu_asr_torch.models import build_model
    cfg = parallel_cfg(overrides)
    model = build_model(cfg)
    model.load_state_dict(parallel_weights())
    ts = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model, 100),
                   device=DEVICE, seed=SEED, mesh=mesh)
    batch = parallel_batch()
    grads = []
    update = ts.optimizer.update

    def keep_grads(g, norm=None):
        if not grads:
            grads.extend(t.detach().clone() for t in g)
        return update(g, norm)
    ts.optimizer.update = keep_grads
    counters = kernel_counters()
    caps = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: f.launches for k, f in counters.items()}
    with record_rank_inputs(caps, what):
        metrics = {k: float(v) for k, v in ts(batch).items()}
    torch.cuda.synchronize()
    out = {"metrics": metrics,
           "launches": {k: f.launches - before[k] for k, f in
                        counters.items() if f.launches > before[k]}}
    names = {id(p): n for n, p in model.named_parameters()}
    by_name = {names[id(p)]: g for p, g in zip(ts.optimizer.params, grads)}
    if mesh is not None and mesh.n_model > 1:
        by_name = {n: g if ts.specs[n] is None else
                   mesh.model.all_gather(g, ts.specs[n])
                   for n, g in by_name.items()}
    if mesh is None:
        torch.save({n: g.cpu() for n, g in by_name.items()}, grads_path)
    else:
        out["grad_gap"] = grad_tree_gap(by_name, torch.load(
            grads_path, map_location=DEVICE))
    del grads[:], by_name
    prof = profile_device(lambda: ts(batch), what, card)
    out["stats"] = {"device_ms": prof["device_ms"],
                    "busy_share": prof["device_ms"] / prof["wall_ms"],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if nccl:      # NCCL makes a 1-rank sum a device copy, not a kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            ts(batch)
            torch.cuda.synchronize()
        ops = [e for e in p.key_averages() if "nccl" in e.key.lower()]
        out["stats"]["nccl_ops"] = {e.key: e.count for e in ops
                                    if e.device_type == DeviceType.CPU}
        out["stats"]["nccl_kernels"] = {e.key: e.count for e in ops
                                        if e.device_type == DeviceType.CUDA}
    del ts, model
    torch.cuda.empty_cache()
    out["kernel_errs"] = rank_kernel_errs(caps, what)
    return out


def parallel_rank(out_dir: str, card: str) -> None:
    """One of PARALLEL_RANKS ranks sharing the card (spawn_ranks): a step
    on each layout of PARALLEL_LAYOUTS, held against the 1-process
    step's gradients in out_dir/single_<layout>.pt; writes what
    parallel_step gives to out_dir/rank<r>.pt."""
    from tpu_asr_torch.parallel import initialize_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(DEVICE)
    rank = int(os.environ["PROCESS_ID"])
    out = {}
    for key, n_data, n_model, overrides in PARALLEL_LAYOUTS:
        mesh = make_mesh(n_data, n_model)
        out[key] = parallel_step(
            card, f"{PRESET} {key} {n_data}x{n_model} rank {rank}",
            overrides, mesh,
            grads_path=os.path.join(out_dir, f"single_{key}.pt"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def counted_rank(target: str, argv: list, out_dir: str) -> None:
    """One rank of a CLI on several ranks (spawn_ranks: what its --dp or
    --num-devices launch runs): target(argv) with the card set as main()
    sets it and its standard output captured, the kernels' inputs
    recorded (record_rank_inputs) and then held against their plain
    versions (rank_kernel_errs); writes the rank's kernel launches, its
    output and those errors to out_dir/rank<r>.json."""
    import importlib
    import io
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    rank = int(os.environ["PROCESS_ID"])
    what = f"{name} rank {rank}"
    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    buf = io.StringIO()
    caps = {}
    with contextlib.redirect_stdout(buf), record_rank_inputs(caps, what):
        fn(argv)
    launches = {k: c.launches - before[k] for k, c in counters.items()
                if c.launches > before[k]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": launches, "stdout": buf.getvalue(),
                   "kernel_errs": rank_kernel_errs(caps, what)}, f)


def spawn_counted(target: str, argv: list, out_dir: str) -> list[dict]:
    """target(argv) on PARALLEL_RANKS ranks of this host (counted_rank)
    -> each rank's {"launches", "stdout", "kernel_errs"}."""
    from tpu_asr_torch.parallel.mesh import spawn_ranks
    os.makedirs(out_dir, exist_ok=True)
    spawn_ranks("chip_smoke:counted_rank", PARALLEL_RANKS, target, argv,
                out_dir)
    out = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def parallel_gaps(got: dict, want: dict) -> dict:
    """A mesh step's global metrics against the 1-process step's: each
    loss's absolute gap and the grad norm's relative one."""
    gaps = {k: abs(got[k] - want[k]) for k in want if k.startswith("loss")}
    gaps["grad_norm_rel"] = abs(got["grad_norm"] - want["grad_norm"]) / \
        want["grad_norm"]
    return gaps


def compare_parallel_step(what, got, want, bounds, grad_gap=None):
    """A mesh step's metrics (and its gradients' grad_tree_gap) against
    the 1-process step's, within `bounds` (PARALLEL_BOUNDS); the error
    names the bounds exceeded. -> the gaps."""
    gaps = parallel_gaps(got, want)
    if grad_gap is not None:
        gaps["grad_rel"], gaps["grad_worst"] = grad_gap["max"], \
            grad_gap["worst"]
    over = [name for name, gap in (
        ("loss_atol", max(v for k, v in gaps.items() if k.startswith("loss"))),
        ("grad_norm_rtol", gaps["grad_norm_rel"]),
        ("grad_rtol", gaps.get("grad_rel", 0.0))) if gap > bounds[name]]
    if over or not np.isfinite(list(got.values())).all():
        raise AssertionError(f"{what}: {got} against the 1-process step "
                             f"{want}: gaps {gaps} exceed {over} of "
                             f"{bounds}")
    return gaps


def check_parallel_launches(what, launches, cfg):
    """A layout's step on each rank: the CTC pair once; under use_pallas
    the flash forward, dq and dk/dv once per full-pass attention (on
    this rank's heads) and the LN pair once per post-norm call of >= 512
    rows (parallel_batch: 32 x 249 encoder rows, 32 x 25 decoder rows,
    all of them)."""
    n_attn = cfg.num_enc_layers + 2 * cfg.num_dec_layers
    n_ln = 2 * cfg.num_enc_layers + 3 * cfg.num_dec_layers
    want = {"ctc_loss_fwd": 1, "ctc_loss_bwd": 1}
    if cfg.use_pallas:
        want.update({k: n_attn for k in ("flash_attention_fwd",
                                          "flash_attention_bwd_dq",
                                          "flash_attention_bwd_dkv")},
                    layer_norm_residual_fwd=n_ln,
                    layer_norm_residual_bwd=n_ln)
    check_launches(what, launches, want)


def parallel_training(card, workdir, fault=None):
    """15a and 15b: the aishell-width step on 2 ranks sharing the card
    (gloo) as dp 2 and, with use_pallas, as tp 2, each against the same
    step in this process (metrics and every gradient); and the
    1-process step through a 1-rank NCCL group. Every gap is logged
    before any is held to its bound. `fault` (PARALLEL_FAULTS) is
    injected into the ranks. -> ({layout: [each rank's launches]},
    {layout: [each rank's kernel errors]})."""
    import torch.distributed as dist
    from tpu_asr_torch.parallel import make_mesh
    from tpu_asr_torch.parallel.mesh import free_port, spawn_ranks
    out_dir = os.path.join(workdir, "parallel_ranks")
    os.makedirs(out_dir)
    single = {key: parallel_step(
        card, f"{PRESET} {key} 1 process", overrides,
        grads_path=os.path.join(out_dir, f"single_{key}.pt"))
        for key, _, _, overrides in PARALLEL_LAYOUTS}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        nccl = parallel_step(card, f"{PRESET} 1-rank nccl", {},
                             make_mesh(1, 1), nccl=True,
                             grads_path=os.path.join(out_dir,
                                                     "single_dp.pt"))
    finally:
        dist.destroy_process_group()
    if fault is None:
        spawn_ranks("chip_smoke:parallel_rank", PARALLEL_RANKS, out_dir,
                    card)
    else:
        spawn_ranks("chip_smoke:fault_rank", PARALLEL_RANKS, fault, out_dir,
                    card)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(PARALLEL_RANKS)]
    numbers = {"nccl": dict(parallel_gaps(nccl["metrics"],
                                          single["dp"]["metrics"]),
                            grad_gap=nccl["grad_gap"], **nccl["stats"])}
    for key, n_data, n_model, _ in PARALLEL_LAYOUTS:
        numbers[key] = {
            "single": single[key]["metrics"], "mesh": ranks[0][key]["metrics"],
            "gaps": [dict(parallel_gaps(g[key]["metrics"],
                                        single[key]["metrics"]),
                          grad_gap=g[key]["grad_gap"]) for g in ranks],
            "single_step": single[key]["stats"],
            "rank_steps": [g[key]["stats"] for g in ranks],
            "launches": [g[key]["launches"] for g in ranks],
            "kernel_errs": [g[key]["kernel_errs"] for g in ranks]}
        log(f"{PRESET} {key} {n_data}x{n_model} (gloo, {PARALLEL_RANKS} "
            f"ranks on one card): {json.dumps(numbers[key])} [{card}]")
    log(f"{PRESET} through a 1-rank NCCL group: {json.dumps(numbers['nccl'])}"
        f" [{card}]")
    if not nccl["stats"]["nccl_ops"]:
        raise AssertionError("the 1-rank NCCL step ran no NCCL collective")
    compare_parallel_step("1-rank nccl", nccl["metrics"],
                          single["dp"]["metrics"], PARALLEL_BOUNDS["dp"],
                          nccl["grad_gap"])
    launches, errs = {}, {}
    for key, n_data, n_model, overrides in PARALLEL_LAYOUTS:
        cfg = parallel_cfg(overrides)
        what = f"{PRESET} {key} {n_data}x{n_model}"
        for r, got in enumerate(ranks):
            check_parallel_launches(f"{what} rank {r}", got[key]["launches"],
                                    cfg)
            if got[key]["metrics"] != ranks[0][key]["metrics"]:
                raise AssertionError(f"{what}: ranks report other metrics "
                                     f"{numbers[key]['mesh']}")
            compare_parallel_step(f"{what} rank {r}", got[key]["metrics"],
                                  single[key]["metrics"],
                                  PARALLEL_BOUNDS[key], got[key]["grad_gap"])
            if set(got[key]["kernel_errs"]) != set(got[key]["launches"]):
                raise AssertionError(
                    f"{what} rank {r}: launched {sorted(got[key]['launches'])}"
                    f", held {sorted(got[key]['kernel_errs'])}")
        launches[key] = numbers[key]["launches"]
        errs[key] = numbers[key]["kernel_errs"]
    return launches, errs


def inject_fault(fault: str) -> None:
    """Break this process's train step as PARALLEL_FAULTS[fault] says."""
    from tpu_asr_torch.train import loop
    if fault == "no_sliced_sum":
        loop.sliced_params = lambda model: set()
        return
    call, counts = loop.TrainStep.__call__, loop.global_counts

    def with_shard_counts(self, batch):
        mesh = self.mesh

        def shard_counts(whole, frontend, device):
            flens, _ = counts(whole, frontend, device)
            _, own = counts(loop.shard_batch(whole, mesh), frontend, device)
            return flens, {k: v * mesh.n_data for k, v in own.items()}
        loop.global_counts = counts if mesh is None else shard_counts
        try:
            return call(self, batch)
        finally:
            loop.global_counts = counts
    loop.TrainStep.__call__ = with_shard_counts


def fault_rank(fault: str, out_dir: str, card: str) -> None:
    """parallel_rank with `fault` injected (spawn_ranks)."""
    inject_fault(fault)
    parallel_rank(out_dir, card)


def measure_parallel_faults(card) -> int:
    """python3 chip_smoke.py --parallel-faults: 15a and 15b once with each
    fault of PARALLEL_FAULTS injected into the ranks; each must exceed a
    bound of PARALLEL_BOUNDS. -> 0 when every fault was caught."""
    missed = []
    for fault, what in PARALLEL_FAULTS.items():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            try:
                parallel_training(card, workdir, fault)
            except AssertionError as e:
                log(f"fault {fault} ({what}) caught: {e}")
                continue
        log(f"fault {fault} ({what}) NOT caught")
        missed.append(fault)
    log(f"parallel faults missed: {missed} [{card}]")
    return 1 if missed else 0


def parallel_trainer(card, workdir, data, cv_manifest):
    """15c: `python -m tpu_asr_torch.train --num-devices 2` (its ranks run
    through counted_rank) with the aishell preset on phase 8's first
    PARALLEL_TRAIN_UTTS train utterances for 2 epochs: one metrics file
    with a cv line an epoch and the checkpoints, from rank 0 alone, and
    the last checkpoint loads into one process's model. -> (each rank's
    launches, each rank's kernel errors, the checkpoint folder)."""
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.train.checkpoints import Checkpointer
    train_utts, _, _, waves = data
    manifest = write_wav_manifest(train_utts[:PARALLEL_TRAIN_UTTS], waves,
                                  os.path.join(workdir, "parallel_train"))
    save = os.path.join(workdir, "parallel_exp")
    ranks = spawn_counted(
        "tpu_asr_torch.train.__main__:train",
        ["--preset", PRESET, "--train-manifest", manifest, "--cv-manifest",
         cv_manifest, "--vocab-size", "4233", "--epochs", "2",
         "--num-devices", str(PARALLEL_RANKS), "--save-folder", save],
        os.path.join(workdir, "parallel_train_ranks"))
    with open(os.path.join(save, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    history = [m for m in lines if m.get("phase") == "cv"]
    ck = Checkpointer(save)
    if [m["epoch"] for m in history] != [0, 1] or \
            len(ck.all_steps()) != 2:
        raise AssertionError(f"--num-devices 2: cv lines {history}, "
                             f"checkpoints {ck.all_steps()}")
    model = build_model(ck.load_config())
    model.load_state_dict(ck.restore()["model"])
    launches = [r["launches"] for r in ranks]
    errs = [r["kernel_errs"] for r in ranks]
    steps = history[-1]["step"]
    for r, got in enumerate(launches):
        if got.get("ctc_loss_bwd") != steps or not got.get("ctc_loss_fwd") \
                or set(errs[r]) != set(got):
            raise AssertionError(f"--num-devices 2 rank {r}: launches {got}"
                                 f" for {steps} steps, held {errs[r]}")
    log(f"{PRESET} train --num-devices {PARALLEL_RANKS} (gloo, one card): "
        f"{steps} steps, cv {json.dumps(history)}; checkpoint step "
        f"{ck.latest_step()} loads into one process; launches by rank "
        f"{json.dumps(launches)}; kernels against their plain versions on "
        f"each rank's inputs {json.dumps(errs)} [{card}]")
    return launches, errs, save


def compare_shard_hyps(want: dict, got: dict) -> float:
    """recognize --dp's hypothesis lines ({id: line with "hyp_tokens" and
    "nbest"}, `got`) against one process's decode of the same shards
    (`want`): the same ids, the 1-best equal and every n-best score
    within PARALLEL_SCORE_TOL. -> the largest score gap."""
    if set(want) != set(got):
        raise AssertionError(f"--dp ids {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for uid, h in want.items():
        g = got[uid]
        gaps = [abs(a["score"] - b["score"])
                for a, b in zip(g["nbest"], h["nbest"])]
        worst = max([worst] + gaps)
        if g["hyp_tokens"] != h["hyp_tokens"] or len(g["nbest"]) != len(
                h["nbest"]) or max(gaps) > PARALLEL_SCORE_TOL:
            raise AssertionError(f"recognize --dp {uid}: {g['nbest']} vs "
                                 f"its shard in one process {h['nbest']}")
    return worst


def shard_decodes(argv: list) -> dict:
    """recognize's Recognizer and batches for `argv` (its bucket sizes
    multiples of PARALLEL_RANKS, as --dp makes them) in this process,
    each batch cut into the ranks' shards at its padded shape and each
    shard decoded alone: what each rank of --dp decodes, with the same
    GEMM shapes. -> {id: a hypothesis line as recognize writes it}."""
    from tpu_asr_torch import recognize
    from tpu_asr_torch.parallel.mesh import Axis, Mesh, shard_batch
    rec, _, loader, _, _ = recognize.build(
        recognize.parse_args(argv), torch.device(DEVICE),
        world=PARALLEL_RANKS)
    batches = list(loader())
    out = {}
    for r in range(PARALLEL_RANKS):
        mesh = Mesh(PARALLEL_RANKS, 1, r, Axis(None, PARALLEL_RANKS, r),
                    Axis(None, 1, 0))
        nbests = rec.decode_batches_nbest(shard_batch(b, mesh)
                                          for b in batches)
        for batch, nb in zip(batches, nbests):
            rows = range(len(batch["ids"]))[r * len(nb): (r + 1) * len(nb)]
            out.update({batch["ids"][i]: {"hyp_tokens": nb[i - rows.start][0]
                                          ["yseq"],
                                          "nbest": nb[i - rows.start]}
                        for i in rows})
    return out


def parallel_decode(card, workdir, ckpt, cv_manifest):
    """15d: recognize --dp 2 in joint beam 5 (its ranks through
    counted_rank) on a checkpoint of the aishell preset (bf16) and the cv
    manifest, against one process decoding each rank's shards alone at
    their padded shapes (shard_decodes): the 1-best equal and the scores
    within PARALLEL_SCORE_TOL. recognize in one process on the whole
    batches gives the inverse RTF beside --dp's and how many 1-bests the
    two share (bf16 rows of a half batch round otherwise than in the
    whole one; a reading, not a check). -> (each rank's prefix-scan
    launches, each rank's kernel errors)."""
    from tpu_asr_torch import recognize
    argv = ["--ckpt", ckpt, "--manifest", cv_manifest] + PARALLEL_DECODE
    one_out = os.path.join(workdir, "hyp_one.jsonl")
    counters = kernel_counters()
    before = counters["ctc_prefix_scan"].launches
    _, one = run_cli(recognize.main, argv + ["--output", one_out])
    one_launches = counters["ctc_prefix_scan"].launches - before
    dp_out = os.path.join(workdir, "hyp_dp.jsonl")
    ranks = spawn_counted("tpu_asr_torch.recognize:decode",
                          argv + ["--output", dp_out, "--dp",
                                  str(PARALLEL_RANKS)],
                          os.path.join(workdir, "parallel_decode_ranks"))
    summary = last_json_line(ranks[0]["stdout"])
    if ranks[1]["stdout"].strip():
        raise AssertionError(f"recognize --dp rank 1 printed "
                             f"{ranks[1]['stdout']!r}")

    def read(path):
        with open(path) as f:
            return {h["id"]: h for h in map(json.loads, f)}
    whole, got = read(one_out), read(dp_out)
    if summary["n_utts"] != len(whole):
        raise AssertionError(f"--dp summary {summary}, {len(whole)} utts")
    worst = compare_shard_hyps(shard_decodes(argv), got)
    launches = [r["launches"].get("ctc_prefix_scan", 0) for r in ranks]
    errs = [r["kernel_errs"] for r in ranks]
    if not all(launches) or not one_launches or \
            not all("ctc_prefix_scan" in e for e in errs):
        raise AssertionError(f"joint --dp: prefix-scan launches {launches},"
                             f" one process {one_launches}, held {errs}")
    numbers = {"n_utts": len(whole), "max_score_gap_to_shards": worst,
               "one_best_equal_to_whole_batch": sum(
                   got[u]["hyp_tokens"] == h["hyp_tokens"]
                   for u, h in whole.items()),
               "dp_summary": summary, "one_summary": one,
               "one_process_launches": one_launches}
    log(f"recognize --dp {PARALLEL_RANKS} joint beam 5 (bf16): "
        f"{json.dumps(numbers)}; prefix-scan launches by rank {launches}; "
        f"kernels against their plain versions on each rank's inputs "
        f"{json.dumps(errs)} [{card}]")
    return launches, errs


def rank_sum(per_rank: list[dict]) -> dict:
    """Each kernel's launches summed over the ranks."""
    out = {}
    for launches in per_rank:
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def rank_max(per_rank: list[dict]) -> dict:
    """Each kernel's largest error over the ranks."""
    out = {}
    for errs in per_rank:
        for k, v in errs.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def run_parallel_phase(card, workdir, data, ckpt, cv_manifest):
    """Phase 15: data- and tensor-parallel training (15a, 15b), the
    trainer's --num-devices (15c) and recognize --dp (15d) on phase 8's
    aishell checkpoint `ckpt`. -> (launches {"dp"|"tp"|"trainer"|"decode":
    per rank}, {kernel name: its largest error on the phase's inputs
    over every rank})."""
    wall = {}
    t0 = time.perf_counter()
    launches, errs = parallel_training(card, workdir)
    wall["15ab"] = time.perf_counter() - t0
    launches["trainer"], errs["trainer"], _ = parallel_trainer(
        card, workdir, data, cv_manifest)
    wall["15c"] = time.perf_counter() - t0 - wall["15ab"]
    launches["decode"], errs["decode"] = parallel_decode(card, workdir, ckpt,
                                                         cv_manifest)
    wall["15d"] = time.perf_counter() - t0 - wall["15ab"] - wall["15c"]
    log("phase 15 wall seconds by part: " + json.dumps(wall))
    return launches, rank_max([e for per_rank in errs.values()
                               for e in per_rank])


# ---- phase 16: checkpoints in and out, and the recipe as users run it ----

EXPORT_DECODE = ["--mode", "joint", "--beam", "5", "--nbest", "2",
                 "--max-len", "40"]
EXPORT_PATH = "aishell joint, --torch-ckpt and --ckpt (recognize)"
# egs_torch/aishell/run.sh as a user runs it, stages -1 to 4, with the
# preset, synthetic corpus and epochs with which its model learns the tone
# corpus within the phase's time (PERF.md)
RECIPE_SCRIPT = os.path.join("egs_torch", "aishell", "run.sh")
RECIPE_SCRIPT_PRESET = "conformer_dev"
RECIPE_SCRIPT_UTTS = 1600
RECIPE_SCRIPT_EPOCHS = 20
RECIPE_SCRIPT_TIMEOUT = 600
RECIPE_SCRIPT_PATH = "egs_torch/aishell/run.sh"


def alias_fixture(sd: dict) -> dict:
    """A reference state_dict as export_torch writes it, renamed to the
    other spellings KEY_ALIASES reads: a DataParallel `module.` head, a
    `model.` head on the encoder and decoder, the conv front end as
    encoder.conv.conv_<i> and encoder.conv.linear_out, the CTC head as a
    bare ctc_lo."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^encoder\.subsample\.conv([12])\.",
                   r"encoder.conv.conv_\1.", k)
        k = re.sub(r"^encoder\.subsample\.out\.", "encoder.conv.linear_out.",
                   k)
        k = re.sub(r"^ctc\.ctc_lo\.", "ctc_lo.", k)
        k = re.sub(r"^(encoder|decoder)\.", r"model.\1.", k)
        out[f"module.{k}"] = v
    return out


def aliases_fired(keys) -> set:
    """The indices of the KEY_ALIASES rules that rename some key of
    `keys`, applied in order as the importer applies them."""
    from tpu_asr_torch.parity.torch_import import KEY_ALIASES
    fired = set()
    for k in keys:
        for i, (pat, repl) in enumerate(KEY_ALIASES):
            k, n = re.subn(pat, repl, k)
            if n:
                fired.add(i)
    return fired


def same_hyp_files(got_path: str, want_path: str) -> int:
    """Two hypothesis JSONL files equal line for line, scores included,
    bit for bit (a float prints its shortest round-trip form) -> the
    number of lines; raises at the first line that differs."""
    with open(got_path) as f:
        got = f.read().splitlines()
    with open(want_path) as f:
        want = f.read().splitlines()
    if len(got) != len(want):
        raise AssertionError(f"{got_path}: {len(got)} lines, {want_path}: "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            raise AssertionError(f"line {i}: {a} != {b}")
    return len(want)


def model_logits(model, cfg, feats, flens, ys) -> dict:
    """The encoder's CTC logits and the teacher-forced decoder logits
    (those the model has) of one batch on the model's device."""
    model.eval()
    out = {}
    with torch.no_grad():
        enc, el = model.encode(feats, flens)
        if cfg.model_type in ("ctc", "hybrid"):
            out["ctc"] = model.ctc_logits(enc)
        if cfg.num_dec_layers > 0:
            out["decoder"] = model.decode_logits(enc, el, ys)
    return out


def check_alias_fixtures(card, pth: str, workdir: str) -> dict:
    """16a's fixtures, imported on the card by load_torch_model with the
    config inferred: alias_fixture of the exported file, and a
    full-width untied linear-input hybrid (attention_lfr's widths, vocab
    4233, random weights from the seed) exported and renamed with a
    `model.` head, as a bare state_dict. Each gives the logits of the
    file it came from bit for bit, and the three key sets fire every
    KEY_ALIASES rule. -> {fixture: number of tensors}."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.parity.torch_export import export_model
    from tpu_asr_torch.parity.torch_import import (KEY_ALIASES,
                                                   load_torch_model)
    from tpu_asr_torch.weights import init_random

    blob = torch.load(pth, map_location="cpu", weights_only=True)
    lfr_cfg = dataclasses.replace(get_preset("attention_lfr").model,
                                  model_type="hybrid", vocab_size=4233,
                                  tie_embedding=False)
    lfr_pth = os.path.join(workdir, "lfr_untied.pth.tar")
    export_model(lfr_pth, init_random(build_model(lfr_cfg), SEED), lfr_cfg)
    lfr_sd = torch.load(lfr_pth, map_location="cpu",
                        weights_only=True)["state_dict"]
    fixtures = {
        "aliases of the export": (pth, dict(blob, state_dict=alias_fixture(
            blob["state_dict"]))),
        "untied linear-input, model. head, bare state_dict": (
            lfr_pth, {f"model.{k}" if k.startswith(("encoder.", "decoder."))
                      else k: v for k, v in lfr_sd.items()})}
    fired = aliases_fired(blob["state_dict"])
    gen = torch.Generator().manual_seed(SEED + 16)
    out = {}
    for name, (source, fixture) in fixtures.items():
        fired |= aliases_fired(fixture["state_dict"] if "state_dict" in
                               fixture else fixture)
        path = os.path.join(workdir, "fixture.pth.tar")
        torch.save(fixture, path)
        want_model, cfg = load_torch_model(source)
        got_model, got_cfg = load_torch_model(path)
        if got_cfg != cfg:
            raise AssertionError(f"{name}: config {got_cfg} != {cfg}")
        t = 200
        feats = torch.randn(2, t, cfg.encoder_input_dim, generator=gen)
        flens = torch.tensor([t, t * 3 // 4])
        ys = torch.randint(2, cfg.vocab_size - 2, (2, 12), generator=gen)
        args = [x.to(DEVICE) for x in (feats, flens, ys)]
        want = model_logits(want_model.to(DEVICE), cfg, *args)
        got = model_logits(got_model.to(DEVICE), cfg, *args)
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"{name}: {k} logits differ by "
                                     f"{(got[k] - want[k]).abs().max()}")
        out[name] = len(got_model.state_dict())
        shapes = {k: list(v.shape) for k, v in want.items()}
        log(f"16a fixture {name}: {out[name]} tensors, logits "
            f"{json.dumps(shapes)} equal to {os.path.basename(source)}'s "
            f"bit for bit [{card}]")
    if fired != set(range(len(KEY_ALIASES))):
        raise AssertionError(f"the fixtures fire KEY_ALIASES rules "
                             f"{sorted(fired)} of {len(KEY_ALIASES)}")
    return out


def run_export_check(card, workdir, ckpt, cv_manifest, n_cv):
    """16a: `python -m tpu_asr_torch.export_torch` on phase 8's aishell
    checkpoint; `recognize --torch-ckpt <file> --ckpt <folder>` and
    `recognize --ckpt <folder>` in joint beam 5 (n-best 2) on the cv
    manifest (run_recipe_decodes: ctc_prefix_scan once a decoder step),
    their hypothesis files equal bit for bit, scores included; the
    --torch-ckpt decode's prefix-scan calls against the plain version;
    check_alias_fixtures. -> (prefix launches, {label: prefix timings},
    max abs error)."""
    from tpu_asr_torch import export_torch
    out_dir = os.path.join(workdir, "aishell_export")
    os.makedirs(out_dir, exist_ok=True)
    pth = os.path.join(out_dir, "final.pth.tar")
    t0 = time.perf_counter()
    step = export_torch.main(["--ckpt", ckpt, "--out", pth])
    export_s = time.perf_counter() - t0
    summaries, launches, caps = run_recipe_decodes(
        card, ckpt, cv_manifest, n_cv, out_dir,
        decodes=(("torch_ckpt_joint", EXPORT_DECODE + ["--torch-ckpt", pth]),
                 ("ckpt_joint", EXPORT_DECODE)),
        path=EXPORT_PATH, what="aishell, exported")
    n = same_hyp_files(os.path.join(out_dir, "hyp_torch_ckpt_joint.jsonl"),
                       os.path.join(out_dir, "hyp_ckpt_joint.jsonl"))
    got, want = summaries["torch_ckpt_joint"], summaries["ckpt_joint"]
    if (got["cer"], got["n_utts"]) != (want["cer"], want["n_utts"]):
        raise AssertionError(f"--torch-ckpt {got} != --ckpt {want}")
    prefix_t, err = check_prefix_on_paths(caps)
    if not prefix_t:
        raise AssertionError("the --torch-ckpt decode recorded no prefix "
                             "scan")
    fixtures = check_alias_fixtures(card, pth, out_dir)
    log(f"16a export_torch of step {step}: {os.path.getsize(pth)} bytes in "
        f"{export_s:.2f} s; --torch-ckpt joint 5 == --ckpt joint 5 on {n} "
        f"utterances, n-best scores bit for bit (cer {got['cer']}); "
        f"ctc_prefix_scan vs plain on {len(prefix_t)} calls of the "
        f"--torch-ckpt path, max abs err {err}; fixtures "
        f"{json.dumps(fixtures)} [{card}]")
    return launches, prefix_t, err


# counted_python's client of fork_server (its socket path formatted in)
FORK_CLIENT = """import json, os, socket, sys, time
env = dict(os.environ, COUNTED_START=str(time.time()))
msg = json.dumps({{"argv": sys.argv[1:], "cwd": os.getcwd(),
                  "env": env}}).encode()
with socket.socket(socket.AF_UNIX) as s:
    s.connect({sock!r})
    socket.send_fds(s, [len(msg).to_bytes(8, "little")], [0, 1, 2])
    s.sendall(msg)
    code = b""
    while len(code) < 4:
        part = s.recv(4 - len(code))
        if not part:
            sys.exit("fork_server: the run ended without an exit code")
        code += part
sys.exit(int.from_bytes(code, "little", signed=True))
"""


def counted_python(workdir: str, sock: str) -> str:
    """An executable for the recipe's $PYTHON: a client of the
    fork_server listening at `sock`, which runs the client's arguments
    as the interpreter would, in a process forked from the server, with
    the client's working directory, environment and standard streams;
    the client exits with that run's code. -> its path."""
    path = os.path.join(workdir, "counted_python")
    with open(path, "w") as f:
        f.write(f"#!{sys.executable}\n" + FORK_CLIENT.format(sock=sock))
    os.chmod(path, 0o755)
    return path


def forked_run(out_dir: str, request: dict) -> int:
    """One client request in a child of fork_server: its argv as the
    interpreter takes it: `-m <module> ...` through counted_cli, `-c
    <command> ...`, `- ...` (a script on standard input). -> the exit
    code."""
    import traceback
    os.chdir(request["cwd"])
    os.environ.clear()
    os.environ.update(request["env"])
    argv = request["argv"]
    try:
        if argv[:1] == ["-m"]:
            return counted_cli(out_dir, argv)
        if argv[:1] == ["-c"]:
            sys.argv, source, name = ["-c"] + argv[2:], argv[1], "<string>"
        elif argv[:1] == ["-"]:
            sys.argv, source, name = argv, sys.stdin.read(), "<stdin>"
        else:
            raise SystemExit(f"fork_server: cannot run {argv[:1]}")
        exec(compile(source, name, "exec"), {"__name__": "__main__"})
        return 0
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
        return e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()


def fork_server(sock: str, out_dir: str) -> None:
    """`python3 chip_smoke.py --fork-server <socket> <out_dir>`: import
    torch and the recipe's CLIs once, then for each client of
    counted_python fork a child that runs its request (forked_run) and
    sends back the exit code. The server never touches CUDA and runs a
    single thread (checked before each fork), so each child sets the
    card up itself, as a process of its own would; what the fork saves
    is the import of torch and the port, ~9 s a process on the card's
    host (PERF.md)."""
    import signal
    import socket
    import tpu_asr_torch.compute_cmvn  # noqa: F401 (imported once, here)
    import tpu_asr_torch.data.synthetic  # noqa: F401
    import tpu_asr_torch.prepare_data  # noqa: F401
    import tpu_asr_torch.recognize  # noqa: F401
    import tpu_asr_torch.train.__main__  # noqa: F401
    from tpu_asr_torch.models.decoder import Decoder  # noqa: F401
    kernel_counters()
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)    # children reaped
    with socket.socket(socket.AF_UNIX) as srv:
        srv.bind(sock)
        srv.listen(16)
        while True:
            conn, _ = srv.accept()
            head, fds, _, _ = socket.recv_fds(conn, 8, 3)
            size, msg = int.from_bytes(head, "little"), b""
            while len(msg) < size:
                msg += conn.recv(size - len(msg))
            sys.stdout.flush()
            sys.stderr.flush()
            if threading.active_count() != 1:      # fork copies one thread
                raise RuntimeError(f"fork_server has "
                                   f"{threading.active_count()} threads")
            if os.fork() == 0:
                signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                srv.close()
                for i, fd in enumerate(fds):
                    os.dup2(fd, i)
                    os.close(fd)
                code = forked_run(out_dir, json.loads(msg))
                conn.sendall(code.to_bytes(4, "little", signed=True))
                os._exit(0)
            for fd in fds:
                os.close(fd)
            conn.close()


@contextlib.contextmanager
def fork_server_running(out_dir: str):
    """A fork_server process while this runs (stopped after) -> the path
    of its counted_python client."""
    import shutil
    sock_dir = tempfile.mkdtemp(prefix="cs")
    sock = os.path.join(sock_dir, "s")
    server = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--fork-server", sock, out_dir])
    try:
        t0 = time.perf_counter()
        while not os.path.exists(sock):
            if server.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError(f"fork_server did not start "
                                     f"({server.poll()})")
            time.sleep(0.1)
        yield counted_python(sock_dir, sock)
    finally:
        server.kill()
        server.wait()
        shutil.rmtree(sock_dir, ignore_errors=True)


def counted_cli(out_dir: str, argv: list) -> int:
    """argv `-m <module> <args>`: the module as `python -m` runs it (a
    child of fork_server runs it so), each kernel's launches counted
    from 0 and its inputs recorded (record_rank_inputs), the decoder
    steps counted; then the recorded calls against their plain versions
    (rank_kernel_errs). Writes {"module", "argv", "exit", "launches",
    "decoder_steps", "kernel_errs", "wall_s" (the module's run),
    "start_s" (from $COUNTED_START, counted_python's clock at its
    start, to the module's run)} to <out_dir>/<pid>.json. -> the module's
    exit code."""
    import runpy
    module, args = argv[1], argv[2:]
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    steps = [0]
    caps, code, exit_ = {}, 0, None
    sys.argv = [module] + args
    start = time.time() - float(os.environ.get("COUNTED_START", time.time()))
    t0 = time.perf_counter()
    with record_rank_inputs(caps, f"{RECIPE_SCRIPT_PATH} {module}"), \
            count_beam_steps(steps):
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            exit_ = e
            code = e.code if isinstance(e.code, int) else int(
                e.code is not None)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    errs = rank_kernel_errs(caps, module) if code == 0 else {}
    with open(os.path.join(out_dir, f"{os.getpid()}.json"), "w") as f:
        json.dump({"module": module, "argv": args, "exit": code,
                   "launches": launches, "decoder_steps": steps[0],
                   "kernel_errs": errs, "wall_s": wall,
                   "start_s": start}, f)
    if exit_ is not None:
        raise exit_
    return code


@contextlib.contextmanager
def tree_kept(paths):
    """Each of `paths` as it was before: one that exists is moved aside
    while this runs and put back after; what the run makes there is
    removed, with the folders above it that the run made."""
    made, kept = [], {}
    for p in paths:
        parent = os.path.dirname(p)
        while not os.path.exists(parent):
            made.append(parent)
            parent = os.path.dirname(parent)
        if os.path.exists(p):
            kept[p] = f"{p}.chip_smoke_kept"
            os.rename(p, kept[p])
    try:
        yield
    finally:
        import shutil
        for p in paths:
            shutil.rmtree(p, ignore_errors=True)
            if p in kept:
                os.rename(kept[p], p)
        for d in sorted(set(made), key=len, reverse=True):
            if os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def recipe_counts(runs: list, history: list) -> dict:
    """The launches of the recipe's CLI runs (counted_cli's records),
    held to what the recipe must launch: the trainer the CTC forward
    once a step and a cv batch and the backward once a step (`history`:
    metrics.jsonl's cv lines), recognize in joint the prefix scan once a
    decoder step, nothing else anywhere. -> {"training", "joint":
    {kernel: launches}}."""
    steps = sum(h["train_steps"] for h in history)
    cv_batches = sum(h["cv_batches"] for h in history)
    out = {"training": {}, "joint": {}}
    for run in runs:
        got = run["launches"]
        if run["exit"] != 0:
            raise AssertionError(f"{run['module']} exited {run['exit']}")
        if run["module"] == "tpu_asr_torch.train":
            want, key = {"ctc_loss_fwd": steps + cv_batches,
                         "ctc_loss_bwd": steps}, "training"
        elif run["module"] == "tpu_asr_torch.recognize" and \
                run["argv"][run["argv"].index("--mode") + 1] == "joint":
            want, key = {"ctc_prefix_scan": run["decoder_steps"]}, "joint"
        else:
            want, key = {}, None
        check_launches(f"{run['module']} {' '.join(run['argv'])}", got,
                       want)
        if key:
            out[key] = rank_sum([out[key], got])
    if not out["training"] or not out["joint"]:
        raise AssertionError(f"the recipe ran no training or no joint "
                             f"decode: {out}")
    return out


def run_recipe_script(card, workdir):
    """16b: `bash egs_torch/aishell/run.sh --data <workdir> --synthetic
    RECIPE_SCRIPT_UTTS --preset RECIPE_SCRIPT_PRESET --epochs
    RECIPE_SCRIPT_EPOCHS --device cuda` in a process of its own, stages
    -1 to 4 (its CER-vs-beam gate included), exit 0; every `python -m`
    it starts counted (counted_python, recipe_counts); data/aishell and
    the exp folder as they were before. -> (launches {"training",
    "joint"}, {kernel: max abs error} of the recorded calls, the
    recipe's summaries)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    exp = os.path.join(repo, "exp", f"aishell_torch_{RECIPE_SCRIPT_PRESET}")
    counts = os.path.join(workdir, "recipe_counts")
    os.makedirs(counts, exist_ok=True)
    cmd = ["bash", os.path.join(repo, RECIPE_SCRIPT), "--data",
           os.path.join(workdir, "recipe_corpus"), "--synthetic",
           str(RECIPE_SCRIPT_UTTS), "--preset", RECIPE_SCRIPT_PRESET,
           "--epochs", str(RECIPE_SCRIPT_EPOCHS), "--device", DEVICE]
    with tree_kept([os.path.join(repo, "data", "aishell"), exp]), \
            fork_server_running(counts) as python:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=repo, env=dict(os.environ,
                                                      PYTHON=python),
                              capture_output=True, text=True,
                              timeout=RECIPE_SCRIPT_TIMEOUT)
        wall = time.perf_counter() - t0
        with open(os.path.join(workdir, "recipe_script.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(cmd)} exited "
                                 f"{proc.returncode} after {wall:.1f} s:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        summaries = {
            "decode": read_jsonl(os.path.join(exp, "decode_summary.json"))[-1],
            "joint": read_jsonl(os.path.join(
                exp, "decode_summary_joint.json"))[-1],
            "cer_vs_beam": read_jsonl(os.path.join(exp, "cer_vs_beam.jsonl"))}
        history = [h for h in read_jsonl(os.path.join(exp, "metrics.jsonl"))
                   if h.get("phase") == "cv"]
    runs = [json.load(open(os.path.join(counts, f)))
            for f in sorted(os.listdir(counts))]
    launches = recipe_counts(runs, history)
    errs = rank_max([r["kernel_errs"] for r in runs])
    cli_wall = {}
    for r in runs:
        for key in (r["module"], "starting them"):
            cli_wall[key] = cli_wall.get(key, 0.0) + (
                r["wall_s"] if key == r["module"] else r["start_s"])
    log(f"16b {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s, {len(runs)} "
        f"`python -m` runs; train {len(history)} epochs, cv loss "
        f"{history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}; "
        f"decode_summary {json.dumps(summaries['decode'])}; joint "
        f"{json.dumps(summaries['joint'])}; cer_vs_beam "
        f"{json.dumps(summaries['cer_vs_beam'])}; launches "
        f"{json.dumps(launches)}; kernel calls vs plain "
        f"{json.dumps(errs)}; seconds in the CLIs' runs and in starting "
        f"their processes {json.dumps(cli_wall)} [{card}]")
    return launches, errs, summaries


def run_checkpoint_phase(card, workdir, ckpt, cv_manifest):
    """Phase 16: 16a run_export_check on phase 8's aishell checkpoint and
    phase 10's cv manifest; 16b run_recipe_script. -> (prefix launches
    {path: n}, CTC launches of the recipe's training, {"prefix": path
    timings}, {kernel: max abs error})."""
    from tpu_asr_torch.data import load_manifest
    wall = {}
    t0 = time.perf_counter()
    export_launches, prefix_t, export_err = run_export_check(
        card, workdir, ckpt, cv_manifest, len(load_manifest(cv_manifest)))
    wall["16a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recipe_launches, errs, _ = run_recipe_script(card, workdir)
    wall["16b"] = time.perf_counter() - t0
    log("phase 16 wall seconds by part: " + json.dumps(wall))
    errs["ctc_prefix_scan"] = max(errs.get("ctc_prefix_scan", 0.0),
                                  export_err)
    prefix = {EXPORT_PATH: export_launches,
              f"{RECIPE_SCRIPT_PATH} joint (recognize)":
                  recipe_launches["joint"]["ctc_prefix_scan"]}
    return prefix, recipe_launches["training"], {"prefix": prefix_t}, errs


# ---- phase 17: Whisper large-v3 behind the server ----

WHISPER_PRESET = "whisper_large_v3"
WHISPER_PATH = "Whisper large-v3 serving"
# as the serving cell whisper_lv3_serve_beam5_c64 serves it: batches of
# 32, one bucket (every request pads to the 30 s window anyway), beam 5,
# at most floor(0.0625 x speech encoder frames) tokens after the prompt
WHISPER_BATCH = 32
WHISPER_BUCKET = 1000
WHISPER_MAXLENRATIO = 0.0625


def check_whisper_flash():
    """flash_attention_fwd at the shape Whisper large-v3's encoder gives
    it as served: WHISPER_BATCH windows, Tq = Tk = 1500, 20 heads of 64,
    every key valid (the encoder passes no mask), bf16, q, k and v as
    three projections give them; against its plain version at
    FLASH_BF16_TOL and timed beside it, with its bound. -> (max abs err
    of out, of lse, {shape: times})."""
    from tpu_asr_torch.configs.presets import get_preset
    cfg = get_preset(WHISPER_PRESET).model
    b, t, h = WHISPER_BATCH, cfg.audio_ctx, cfg.num_heads
    dh = cfg.d_model // h
    q, k, v, valid = flash_case(b, t, t, h, dh, torch.bfloat16, [t] * b,
                                SEED)
    what = (f"Whisper encoder B={b} Tq={t} Tk={t} H={h} dh={dh} no mask "
            f"{q.dtype}")
    out_err, lse_err = compare_flash(q, k, v, valid, False, what)
    timing = dict(time_flash(q, k, v, valid, False, what), shape=what,
                  max_abs_err=out_err, lse_max_abs_err=lse_err)
    log(f"flash_attention_fwd vs plain at {what}: max abs err out "
        f"{out_err:.3e} (atol {FLASH_BF16_TOL['atol']}), lse {lse_err:.3e}")
    del q, k, v, valid
    torch.cuda.empty_cache()
    return out_err, lse_err, {what: timing}


def whisper_server():
    """The AsrServer that `python -m tpu_asr_torch.serve --random-init
    --preset whisper_large_v3` builds, with the serving cell's batch,
    bucket and cap, warmed up."""
    from tpu_asr_torch import serve
    server = serve.build_server(serve.parse_args([
        "--random-init", "--preset", WHISPER_PRESET, "--seed", str(SEED),
        "--device", DEVICE, "--beam", "5",
        "--maxlenratio", str(WHISPER_MAXLENRATIO),
        "--bucket-frames", str(WHISPER_BUCKET),
        "--batch-size", str(WHISPER_BATCH), "--inputs", "wav"]))
    server.warmup(kinds=("wav",))
    torch.cuda.synchronize()
    return server


def check_whisper_answers(cfg, wavs, results):
    """Each 1-best a list of token ids of the vocabulary, no longer than
    the cap the speech frames give it."""
    for wav, (nbest, _) in zip(wavs, results):
        toks = nbest[0]["yseq"]
        frames = len(wav) // 160
        cap = int(WHISPER_MAXLENRATIO * cfg.subsampled_length(frames))
        if not (len(toks) <= cap and
                all(0 <= x < cfg.vocab_size for x in toks)):
            raise AssertionError(f"{WHISPER_PATH}: a 1-best of "
                                 f"{len(toks)} tokens for {frames} frames "
                                 f"(cap {cap}): {toks}")


def run_whisper_serving(card, flash_caps):
    """Whisper large-v3 (1.55 B parameters, random weights from SEED)
    behind whisper_server(): WHISPER_BATCH wav requests from 8 threads,
    then the same again under torch.profiler. Per encoder batch the flash
    kernel launches once an encoder layer and nowhere else (the beam's
    steps attend by matmuls): counted from 0 just before each run and read
    just after, and in the profiler's trace, whose count must equal the
    launches counted in that run. Every beam step of both runs is a graph
    replay. The inputs of the first flash call go into flash_caps. ->
    {"launches", "batches", "per_batch"}."""
    from tpu_asr_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    server = whisper_server()
    rec, cfg = server.rec, server.rec.cfg
    log(f"{WHISPER_PATH}: d{cfg.d_model}, h{cfg.num_heads}, "
        f"{cfg.num_enc_layers}+{cfg.num_dec_layers} layers, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, flash attention "
        f"{cfg.attention_pallas}; beam {rec.beam.beam}, maxlenratio "
        f"{rec.beam.maxlenratio}, batch {WHISPER_BATCH}; built and warmed "
        f"up in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at most")
    server.start()
    rng = np.random.default_rng(SEED)
    wavs = [synth_wav(n, rng)
            for n in request_lengths(WHISPER_BATCH, SEED)]
    audio_s = sum(len(w) for w in wavs) / 16000.0
    per_batch = cfg.num_enc_layers
    flash_fwd = fa.flash_attention_fwd
    symbol = flash_symbol("fwd", cfg.dtype)
    try:
        # main path: counts from 0 just before, read just after
        stats0 = dict(server.stats)
        flash_fwd.launches = 0
        with record_inputs(fa, "flash_attention_fwd", flash_caps,
                           PathLabels(WHISPER_PATH).flash):
            results, wall = serve_requests(server, wavs, WHISPER_BATCH)
        launches = flash_fwd.launches
        d = {k: server.stats[k] - stats0[k] for k in stats0}
        batches = d["batches"]
        check_whisper_answers(cfg, wavs, results)
        if not (d["batches"] > 0 and launches == per_batch * d["batches"]
                and d["beam_graph_steps"] == d["beam_steps"] > 0):
            raise AssertionError(
                f"{WHISPER_PATH}: {launches} flash launches for "
                f"{d['batches']} batches ({per_batch} a batch expected); "
                f"{d['beam_graph_steps']} of {d['beam_steps']} beam steps "
                f"replayed")
        lat = sorted(dt for _, dt in results)
        log(f"{WHISPER_PATH}: {len(wavs)} requests ({audio_s:.1f} s of "
            f"audio) in {wall:.3f} s; {d['batches']} batches, {launches} "
            f"flash_attention_fwd launches ({per_batch} a batch), "
            f"{d['beam_steps']} beam steps, all replayed; latency p50 "
            f"{statistics.median(lat) * 1e3:.1f} ms, max "
            f"{lat[-1] * 1e3:.1f} ms; {audio_s / wall:.2f} audio s/s "
            f"[{card}]; random weights: 1-best lengths "
            f"{[len(nb[0]['yseq']) for nb, _ in results]}")
        # the kernels the card ran, as its trace counts them
        stats0 = dict(server.stats)
        counted = flash_fwd.launches
        kernels = profile_serving(server, wavs, card, WHISPER_PATH,
                                  WHISPER_BATCH)["kernels"]
        traced = sum(n for k, n in kernels.items() if symbol in k)
        counted = flash_fwd.launches - counted
        d = {k: server.stats[k] - stats0[k] for k in stats0}
        if not (traced == counted == per_batch * d["batches"] > 0
                and d["beam_graph_steps"] == d["beam_steps"]):
            raise AssertionError(
                f"{WHISPER_PATH} under the profiler: {traced} {symbol} "
                f"events traced, {counted} launches counted, "
                f"{d['batches']} batches ({per_batch} a batch expected); "
                f"{d['beam_graph_steps']} of {d['beam_steps']} beam steps "
                f"replayed")
        log(f"{WHISPER_PATH} under the profiler: {traced} {symbol} events "
            f"traced == launches counted == {per_batch} x {d['batches']} "
            f"batches; every beam step replayed [{card}]")
    finally:
        server.stop()
    del server, rec
    torch.cuda.empty_cache()
    return {"launches": launches, "batches": batches,
            "per_batch": per_batch}


def run_whisper_phase(card):
    """Phase 17: check_whisper_flash, run_whisper_serving, and the flash
    calls it recorded against the plain version (check_flash_ln_on_paths).
    -> (launches, {"flash", "lse"} max abs errors, {label: timings})."""
    t0 = time.perf_counter()
    out_err, lse_err, timings = check_whisper_flash()
    caps = {}
    launches = run_whisper_serving(card, caps)
    if len(caps) != 1:
        raise AssertionError(f"{WHISPER_PATH}: flash inputs kept under "
                             f"{sorted(caps)}, expected the encoder's")
    path_t, _, errs = check_flash_ln_on_paths(caps, {}, WHISPER_PATH)
    timings.update({f"path {k}": v for k, v in path_t.items()})
    log(f"phase 17 wall seconds: {time.perf_counter() - t0:.1f}")
    return launches, {"flash": max(out_err, errs["flash"]),
                      "lse": max(lse_err, errs["lse"])}, timings


def whisper_only(card) -> int:
    """`python3 chip_smoke.py --whisper`: phases 1, 2 (the flash
    forward's library alone) and 17; one JSON line of what phase 17
    found, then the last line."""
    from tpu_asr_torch.ops import flash_attention
    from tpu_asr_torch.ops.cuda_build import load_all
    load_all(flash_attention.LIBRARY)
    launches, errs, timings = run_whisper_phase(card)
    log(json.dumps({"whisper": {"launches_by_path": {
        WHISPER_PATH: launches["launches"]}, "batches": launches["batches"],
        "max_abs_err": errs["flash"], "lse_max_abs_err": errs["lse"],
        "timings": timings}}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--fork-server"]:
        fork_server(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from tpu_asr_torch.ops import (cif_fire, ctc_loss, ctc_prefix,
                                   flash_attention, layernorm)
    from tpu_asr_torch.ops.cuda_build import load_all

    started = time.perf_counter()

    def mark(phases):
        log(f"phases {phases} done at {time.perf_counter() - started:.1f} s")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--beam-ties"]:
        return measure_beam_ties(card, int(sys.argv[2]))
    if sys.argv[1:2] == ["--whisper"]:
        return whisper_only(card)
    if sys.argv[1:2] == ["--parallel-faults"]:
        from tpu_asr_torch.ops.cuda_build import load_all
        from tpu_asr_torch.ops import (ctc_loss, flash_attention,
                                       layernorm)
        load_all(ctc_loss.LIBRARY, flash_attention.LIBRARY,
                 flash_attention.BWD_LIBRARY, layernorm.LIBRARY)
        return measure_parallel_faults(card)

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
    mark("1-3")
    check_agreement()
    check_train_agreement()
    check_train_agreement(use_pallas=True)
    check_conformer_agreement()
    check_transducer_agreement()
    check_streaming_agreement()
    check_cif_agreement()
    check_pallas_agreement()
    check_lm_agreement()
    check_input_agreement()
    mark("1-4")
    prefix_caps = {}
    launches = run_serving(card, prefix_caps)
    captures = {}
    cif_serving = run_cif_serving(card, captures)
    flash_caps, ln_caps = {}, {}
    flash_serving, ln_serving = run_pallas_serving(card, flash_caps, ln_caps)
    mark("1-7")
    t0 = time.perf_counter()
    data = synthetic_aishell()
    log(f"training: {len(data[0])} + {len(data[1])} synthetic utterances "
        f"made in {time.perf_counter() - t0:.1f} s")
    training, bwd_caps, ctc_caps = {}, {"flash": {}, "ln": {}}, {}
    train_stats = {}
    pallas = f"{PRESET} use_pallas"
    # the hybrid and use_pallas checkpoints stay for phase 10's decodes;
    # phase 10 runs last, after phase 9's traced kernel timings
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        ckpts = {}
        for key, preset, overrides in ((PRESET, PRESET, None),
                                       ("cif", "cif", None),
                                       (pallas, PRESET,
                                        {"use_pallas": True})):
            wd = os.path.join(workdir, key.replace(" ", "_"))
            training[key] = run_training(card, wd, preset, data, captures,
                                         overrides, bwd_caps, ctc_caps,
                                         stats=train_stats.setdefault(key,
                                                                      {}))
            ckpts[key] = wd
        mark("1-8")
        path_err, path_timings = check_cif_fire_on_paths(captures)
        flash_path, ln_path, path_errs = check_flash_ln_on_paths(flash_caps,
                                                                 ln_caps)
        flash_bwd_path, ln_bwd_path, bwd_path_errs = check_bwd_on_paths(
            bwd_caps)
        prefix_path, ctc_path, ctc_path_errs = check_ctc_on_paths(
            prefix_caps, ctc_caps)
        mark("1-9")
        (lm_launches, lm_paths, lm_errs), lm_dir, cv_manifest = \
            run_lm_phase(card, workdir, data,
                         {"aishell": ckpts[PRESET],
                          "use_pallas": ckpts[pallas]})
        mark("1-10")
        (training["conformer"], recipe_prefix, recipe_paths,
         recipe_errs) = run_recipe_phase(card, workdir, data,
                                         train_stats[PRESET])
        mark("1-11")
        transducer_launches, transducer_paths, transducer_errs = \
            run_transducer_phase(card, workdir, data, train_stats[PRESET],
                                 lm_dir, cv_manifest)
        training.update(transducer_launches)
        mark("1-12")
        streaming_launches, streaming_paths, streaming_errs = \
            run_streaming_phase(card, workdir, data, train_stats[PRESET],
                                cv_manifest)
        training.update(streaming_launches)
        mark("1-13")
        input_launches, pitch_prefix, input_paths, input_errs = \
            run_inputs_phase(card, workdir, data, train_stats[PRESET],
                             cv_manifest)
        training.update(input_launches)
        mark("1-14")
        parallel, parallel_errs = run_parallel_phase(
            card, workdir, data, ckpts[PRESET], cv_manifest)
        mark("1-15")
        ckpt_prefix, training[f"{RECIPE_SCRIPT_PATH} "
                              f"{RECIPE_SCRIPT_PRESET}"], ckpt_paths, \
            ckpt_errs = run_checkpoint_phase(card, workdir, ckpts[PRESET],
                                             cv_manifest)
        mark("1-16")
    whisper_launches, whisper_errs, whisper_timings = run_whisper_phase(card)
    mark("1-17")
    tp_path = f"{pallas} tp {PARALLEL_RANKS} ranks"
    training[f"{PRESET} dp {PARALLEL_RANKS} ranks"] = rank_sum(
        parallel["dp"])
    training[tp_path] = rank_sum(parallel["tp"])
    training[f"{PRESET} --num-devices {PARALLEL_RANKS} (train CLI)"] = \
        rank_sum(parallel["trainer"])
    dp_decode = sum(parallel["decode"])

    def ctc_build(symbol):
        return {k: v for k, v in build_report.items() if symbol in k}

    main_t = timings[(249, True)]          # 1000-frame bucket, one-pass
    kernels = [{
        "name": "ctc_prefix_scan",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/ctc_prefix_scan.cu",
        "replaces": "tpu_asr/ops/pallas/ctc_prefix.py:114",
        "launches": (launches + lm_launches["joint"]["ctc_prefix_scan"]
                     + recipe_prefix + pitch_prefix + dp_decode
                     + sum(ckpt_prefix.values())),
        "launches_by_path": dict({
            "joint serving": launches,
            "LM-fused joint (recognize)":
                lm_launches["joint"]["ctc_prefix_scan"],
            RECIPE_PATH: recipe_prefix, PITCH_PATH: pitch_prefix,
            f"joint --dp {PARALLEL_RANKS} (recognize)": dp_decode},
            **ckpt_prefix),
        "parallel_launches_by_rank": {
            f"joint --dp {PARALLEL_RANKS} (recognize)": parallel["decode"]},
        "max_abs_err": max(max_err, ctc_path_errs["prefix"],
                           lm_errs["prefix"], recipe_errs["prefix"],
                           input_errs["prefix"],
                           parallel_errs["ctc_prefix_scan"],
                           ckpt_errs["ctc_prefix_scan"]),
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
        "path_max_abs_err": max(ctc_path_errs["prefix"], lm_errs["prefix"],
                                recipe_errs["prefix"], input_errs["prefix"],
                                parallel_errs["ctc_prefix_scan"],
                                ckpt_errs["ctc_prefix_scan"]),
        "parallel_max_abs_err": parallel_errs["ctc_prefix_scan"],
        "other_shapes": dict({f"T={t} hist={h}": v for (t, h), v
                              in timings.items() if (t, h) != (249, True)},
                             **{f"path {k}": v for k, v in
                                (prefix_path | lm_paths["prefix"]
                                 | recipe_paths["prefix"]
                                 | input_paths["prefix"]
                                 | ckpt_paths["prefix"]).items()}),
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
        other.update({f"path {k}": v[name] for k, v in
                      (ctc_path | recipe_paths["ctc"]
                       | transducer_paths["ctc"]
                       | streaming_paths["ctc"]
                       | input_paths["ctc"]).items()})
        kernels.append({
            "name": f"ctc_loss_{name}",
            "route": "cuda",
            "source": "tpu_asr_torch/csrc/ctc_loss.cu",
            "replaces": f"tpu_asr/ops/pallas/ctc.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(ctc_errs[name], ctc_path_errs[name],
                               recipe_errs[name], transducer_errs[name],
                               streaming_errs[name], input_errs[name],
                               parallel_errs[f"ctc_loss_{name}"],
                               ckpt_errs[f"ctc_loss_{name}"]),
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
            "path_max_abs_err": max(ctc_path_errs[name],
                                    recipe_errs[name],
                                    transducer_errs[name],
                                    streaming_errs[name], input_errs[name],
                                    parallel_errs[f"ctc_loss_{name}"],
                                    ckpt_errs[f"ctc_loss_{name}"]),
            "parallel_max_abs_err": parallel_errs[f"ctc_loss_{name}"],
            "shape": "B=32 T=249 S=49 (U=24)",
            "other_shapes": other,
            "ctc_loss_kernel_e2e_ms": ctc_library[49]["port_e2e"],
            "library_e2e_ms": ctc_library[49]["lib_e2e"],
            "parallel_launches_by_rank": {
                k: [r[f"ctc_loss_{name}"] for r in v]
                for k, v in parallel.items() if k != "decode"},
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
    for name, source, replaces, path_t, lm_t, synthetic, n, err, extra in (
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:110", flash_path, lm_paths["flash"],
             flash_timings,
             {"use_pallas serving": flash_serving,
              "use_pallas training": training[pallas]["flash_attention_fwd"],
              "LM-rescored attn_rescore (recognize)":
                  lm_launches["attn_rescore"]["flash_attention_fwd"],
              f"{tp_path} training": training[tp_path][
                  "flash_attention_fwd"],
              WHISPER_PATH: whisper_launches["launches"]},
             max(flash_err, path_errs["flash"], lm_errs["flash"],
                 parallel_errs["flash_attention_fwd"],
                 whisper_errs["flash"]),
             {"lse_max_abs_err": max(lse_err, path_errs["lse"],
                                     lm_errs["lse"], whisper_errs["lse"]),
              "whisper_shapes": whisper_timings,
              "library_call": "F.scaled_dot_product_attention, boolean "
                              "attn_mask, [B, H, T, dh] inputs",
              "design": "sm90 wgmma",
              "build": {k: v for k, v in build_report.items()
                        if "fwd_wgmma" in k}}),
            ("layer_norm_residual_fwd", "layer_norm_residual.cu",
             "layernorm.py:79", ln_path, lm_paths["ln"], ln_timings,
             {"use_pallas serving": ln_serving,
              "use_pallas training":
                  training[pallas]["layer_norm_residual_fwd"],
              "LM-rescored attn_rescore (recognize)":
                  lm_launches["attn_rescore"]["layer_norm_residual_fwd"],
              f"{tp_path} training": training[tp_path][
                  "layer_norm_residual_fwd"]},
             max(ln_err, path_errs["ln"], lm_errs["ln"],
                 parallel_errs["layer_norm_residual_fwd"]),
             {"bf16_ulps_at_output_scale": max(ln_ulps, path_errs["ln_ulps"],
                                               lm_errs["ln_ulps"]),
              "bf16_raw_ulps_max": max(ln_raw, path_errs["ln_raw"],
                                       lm_errs["ln_raw"]),
              "library_call": None})):
        main_label = max(path_t, key=lambda k: (    # labels "T'=<t> ..."
            int(k.split()[0][3:]), path_t[k]["bound_ms"]))
        t = path_t[main_label]
        other = {k: v for k, v in path_t.items() if k != main_label}
        other.update({f"path {k}": v for k, v in lm_t.items()})
        other.update({f"synthetic {k}": v for k, v in synthetic.items()})
        kernels.append(dict({
            "name": name,
            "route": "cuda",
            "source": f"tpu_asr_torch/csrc/{source}",
            "replaces": f"tpu_asr/ops/pallas/{replaces}",
            "launches": sum(n.values()),
            "launches_by_path": n,
            "max_abs_err": err,
            "parallel_max_abs_err": parallel_errs[name],
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
            "launches": training[pallas][name] + training[tp_path][name],
            "launches_by_path": {"use_pallas training":
                                 training[pallas][name],
                                 f"{tp_path} training":
                                     training[tp_path][name]},
            "max_abs_err": max([e for e, _ in errs.values()]
                               + [parallel_errs[name]]),
            "parallel_max_abs_err": parallel_errs[name],
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
    n_tp = training[tp_path]["layer_norm_residual_bwd"]
    kernels.append({
        "name": "layer_norm_residual_bwd",
        "route": "cuda",
        "source": "tpu_asr_torch/csrc/layer_norm_residual.cu",
        "replaces": "tpu_asr/ops/pallas/layernorm.py:51",
        "launches": n + n_tp,
        "launches_by_path": {"use_pallas training": n,
                             f"{tp_path} training": n_tp},
        "max_abs_err": max(ln_bwd_errs["dx"], bwd_path_errs["ln"]["dx"],
                           parallel_errs["layer_norm_residual_bwd"]),
        "parallel_max_abs_err": parallel_errs["layer_norm_residual_bwd"],
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
