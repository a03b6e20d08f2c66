"""CTC forced alignment CLI of the PyTorch port (port of bin/align.py):
per-token time spans for reference transcripts.

  python -m tpu_asr_torch.align --ckpt exp/aishell \\
      --manifest test.jsonl --output align.jsonl

Given audio (or features) and its transcript, the Viterbi best path
through the CTC lattice (ops/ctc.py ctc_viterbi_align) assigns each
reference token a [start, end] span of encoder frames. One JSONL line an
utterance: id, tokens, start_frames, end_frames, start_s, end_s (end_s
is the end of the span's last frame; seconds rounded to 3 places), then
one summary line on stdout: n_utts, output, frame_s. Needs a checkpoint
with a CTC head (ctc, hybrid, or a transducer with an aux CTC head). An
encoder frame is conv_total_stride input frames for the conv2d input
layer, lfr_n for the linear one (whose features are LFR-stacked here as
in training). Runs on the CUDA card unless given --device cpu; with no
card and no such flag it raises.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.align",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint folder of python -m tpu_asr_torch.train")
    p.add_argument("--manifest", required=True,
                   help="JSONL with tokens (the transcripts to align)")
    p.add_argument("--output", default="",
                   help="alignment JSONL (default: <ckpt>/align.jsonl)")
    p.add_argument("--restore", default="best", choices=["best", "latest"])
    p.add_argument("--batch-frames", type=int, default=16000)
    p.add_argument("--num-buckets", type=int, default=4)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> the summary printed as the last line."""
    args = parse_args(argv)
    import torch

    from tpu_asr_torch.data import DataLoader, load_manifest, make_buckets
    from tpu_asr_torch.frontend import FrontendConfig, cmvn_stats_for
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.ops.ctc import ctc_viterbi_align
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.train.loop import apply_lfr, batch_features, model_lfr
    from tpu_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ck = Checkpointer(args.ckpt)
    cfg = ck.load_config()
    if not (cfg.model_type in ("ctc", "hybrid") or (
            cfg.model_type == "transducer" and cfg.ctc_weight > 0)):
        raise SystemExit(f"alignment needs a CTC head (model_type="
                         f"{cfg.model_type})")
    frontend = ck.load_frontend() or FrontendConfig()

    utts = load_manifest(args.manifest)
    if not all(u.tokens for u in utts):
        raise SystemExit("--manifest must carry reference tokens to align")
    wav_mode = bool(utts and utts[0].wav)
    scale = frontend.frame_shift if wav_mode else 1
    buckets = make_buckets(
        utts, num_buckets=args.num_buckets,
        batch_frames=args.batch_frames * scale,
        max_frames_cap=3000 * scale, max_tokens_cap=200,
        length_key="num_samples" if wav_mode else "num_frames")
    loader = DataLoader(utts, buckets, mode="wav" if wav_mode else "feat",
                        shuffle=False)

    model = build_model(cfg)
    model.load_state_dict(ck.restore(restore_step(ck, -1, args.restore))
                          ["model"])
    model.to(device).eval()
    cmvn_stats = cmvn_stats_for(frontend, device)
    lfr = model_lfr(cfg)
    # frame -> seconds: the encoder frame's stride in input frames x 10 ms
    stride = (cfg.conv_total_stride if cfg.input_layer == "conv2d"
              else cfg.lfr_n)
    sec = stride * frontend.frame_shift_ms / 1000.0

    out_path = args.output or os.path.join(args.ckpt, "align.jsonl")
    n = 0
    with open(out_path, "w") as f, torch.inference_mode():
        for batch in loader:
            feats, flens, targets, tlens = batch_features(
                batch, frontend, device, cmvn_stats)
            feats, flens = apply_lfr(feats, flens, lfr)
            enc_out, el = model.encode(feats, flens)
            logits = model.ctc_logits(enc_out)
            safe = torch.where(targets < 0, 0, targets)
            starts, ends = ctc_viterbi_align(logits, safe, el, tlens)
            tl, tgt = batch["target_lengths"], batch["targets"]
            for i, uid in enumerate(batch["ids"]):
                ul = int(tl[i])
                rec = {
                    "id": uid,
                    "tokens": [int(x) for x in tgt[i, :ul]],
                    "start_frames": [int(x) for x in starts[i, :ul]],
                    "end_frames": [int(x) for x in ends[i, :ul]],
                    "start_s": [round(float(x) * sec, 3)
                                for x in starts[i, :ul]],
                    "end_s": [round(float(x + 1) * sec, 3)
                              for x in ends[i, :ul]],
                }
                f.write(json.dumps(rec) + "\n")
                n += 1
    summary = {"n_utts": n, "output": out_path, "frame_s": sec}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
