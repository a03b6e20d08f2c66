"""Streaming decode demo of the PyTorch port (port of bin/stream_demo.py):
feed each utterance of a manifest a chunk of feature frames at a time
and print tokens as they become final.

  python -m tpu_asr_torch.stream_demo --ckpt exp/streaming \\
      --manifest test.jsonl --chunk-frames 64
  python -m tpu_asr_torch.stream_demo --ckpt exp/streaming \\
      --manifest test.jsonl --chunk-frames 64 --beam 5 --quiet

The checkpoint's model type picks the recognizer (decode/streaming.py):
greedy CTC (ctc/hybrid; `--beam` > 1 the CTC prefix beam, whose 1-best
later audio may revise), CIF or the transducer. Each push prints
`+[tokens]` (newly final) or, with a beam, `=[tokens]` (the new 1-best),
at the time of the audio front; each utterance a JSON line (id, tokens,
cer); then one summary JSON line: n_utts, chunk_frames, enc_chunk_size,
mean_emission_lag_ms (the audio front minus the last final encoder
frame, over the pushes that emitted), wall_s and, when the manifest has
references, cer. Features are computed per utterance on the device
with the checkpoint's frontend and replayed a chunk at a time. Runs on
the CUDA card unless given --device cpu; with no card and no such flag
it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.stream_demo",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="checkpoint folder of python -m tpu_asr_torch.train")
    p.add_argument("--manifest", required=True)
    p.add_argument("--chunk-frames", type=int, default=64,
                   help="feature frames a push (64 = 0.64 s)")
    p.add_argument("--beam", type=int, default=1,
                   help="beam > 1 runs the streaming CTC prefix beam "
                        "(chunked ctc/hybrid models)")
    p.add_argument("--max-frames", type=int, default=3000)
    p.add_argument("--restore", default="best", choices=["best", "latest"],
                   help="which checkpoint step to stream with")
    p.add_argument("--limit", type=int, default=0, help="max utterances")
    p.add_argument("--quiet", action="store_true",
                   help="no per-push lines")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def utterance_features(utt, frontend, device, cmvn_stats=None) -> np.ndarray:
    """[T, D] float32 features of one manifest utterance: its wav through
    the frontend on `device`, or its feature file (.npy or a Kaldi ark
    record)."""
    if not utt.wav:
        from tpu_asr_torch.data.loader import load_features
        return np.asarray(load_features(utt.feat), np.float32)
    from tpu_asr_torch.frontend import wav_to_features
    if utt.wav.endswith(".npy"):
        wav = np.load(utt.wav)
    else:
        from tpu_asr_torch.data.audio import read_wav
        wav = read_wav(utt.wav)
    wav = torch.as_tensor(np.asarray(wav, np.float32)[None], device=device)
    feats, flen = wav_to_features(
        wav, torch.tensor([wav.shape[1]], device=device), frontend,
        cmvn_stats=cmvn_stats)
    return feats[0, :int(flen[0])].cpu().numpy()


def final_enc_frames(rec, chunk: int) -> int:
    """Encoder frames the recognizer has made final."""
    for name in ("_emitted_enc", "_alpha_done"):
        if hasattr(rec, name):
            return getattr(rec, name)
    return rec._chunks_done * chunk


def main(argv=None) -> dict:
    """-> the summary printed as the last line."""
    args = parse_args(argv)
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.decode.streaming import make_streaming_recognizer
    from tpu_asr_torch.frontend import FrontendConfig, cmvn_stats_for
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.utils.cer import cer
    from tpu_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ck = Checkpointer(args.ckpt)
    cfg = ck.load_config()
    chunk = cfg.enc_chunk_size
    if chunk <= 0:
        print("note: full-context model (enc_chunk_size=0): tokens only "
              "appear at the end of the stream; train with "
              "--enc-chunk-size to stream", file=sys.stderr)
    frontend = ck.load_frontend() or FrontendConfig()
    if frontend.cmvn_mode == "utterance" and chunk > 0:
        print("note: per-utterance CMVN is not causal; train with --cmvn "
              "global (python -m tpu_asr_torch.compute_cmvn) to stream",
              file=sys.stderr)
    if frontend.add_pitch and chunk > 0:
        print("note: pitch normalization is utterance-level (not causal); "
              "this demo computes features offline; train without --pitch "
              "to stream", file=sys.stderr)
    model = build_model(cfg)
    model.load_state_dict(ck.restore(restore_step(ck, -1, args.restore))
                          ["model"])
    cmvn_stats = cmvn_stats_for(frontend, device)
    beam_mode = args.beam > 1 and cfg.model_type in ("ctc", "hybrid")

    utts = load_manifest(args.manifest)
    if args.limit:
        utts = utts[:args.limit]
    refs, hyps, lags = [], [], []
    wall, n_decoded = 0.0, 0
    for utt in utts:
        feats = utterance_features(utt, frontend, device, cmvn_stats)
        if len(feats) > args.max_frames:
            print(f"warning: {utt.id} is {len(feats)} frames (> "
                  f"--max-frames {args.max_frames}); skipping",
                  file=sys.stderr)
            continue
        rec = make_streaming_recognizer(cfg, model, args.beam,
                                        max_frames=args.max_frames,
                                        device=device)
        t0 = time.perf_counter()
        prev_best: list[int] = []
        for pos in range(0, len(feats), args.chunk_frames):
            new = rec.push(feats[pos:pos + args.chunk_frames])
            if beam_mode:
                new, prev_best = ([] if new == prev_best else new), new
            if not new:
                continue
            front = min(pos + args.chunk_frames, len(feats))
            lags.append(front - final_enc_frames(rec, chunk)
                        * cfg.conv_total_stride)
            if not args.quiet:
                print(f"  [{front / 100:6.2f}s] "
                      f"{'=' if beam_mode else '+'}{new}")
        hyp = rec.finish()
        wall += time.perf_counter() - t0
        n_decoded += 1
        line = {"id": utt.id, "tokens": hyp}
        if utt.tokens:
            refs.append(utt.tokens)
            hyps.append(hyp)
            line["cer"] = round(cer([utt.tokens], [hyp])["cer"], 4)
        print(json.dumps(line), flush=True)
    summary = {
        "n_utts": n_decoded,
        "chunk_frames": args.chunk_frames,
        "enc_chunk_size": chunk,
        "mean_emission_lag_ms": (round(float(np.mean(lags)) * 10, 1)
                                 if lags else None),
        "wall_s": round(wall, 2),
    }
    if refs:
        summary["cer"] = round(cer(refs, hyps)["cer"], 4)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
