"""Global CMVN statistics over a (train) manifest (port of
bin/compute_cmvn.py): the recipe's compute-cmvn-stats stage.

  python -m tpu_asr_torch.compute_cmvn --manifest train.jsonl \\
      --out exp/cmvn.npz
  python -m tpu_asr_torch.train ... --cmvn global --cmvn-stats exp/cmvn.npz

Accumulates the per-dimension mean and variance of the un-normalized
features of every utterance (log-mel, with pitch if the frontend has
it; a feature manifest's .npy or Kaldi ark features), then writes an
.npz with mean [D], istd [D] (float32), frames (the count) and the
frontend's fingerprint, the keys bin/compute_cmvn.py writes: either
package loads the other's file. Wav features come from the port's
frontend on the device (the CUDA card unless --device cpu); the sums
are taken on the host in float64, an utterance at a time, as the
reference takes them.
--frontend-json (a frontend.json, or a checkpoint folder holding one)
names the frontend the stats are for; its CMVN fields are ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.compute_cmvn",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--frontend-json", default="",
                   help="frontend.json (or a checkpoint folder holding "
                        "one) of the frontend the stats are for; default "
                        "FrontendConfig()")
    p.add_argument("--limit", type=int, default=0,
                   help="max utterances (0 = all)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_frontend_json(path: str):
    """FrontendConfig of a frontend.json (or of the one in a folder),
    with cmvn_mode "none": the stats are of un-normalized features."""
    from tpu_asr_torch.train.checkpoints import frontend_config_from_json
    if os.path.isdir(path):
        path = os.path.join(path, "frontend.json")
    with open(path) as f:
        d = json.load(f)
    return dataclasses.replace(frontend_config_from_json(d),
                               cmvn_mode="none", cmvn_stats_path="")


def utterance_features(utt, fcfg, device) -> np.ndarray:
    """[T, D] float64 un-normalized features of one utterance: its wave
    through the port's frontend on `device`, or its feature file (.npy
    or a Kaldi ark record)."""
    import torch

    from tpu_asr_torch.frontend import wav_to_features
    if not utt.wav:
        from tpu_asr_torch.data.loader import load_features
        return np.asarray(load_features(utt.feat), np.float64)
    if utt.wav.endswith(".npy"):
        wav = np.load(utt.wav)
    else:
        from tpu_asr_torch.data.audio import read_wav
        wav = read_wav(utt.wav)
    f, fl = wav_to_features(
        torch.from_numpy(np.asarray(wav, np.float32)[None]).to(device),
        torch.tensor([len(wav)], device=device), fcfg, apply_cmvn=False)
    return f[0, :int(fl[0])].cpu().numpy().astype(np.float64)


def main(argv=None) -> dict:
    """-> {"mean", "istd", "frames", "fingerprint"} as written."""
    args = parse_args(argv)
    from tpu_asr_torch.data import load_manifest
    from tpu_asr_torch.frontend import FrontendConfig, feature_fingerprint
    from tpu_asr_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    utts = load_manifest(args.manifest)
    if args.limit:
        utts = utts[:args.limit]
    fcfg = (load_frontend_json(args.frontend_json) if args.frontend_json
            else FrontendConfig())
    total = total_sq = None
    n_frames = 0
    for utt in utts:
        feats = utterance_features(utt, fcfg, device)
        if total is None:
            total = np.zeros(feats.shape[1])
            total_sq = np.zeros(feats.shape[1])
        total += feats.sum(axis=0)
        total_sq += np.square(feats).sum(axis=0)
        n_frames += feats.shape[0]
    if n_frames == 0:
        raise SystemExit(f"{args.manifest}: no frames to accumulate")
    mean = total / n_frames
    var = np.maximum(total_sq / n_frames - np.square(mean), 1e-8)
    istd = 1.0 / np.sqrt(var)
    out = {"mean": mean.astype(np.float32), "istd": istd.astype(np.float32),
           "frames": np.int64(n_frames),
           "fingerprint": np.str_(feature_fingerprint(fcfg))}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: {n_frames} frames, mean[0]={mean[0]:.3f} "
          f"istd[0]={istd[0]:.3f}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
