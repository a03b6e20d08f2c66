"""Decoding CLI of the PyTorch port (port of bin/recognize.py).

Checkpoint folder + manifest -> bucketed batches decoded by the
Recognizer -> a hypothesis JSONL (one line per utterance: id,
hyp_tokens, and times / confidence / nbest where the mode gives them)
and one JSON summary line on stdout (n_utts, inverse_rtf, wall_s, mode,
and cer when the manifest has reference tokens):

  python -m tpu_asr_torch.recognize --ckpt exp/hybrid \\
      --manifest test.jsonl --mode joint --beam 10 --output hyp.jsonl
  python -m tpu_asr_torch.recognize --ckpt exp/hybrid \\
      --manifest test.jsonl --mode ctc_beam --beam 10 \\
      --lm-ckpt exp/lm --lm-weight 0.1
  python -m tpu_asr_torch.recognize --ckpt exp/transducer \\
      --manifest test.jsonl --mode transducer_rescore --beam 10 \\
      --ctc-weight 0.5

The checkpoint's frontend.json gives the feature policy. Every bucket
shape is decoded once before the timed pass, which decodes through
`Recognizer.decode_batches_nbest` (a window of batches a host copy).
--lm-ckpt reads a `python -m tpu_asr_torch.train_lm` folder (its best
step by cv loss) for shallow fusion (beam, joint, ctc_beam,
transducer_beam) or n-best rescoring (attn_rescore). Runs on the CUDA
card unless given --device cpu; with no card and no such flag it
raises.

`--dp N` decodes data-parallel on N ranks of this host (rank r on
cuda:(r mod the number of cards), or the CPU with --device cpu; NCCL
when each has a card of its own, gloo when they share one; see
parallel/mesh.py): bucket batch sizes are multiples of N, every rank
decodes its rows of each batch, and rank 0 alone writes --output and
prints the summary. With COORDINATOR_ADDRESS, NUM_PROCESSES and
PROCESS_ID set, this process is one rank of such a group instead.

  python -m tpu_asr_torch.recognize --ckpt exp/hybrid \\
      --manifest test.jsonl --mode joint --dp 2 --output hyp.jsonl

`--torch-ckpt` decodes the original PyTorch repo's `.pth.tar`
(parity/torch_import.py). With --ckpt beside it, that folder's
model_config.json is the config and its frontend.json the feature
policy; alone, the config is inferred from the file and the frontend is
the default, and --output defaults to hyp.jsonl beside the file:

  python -m tpu_asr_torch.recognize --torch-ckpt final.pth.tar \\
      --manifest test.jsonl --mode joint --beam 5

`--random-init` decodes a preset's model on seeded random weights
(`--preset`, `--seed`; the preset's frontend), e.g. Whisper large-v3,
whose tokenizer's files this repository does not hold (token ids only):

  python -m tpu_asr_torch.recognize --random-init \\
      --preset whisper_large_v3 --manifest wavs.jsonl --beam 5 \\
      --maxlenratio 0.0625 --output hyp.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch.distributed as dist

DEFAULT_MODES = {"ctc": "greedy_ctc", "transformer": "beam",
                 "hybrid": "joint", "cif": "cif_greedy",
                 "transducer": "transducer_greedy"}


def parse_args(argv=None):
    from tpu_asr_torch.decode.recognizer import MODES
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.recognize",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default="",
                   help="checkpoint folder of python -m tpu_asr_torch.train")
    p.add_argument("--torch-ckpt", default="",
                   help="decode a reference-format .pth.tar; the config "
                        "comes from the file, or from --ckpt's "
                        "model_config.json when both are given")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random weights of --preset (no "
                        "checkpoint)")
    p.add_argument("--preset", default="aishell",
                   help="with --random-init: the model and frontend preset")
    p.add_argument("--seed", type=int, default=0,
                   help="with --random-init: the weights' seed")
    p.add_argument("--manifest", required=True)
    p.add_argument("--output", default="",
                   help="hypothesis JSONL (default: <ckpt>/hyp.jsonl)")
    p.add_argument("--mode", default="", choices=("",) + MODES,
                   help="default: by model type (hybrid -> joint, "
                        "transformer -> beam, ctc -> greedy_ctc, cif -> "
                        "cif_greedy, transducer -> transducer_greedy); "
                        "joint falls back to beam off hybrid")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--max-len", type=int, default=100)
    p.add_argument("--maxlenratio", type=float, default=0.0,
                   help="per-utterance max decode length = ratio * encoder "
                        "length; 0 = --max-len only")
    p.add_argument("--minlenratio", type=float, default=0.0,
                   help="ban eos before ratio * encoder length tokens")
    p.add_argument("--length-penalty", type=float, default=0.0,
                   help="per-token reward added to final beam scores")
    p.add_argument("--ctc-weight", type=float, default=0.3,
                   help="CTC weight of joint, attn_rescore and "
                        "transducer_rescore")
    p.add_argument("--lm-ckpt", default="",
                   help="LM folder of python -m tpu_asr_torch.train_lm")
    p.add_argument("--lm-weight", type=float, default=0.3,
                   help="LM score weight (only with --lm-ckpt)")
    p.add_argument("--batch-frames", type=int, default=16000)
    p.add_argument("--num-buckets", type=int, default=4)
    p.add_argument("--step", type=int, default=-1,
                   help="checkpoint step (-1 = use --restore)")
    p.add_argument("--restore", default="best", choices=["best", "latest"])
    p.add_argument("--cif-fire", default="scaled", choices=["scaled", "raw"],
                   help="CIF firing: 'scaled' self-scales alphas to the "
                        "rounded fire count; 'raw' is the reference's "
                        "unscaled firing")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel decode on N ranks of this host "
                        "(0 or 1: one process)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not (args.ckpt or args.torch_ckpt or args.random_init):
        p.error("--ckpt or --torch-ckpt is required (or --random-init)")
    return args


def restore_step(ck, step: int, restore: str) -> int:
    """--step, else the best or the latest step of the folder."""
    if step >= 0:
        return step
    return ck.latest_step() if restore == "latest" else ck.best_step()


def main(argv=None) -> dict | None:
    """-> the summary printed as the last line (None from a --dp launch,
    whose ranks print it)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.dp > 1 and not os.environ.get("COORDINATOR_ADDRESS"):
        from tpu_asr_torch.parallel.mesh import spawn_ranks
        spawn_ranks("tpu_asr_torch.recognize:decode", args.dp, argv)
        return None
    return decode(argv)


def build(args, device, mesh=None, world: int = 1):
    """The Recognizer that `args` describe on `device` (data-parallel
    over `mesh` when given) and the manifest's batches (bucket batch
    sizes multiples of `world`). -> (recognizer, utterances, a function
    giving a new loader of the batches, the frontend, whether the
    manifest holds wavs)."""
    from tpu_asr_torch.data import DataLoader, load_manifest, make_buckets
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import CTC_WEIGHT_MODES, Recognizer
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.models.lm import load_lm
    from tpu_asr_torch.train.checkpoints import Checkpointer

    ck = Checkpointer(args.ckpt) if args.ckpt else None
    frontend = None
    if args.random_init:
        from tpu_asr_torch.configs.presets import get_preset
        from tpu_asr_torch.weights import init_random
        preset = get_preset(args.preset)
        cfg, frontend = preset.model, preset.frontend
        model = init_random(build_model(cfg), args.seed)
    elif args.torch_ckpt:
        from tpu_asr_torch.parity.torch_import import load_torch_model
        model, cfg = load_torch_model(args.torch_ckpt,
                                      ck.load_config() if ck else None)
    else:
        cfg = ck.load_config()
        model = build_model(cfg)
        model.load_state_dict(ck.restore(restore_step(
            ck, args.step, args.restore))["model"])
    mode = args.mode or DEFAULT_MODES[cfg.model_type]
    if mode == "joint" and cfg.model_type != "hybrid":
        mode = "beam"
    frontend = (frontend or (ck.load_frontend() if ck else None)
                or FrontendConfig())
    lm = load_lm(args.lm_ckpt) if args.lm_ckpt else None
    rec = Recognizer(
        cfg, model, mode=mode, frontend=frontend, device=device, mesh=mesh,
        cif_scale_fire=args.cif_fire == "scaled",
        lm_cfg=None if lm is None else lm.cfg, lm=lm,
        beam=BeamConfig(beam=args.beam, max_len=args.max_len,
                        nbest=args.nbest, maxlenratio=args.maxlenratio,
                        minlenratio=args.minlenratio,
                        length_penalty=args.length_penalty,
                        ctc_weight=args.ctc_weight
                        if mode in CTC_WEIGHT_MODES else 0.0,
                        lm_weight=args.lm_weight if lm is not None
                        else 0.0))

    utts = load_manifest(args.manifest)
    wav_mode = bool(utts and utts[0].wav)
    scale = frontend.frame_shift if wav_mode else 1
    buckets = make_buckets(
        utts, num_buckets=args.num_buckets,
        batch_frames=args.batch_frames * scale,
        max_frames_cap=3000 * scale, max_tokens_cap=200,
        length_key="num_samples" if wav_mode else "num_frames",
        batch_multiple=world)

    def loader():
        return DataLoader(utts, buckets, mode="wav" if wav_mode else "feat",
                          shuffle=False)
    return rec, utts, loader, frontend, wav_mode


def pair_results(batch_ids: list, batch_rows: list, nbests: list) -> dict:
    """{utterance id: n-best} from each batch's ids, its row count (the
    ids' rows, then the loader's dummy rows) and the n-bests
    decode_batches_nbest gave for it, in order; raises unless there are
    as many batches of n-bests as of ids and each batch has an n-best a
    row."""
    if not len(batch_ids) == len(batch_rows) == len(nbests):
        raise AssertionError(f"{len(batch_ids)} batches of ids but "
                             f"{len(nbests)} batches of n-bests")
    results = {}
    for i, (ids, rows, batch_nb) in enumerate(zip(batch_ids, batch_rows,
                                                  nbests)):
        if len(batch_nb) != rows or len(ids) > rows:
            raise AssertionError(f"batch {i}: {len(ids)} ids in {rows} "
                                 f"rows but {len(batch_nb)} n-bests")
        results.update(zip(ids, batch_nb))     # the dummy rows come last
    return results


def decode(argv) -> dict | None:
    """One rank's decode (the only one without --dp) -> rank 0's
    summary, None on the other ranks."""
    args = parse_args(argv)
    from tpu_asr_torch.parallel.mesh import initialize_distributed, make_mesh
    from tpu_asr_torch.utils.cer import cer
    from tpu_asr_torch.utils.device import resolve_device

    device = initialize_distributed(args.device) or resolve_device(
        args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.dp > 1 and args.dp != world:
        raise SystemExit(f"--dp {args.dp} in a group of {world} ranks")
    mesh = make_mesh(n_data=world) if world > 1 else None
    rec, utts, loader, frontend, wav_mode = build(args, device, mesh, world)
    mode = rec.mode

    # decode every bucket shape once before the timed pass
    warmed = set()
    for batch in loader():
        shape = (batch["wav"] if wav_mode else batch["feats"]).shape
        if shape not in warmed:
            rec.decode_batch_nbest(batch)
            warmed.add(shape)

    batch_ids, batch_rows, audio_s = [], [], [0.0]

    def stream():
        for batch in loader():
            batch_ids.append(batch["ids"])
            batch_rows.append(len(batch["wav" if wav_mode else "feats"]))
            if wav_mode:
                audio_s[0] += float(np.sum(batch["wav_lengths"])) / \
                    frontend.sample_rate
            else:
                audio_s[0] += float(np.sum(batch["feat_lengths"])) * \
                    frontend.frame_shift_ms / 1000.0
            yield batch

    t0 = time.perf_counter()
    nbests = rec.decode_batches_nbest(stream())
    wall = time.perf_counter() - t0
    results = pair_results(batch_ids, batch_rows, nbests)
    if mesh is not None and mesh.rank != 0:
        return None

    out_dir = args.ckpt or os.path.dirname(args.torch_ckpt) or "."
    out_path = args.output or os.path.join(out_dir, "hyp.jsonl")
    with open(out_path, "w") as f:
        for uid, nb in results.items():
            line = {"id": uid, "hyp_tokens": nb[0]["yseq"]}
            for key in ("times", "confidence"):
                if key in nb[0]:
                    line[key] = nb[0][key]
            if len(nb) > 1:
                line["nbest"] = nb
            f.write(json.dumps(line) + "\n")
    summary = {"n_utts": len(results),
               "inverse_rtf": round(audio_s[0] / wall if wall > 0 else 0.0,
                                    2),
               "wall_s": round(wall, 2), "mode": mode}
    refs = {u.id: u.tokens for u in utts}
    if any(refs.values()):
        summary["cer"] = round(cer([refs[u] for u in results],
                                   [nb[0]["yseq"] for nb in
                                    results.values()])["cer"], 4)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
