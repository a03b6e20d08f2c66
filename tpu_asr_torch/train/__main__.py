"""Training CLI of the PyTorch port (port of bin/train.py).

  python -m tpu_asr_torch.train --preset aishell --train-manifest train.jsonl \\
      --cv-manifest dev.jsonl --save-folder exp/aishell --vocab-size 4233
  python -m tpu_asr_torch.train --preset hybrid_dev --synthetic 200 \\
      --save-folder exp/dev --device cpu
  python -m tpu_asr_torch.train --preset cif_dev --synthetic 32 --epochs 2 \\
      --save-folder exp/cif_dev --device cpu
  python -m tpu_asr_torch.train --preset conformer --train-manifest \\
      train.jsonl --cv-manifest dev.jsonl --cmvn global --cmvn-stats \\
      exp/cmvn.npz --save-folder exp/conformer
  python -m tpu_asr_torch.train --preset transducer_dev --synthetic 32 \\
      --epochs 2 --save-folder exp/transducer_dev --device cpu
  python -m tpu_asr_torch.train --preset hybrid_dev --enc-chunk-size 4 \\
      --synthetic 32 --epochs 2 --save-folder exp/stream_dev --device cpu
  python -m tpu_asr_torch.train --preset aishell --pitch \\
      --train-manifest train.jsonl --cv-manifest dev.jsonl \\
      --save-folder exp/aishell_pitch
  python -m tpu_asr_torch.train --preset attention_lfr \\
      --train-manifest data.train.jsonl --cv-manifest data.dev.jsonl \\
      --save-folder exp/attention_lfr

Preset + flag overrides -> bucketed loaders -> TrainStep/Solver with a
checkpoint per epoch and JSONL metrics in the save folder. Runs on the
CUDA card unless given --device cpu; with no card and no such flag it
raises. The preset's model_type picks the model (models.build_model:
the hybrid Transformer, with the transformer or the conformer encoder,
the CIF model, or the TransducerModel, whose metrics carry loss_rnnt).
`--cmvn global --cmvn-stats <npz>` (stats from
python -m tpu_asr_torch.compute_cmvn) normalizes the features with the
train set's stats; the stats path goes into the checkpoint's
frontend.json made absolute, so recognize and serve pick the policy up.
`--pitch` pastes the 3 Kaldi pitch dims onto the fbank (83 features).
The model's input width comes from the data, since the port builds its
input layer before it sees a batch: the frontend's feature_dim for a
wav manifest, the first utterance's feature width for a feature
manifest (.npy or Kaldi ark, e.g. an espnet data.json's 83-dim dump);
model_config.json and frontend.json record it for recognize, serve and
stream_demo. A linear-input model (`attention_lfr`) trains on LFR-stacked
features (after SpecAugment).
`--enc-chunk-size`/`--enc-left-chunks` set the encoder's chunk mask
(the model then streams: decode/streaming.py, python -m
tpu_asr_torch.stream_demo) as bin/train.py does.
`--num-devices N` trains data-parallel on N ranks (0, the default, is
every visible card, or 1 with --device cpu): the CLI starts N processes
on this host, rank r on cuda:(r mod the number of cards) or on the CPU
with --device cpu, joined by NCCL when each has a card of its own and by
gloo when they share one (parallel/mesh.py). With COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID set, this process is one rank of such a
group instead, as in the reference. Bucket batch sizes are multiples of
N; every rank reads the same batches and takes its rows; rank 0 alone
writes the checkpoints (full weights and optimizer state, which one
process restores) and the metrics. With one rank there is no process
group. Tensor parallelism is an API (parallel.make_mesh(n_data,
n_model) and TrainStep(mesh=...)), not a flag, as in the reference.
`--pallas-ctc` sets ModelConfig.pallas_ctc as bin/train.py does; the
port reads it nowhere, since the device picks the CTC loss's route (the
kernels on the card, their plain versions on the CPU). `--params-npz`
starts from flax params of tpu_asr (see tpu_asr_torch.weights);
otherwise the weights are a seeded random init. A caller in Python may
also change the preset's ModelConfig (`build_solver(...,
model_overrides=...)`, e.g. {"use_pallas": True}); as in bin/train.py no
flag does that.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from tpu_asr_torch.configs.presets import TrainConfig, get_preset
from tpu_asr_torch.data import (DataLoader, Utterance, load_manifest,
                                make_buckets)
from tpu_asr_torch.models import build_model
from tpu_asr_torch.models.config import ModelConfig, WhisperConfig
from tpu_asr_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                         spawn_ranks)
from tpu_asr_torch.train.checkpoints import Checkpointer
from tpu_asr_torch.train.loop import Solver, TrainStep, model_lfr
from tpu_asr_torch.train.metrics import MetricsWriter
from tpu_asr_torch.train.optim import NoamAdam
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.weights import init_random, load_jax_params


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.train",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="aishell",
                   help="aishell | hybrid | hybrid_dev | attention | "
                        "attention_lfr | ctc_dev | conformer | "
                        "conformer_dev | cif | "
                        "cif_dev | transducer | transducer_dev | "
                        "conformer_transducer | conformer_transducer_dev "
                        "| transducer_streaming | streaming")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances (demo/smoke)")
    p.add_argument("--train-manifest")
    p.add_argument("--cv-manifest")
    p.add_argument("--save-folder", required=True)
    p.add_argument("--vocab-size", type=int, default=0)
    p.add_argument("--dict", dest="dict_path",
                   help="token dict file (sets the vocab size unless "
                        "--vocab-size does)")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-frames", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0,
                   help="fixed utterances per batch (overrides the "
                        "batch-frames budget)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--accum-steps", type=int, default=0,
                   help="apply the optimizer every k-th batch on averaged "
                        "gradients")
    p.add_argument("--lr-k", type=float, default=0.0)
    p.add_argument("--no-specaug", action="store_true",
                   help="disable SpecAugment even if the preset enables it")
    p.add_argument("--specaug-warp", type=int, default=-1,
                   help="SpecAugment time-warp window W (0 = masking only, "
                        "the reference's behaviour; -1 = preset default)")
    p.add_argument("--dtype", default="", choices=["", "bf16", "f32"],
                   help="override the preset's compute dtype")
    p.add_argument("--enc-chunk-size", type=int, default=-1,
                   help="encoder frames a chunk of the chunk-masked "
                        "(streaming) encoder; -1 = preset default, 0 = "
                        "full context")
    p.add_argument("--enc-left-chunks", type=int, default=-2,
                   help="chunks of left context (-1 = unbounded; -2 = "
                        "preset default)")
    p.add_argument("--pallas-ctc", type=int, default=-1, choices=[-1, 0, 1],
                   help="override the preset's pallas_ctc (1/0; -1 = "
                        "preset default); kept for the reference's CLI: "
                        "the card always takes the CTC kernels")
    p.add_argument("--cmvn", default="",
                   choices=["", "utterance", "global", "none"],
                   help="feature normalization: per-utterance (the "
                        "default), global train-set stats (--cmvn-stats), "
                        "or none")
    p.add_argument("--cmvn-stats", default="",
                   help=".npz of python -m tpu_asr_torch.compute_cmvn "
                        "(with --cmvn global)")
    p.add_argument("--pitch", action="store_true",
                   help="append 3 Kaldi-style pitch dims (POV, normalized "
                        "log-pitch, delta-pitch) to the fbank, the "
                        "reference recipe's fbank+pitch features (wav "
                        "manifests: the frontend computes them)")
    p.add_argument("--print-freq", type=int, default=0,
                   help="a train metrics line every N steps (0 = preset)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on the first step whose loss or gradient "
                        "norm is not finite (a host sync a step)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of steps "
                        "10-15 of the first epoch there")
    p.add_argument("--continue-from",
                   help="checkpoint folder to resume from (its latest step)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the init, data order, SpecAugment and "
                        "dropout (preset default if unset)")
    p.add_argument("--params-npz",
                   help="start from flax params of the preset's tpu_asr "
                        "model (Transformer, CifModel or TransducerModel) "
                        "saved as .npz with '/'-joined keys")
    p.add_argument("--num-devices", type=int, default=0,
                   help="data-parallel ranks (0 = all visible cards; 1 "
                        "with --device cpu)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def configure(args, model_overrides: dict | None = None
              ) -> tuple[TrainConfig, ModelConfig]:
    """The preset with the flags' overrides applied, and then
    `model_overrides` (ModelConfig fields) to its model."""
    tc = get_preset(args.preset)
    if isinstance(tc.model, WhisperConfig):
        raise SystemExit(f"{args.preset}: the port serves Whisper "
                         f"(recognize, serve) and does not train it")
    vocab = args.vocab_size
    if not vocab and args.dict_path:
        from tpu_asr_torch.utils.vocab import Vocab
        vocab = len(Vocab.load(args.dict_path))
    vocab = vocab or (64 if args.synthetic else tc.model.vocab_size)
    overrides = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_frames", args.batch_frames),
        ("batch_size", args.batch_size), ("warmup_steps", args.warmup_steps),
        ("accum_steps", args.accum_steps), ("lr_k", args.lr_k),
        ("print_freq", args.print_freq)) if v}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.no_specaug:
        overrides["specaug"] = None
    elif args.specaug_warp >= 0 and tc.specaug is not None:
        overrides["specaug"] = dataclasses.replace(
            tc.specaug, time_warp_window=args.specaug_warp)
    if args.cmvn:
        if args.cmvn == "global" and not args.cmvn_stats:
            raise SystemExit("--cmvn global needs --cmvn-stats")
        overrides["frontend"] = dataclasses.replace(
            tc.frontend, cmvn_mode=args.cmvn,
            cmvn_stats_path=(os.path.abspath(args.cmvn_stats)
                             if args.cmvn_stats else ""))
    if args.pitch:
        overrides["frontend"] = dataclasses.replace(
            overrides.get("frontend", tc.frontend), add_pitch=True)
    tc = dataclasses.replace(tc, **overrides)
    model = {"vocab_size": vocab}
    if args.dtype:
        model["dtype"] = {"bf16": torch.bfloat16,
                          "f32": torch.float32}[args.dtype]
    if args.enc_chunk_size >= 0:
        model["enc_chunk_size"] = args.enc_chunk_size
    if args.enc_left_chunks >= -1:
        model["enc_left_chunks"] = args.enc_left_chunks
    if args.pallas_ctc in (0, 1):
        model["pallas_ctc"] = bool(args.pallas_ctc)
    return tc, dataclasses.replace(tc.model, **model,
                                   **(model_overrides or {}))


def load_data(args, tc: TrainConfig, vocab: int):
    """-> (train utterances, cv utterances, mode, in-memory waves)."""
    if args.synthetic:
        from tpu_asr_torch.data.synthetic import make_synthetic_dataset
        utts, waves = make_synthetic_dataset(args.synthetic, vocab,
                                             seed=tc.seed)
        n_cv = max(args.synthetic // 10, 1)
        return utts[n_cv:], utts[:n_cv], "wav", waves
    if not (args.train_manifest and args.cv_manifest):
        raise SystemExit("--train-manifest and --cv-manifest (or "
                         "--synthetic N) are required")
    train_utts = load_manifest(args.train_manifest)
    cv_utts = load_manifest(args.cv_manifest)
    mode = "wav" if train_utts and train_utts[0].wav else "feat"
    return train_utts, cv_utts, mode, None


def build_solver(args, data: tuple[list[Utterance], list[Utterance], str,
                                   dict | None] | None = None,
                 model_overrides: dict | None = None) -> Solver:
    """Everything `main` trains with, built from the flags. `data`
    replaces the flags' data source with (train utterances, cv
    utterances, mode, in-memory waves); `model_overrides` replaces fields
    of the preset's ModelConfig (saved with the checkpoint). In a rank
    of a process group (initialize_distributed) it trains data-parallel
    over all ranks; only rank 0's Solver writes."""
    device = initialize_distributed(args.device) or resolve_device(
        args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.num_devices not in (0, world):
        raise SystemExit(f"--num-devices {args.num_devices} in a group of "
                         f"{world} ranks")
    mesh = make_mesh(n_data=world) if world > 1 else None
    rank0 = mesh is None or mesh.rank == 0
    tc, mc = configure(args, model_overrides)
    train_utts, cv_utts, mode, waves = data or load_data(args, tc,
                                                         mc.vocab_size)
    scale = tc.frontend.frame_shift if mode == "wav" else 1
    length_key = "num_samples" if mode == "wav" else "num_frames"
    buckets = make_buckets(
        train_utts, num_buckets=tc.num_buckets,
        batch_frames=tc.batch_frames * scale,
        max_frames_cap=tc.max_frames_cap * scale,
        max_tokens_cap=tc.max_tokens_cap, length_key=length_key,
        batch_size=tc.batch_size, batch_multiple=world)
    print(f"buckets: {buckets}", file=sys.stderr)
    train_loader = DataLoader(train_utts, buckets, mode=mode, waves=waves,
                              seed=tc.seed)
    cv_loader = DataLoader(cv_utts, buckets, mode=mode, waves=waves,
                           shuffle=False)
    # the input width the data gives (the reference's flax model infers
    # it at init; the port's input layer is built here)
    d_input = (tc.frontend.feature_dim if mode == "wav" else
               train_loader.load_input(train_utts[0]).shape[1])
    mc = dataclasses.replace(mc, d_input=d_input)

    # dropout draws from this: alike on a data row's (model axis) ranks,
    # apart between the data shards
    torch.manual_seed(tc.seed + (0 if mesh is None else mesh.data.index))
    model = build_model(mc)
    if args.params_npz:
        load_jax_params(model, args.params_npz)
    else:
        init_random(model, tc.seed)
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {mc.model_type}, {n_params / 1e6:.1f}M params on "
          f"{device}", file=sys.stderr)
    opt = NoamAdam(model.parameters(), mc.d_model, tc.warmup_steps,
                   tc.lr_k, tc.grad_clip, tc.accum_steps)
    step = TrainStep(model, opt, tc.specaug, tc.frontend, device,
                     seed=tc.seed, debug_nans=args.debug_nans,
                     lfr=model_lfr(mc), mesh=mesh)

    ck = None
    if rank0:
        ck = Checkpointer(args.save_folder)
        ck.save_config(mc)
        ck.save_frontend(tc.frontend)
    start_epoch = 0
    if args.continue_from:
        state = Checkpointer(args.continue_from).restore()
        step.load_state_dict(state)
        start_epoch = state["meta"]["epoch"] + 1
        print(f"resumed from step {step.steps} (epoch {start_epoch})",
              file=sys.stderr)
    return Solver(step, train_loader, cv_loader, epochs=tc.epochs,
                  print_freq=tc.print_freq, checkpointer=ck,
                  metrics_writer=MetricsWriter(
                      os.path.join(args.save_folder, "metrics.jsonl"))
                  if rank0 else None,
                  start_epoch=start_epoch,
                  profile_dir=(args.profile_dir or None) if rank0 else None)


def train(argv=None) -> None:
    """Build the Solver from the flags and train (one rank's part)."""
    solver = build_solver(parse_args(argv))
    try:
        solver.train()
    finally:
        if solver.metrics_writer:
            solver.metrics_writer.close()
    print("done", file=sys.stderr)


def world_size(args) -> int:
    """--num-devices, 0 meaning every visible card (1 on the CPU)."""
    if args.num_devices:
        return args.num_devices
    if args.device is not None and torch.device(args.device).type == "cpu":
        return 1
    return max(torch.cuda.device_count(), 1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    n = world_size(args)
    if n > 1 and not os.environ.get("COORDINATOR_ADDRESS"):
        spawn_ranks("tpu_asr_torch.train.__main__:train", n, argv)
    else:
        train(argv)


if __name__ == "__main__":
    main()
