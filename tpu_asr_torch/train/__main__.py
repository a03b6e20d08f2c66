"""Training CLI of the PyTorch port (port of bin/train.py).

  python -m tpu_asr_torch.train --preset aishell --train-manifest train.jsonl \\
      --cv-manifest dev.jsonl --save-folder exp/aishell --vocab-size 4233
  python -m tpu_asr_torch.train --preset hybrid_dev --synthetic 200 \\
      --save-folder exp/dev --device cpu
  python -m tpu_asr_torch.train --preset cif_dev --synthetic 32 --epochs 2 \\
      --save-folder exp/cif_dev --device cpu

Preset + flag overrides -> bucketed loaders -> TrainStep/Solver with a
checkpoint per epoch and JSONL metrics in the save folder. Runs on the
CUDA card unless given --device cpu; with no card and no such flag it
raises. The preset's model_type picks the model (models.build_model:
the hybrid Transformer or the CIF model). `--params-npz` starts from
flax params of tpu_asr (see tpu_asr_torch.weights); otherwise the
weights are a seeded random init. A caller in Python may also change
the preset's ModelConfig (`build_solver(..., model_overrides=...)`, e.g.
{"use_pallas": True}); as in bin/train.py no flag does that.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from tpu_asr_torch.configs.presets import TrainConfig, get_preset
from tpu_asr_torch.data import (DataLoader, Utterance, load_manifest,
                                make_buckets)
from tpu_asr_torch.models import build_model
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.train.checkpoints import Checkpointer
from tpu_asr_torch.train.loop import Solver, TrainStep
from tpu_asr_torch.train.metrics import MetricsWriter
from tpu_asr_torch.train.optim import NoamAdam
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.weights import init_random, load_jax_params


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.train",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="aishell",
                   help="aishell | hybrid_dev | cif | cif_dev")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances (demo/smoke)")
    p.add_argument("--train-manifest")
    p.add_argument("--cv-manifest")
    p.add_argument("--save-folder", required=True)
    p.add_argument("--vocab-size", type=int, default=0)
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
    p.add_argument("--continue-from",
                   help="checkpoint folder to resume from (its latest step)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the init, data order, SpecAugment and "
                        "dropout (preset default if unset)")
    p.add_argument("--params-npz",
                   help="start from flax params of the preset's tpu_asr "
                        "model (Transformer or CifModel) saved as .npz "
                        "with '/'-joined keys")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def configure(args, model_overrides: dict | None = None
              ) -> tuple[TrainConfig, ModelConfig]:
    """The preset with the flags' overrides applied, and then
    `model_overrides` (ModelConfig fields) to its model."""
    tc = get_preset(args.preset)
    vocab = args.vocab_size or (64 if args.synthetic else
                                tc.model.vocab_size)
    overrides = {k: v for k, v in (
        ("epochs", args.epochs), ("batch_frames", args.batch_frames),
        ("batch_size", args.batch_size), ("warmup_steps", args.warmup_steps),
        ("accum_steps", args.accum_steps), ("lr_k", args.lr_k)) if v}
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.no_specaug:
        overrides["specaug"] = None
    tc = dataclasses.replace(tc, **overrides)
    return tc, dataclasses.replace(tc.model, vocab_size=vocab,
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
    of the preset's ModelConfig (saved with the checkpoint)."""
    device = resolve_device(args.device)
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
        batch_size=tc.batch_size)
    print(f"buckets: {buckets}", file=sys.stderr)
    train_loader = DataLoader(train_utts, buckets, mode=mode, waves=waves,
                              seed=tc.seed)
    cv_loader = DataLoader(cv_utts, buckets, mode=mode, waves=waves,
                           shuffle=False)

    torch.manual_seed(tc.seed)            # dropout draws from this
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
                     seed=tc.seed)

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
                      os.path.join(args.save_folder, "metrics.jsonl")),
                  start_epoch=start_epoch)


def main(argv=None):
    solver = build_solver(parse_args(argv))
    try:
        solver.train()
    finally:
        solver.metrics_writer.close()
    print("done", file=sys.stderr)


if __name__ == "__main__":
    main()
