"""Language-model training CLI of the PyTorch port (port of
bin/train_lm.py).

Trains the character-level TransformerLM (models/lm.py) on the token
transcripts of ASR manifests, for shallow fusion and n-best rescoring in
`python -m tpu_asr_torch.recognize` / `serve` (--lm-ckpt, --lm-weight):

  python -m tpu_asr_torch.train_lm --train-manifest train.jsonl \\
      --cv-manifest dev.jsonl --vocab-size 4233 --save-folder exp/lm
  python -m tpu_asr_torch.train_lm --synthetic 64 --save-folder exp/lm \\
      --device cpu

Every batch has one static shape [batch_size, u_max + 1]: partial
batches pad with dummy rows whose IGNORE_ID targets carry no loss.
Label-smoothed CE, Adam under the Noam schedule with global-norm
clipping; dropout draws from one explicit generator (seeded by --seed,
saved with the checkpoint). Per epoch: the cv loss, a checkpoint (the
best by cv loss marked), lm_config.json and a metrics.jsonl line. Runs
on the CUDA card unless given --device cpu; with no card and no such
flag it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from tpu_asr_torch import IGNORE_ID
from tpu_asr_torch.models.lm import LMConfig, TransformerLM, save_lm_config
from tpu_asr_torch.ops.losses import label_smoothing_loss
from tpu_asr_torch.train.checkpoints import Checkpointer
from tpu_asr_torch.train.metrics import MetricsWriter
from tpu_asr_torch.train.optim import NoamAdam, global_norm
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.weights import init_random


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_asr_torch.train_lm",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--train-manifest")
    p.add_argument("--cv-manifest")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic transcripts (demo/smoke)")
    p.add_argument("--save-folder", required=True)
    p.add_argument("--vocab-size", type=int, default=0)
    p.add_argument("--dict", dest="dict_path",
                   help="token dict file (sets the vocab size)")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--d-inner", type=int, default=1024)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--lr-k", type=float, default=0.5)
    p.add_argument("--grad-clip", type=float, default=5.0)
    p.add_argument("--continue-from",
                   help="LM checkpoint folder to resume from (its latest "
                        "step)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_token_corpus(args, vocab_size: int):
    """-> (train token lists, cv token lists, vocab_size)."""
    if args.synthetic:
        from tpu_asr_torch.data.synthetic import make_synthetic_dataset
        vocab_size = vocab_size or 64
        utts, _ = make_synthetic_dataset(args.synthetic, vocab_size,
                                         seed=args.seed)
        n_cv = max(args.synthetic // 10, 1)
        return ([u.tokens for u in utts[n_cv:]],
                [u.tokens for u in utts[:n_cv]], vocab_size)
    from tpu_asr_torch.data import load_manifest
    if not (args.train_manifest and args.cv_manifest):
        raise SystemExit("--train-manifest and --cv-manifest (or "
                         "--synthetic N) are required")
    if not vocab_size:
        raise SystemExit("--vocab-size or --dict is required")
    return ([u.tokens for u in load_manifest(args.train_manifest)],
            [u.tokens for u in load_manifest(args.cv_manifest)], vocab_size)


def make_batches(seqs, batch_size, u_max, sos, eos, ignore_id=IGNORE_ID,
                 rng=None):
    """Token lists -> list of (ys_in [B, u_max+1], targets [B, u_max+1])
    int32 numpy batches; sequence i contributes P(y_1..y_U, eos | sos).
    rng (a numpy Generator) shuffles the order."""
    order = np.arange(len(seqs))
    if rng is not None:
        rng.shuffle(order)
    batches = []
    for lo in range(0, len(seqs), batch_size):
        ys_in = np.full((batch_size, u_max + 1), eos, np.int32)
        tgt = np.full((batch_size, u_max + 1), ignore_id, np.int32)
        for r, i in enumerate(order[lo: lo + batch_size]):
            toks = seqs[i][:u_max]
            ys_in[r, 0] = sos
            ys_in[r, 1: 1 + len(toks)] = toks
            tgt[r, : len(toks)] = toks
            tgt[r, len(toks)] = eos
        batches.append((ys_in, tgt))
    return batches


class LMTrainStep:
    """One optimizer step of the LM per call: teacher-forced forward
    (dropout on), label-smoothed CE, backward, clip, Adam. Dropout draws
    from torch's generators reseeded from `gen` (a CPU generator seeded
    with `seed`) each step inside torch.random.fork_rng, so the draws are
    a function of `gen` alone and the global generators are untouched."""

    def __init__(self, lm: TransformerLM, optimizer: NoamAdam,
                 smoothing: float = 0.0, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.lm = lm.to(self.device)
        self.optimizer = optimizer
        self.smoothing = smoothing
        self.gen = torch.Generator().manual_seed(seed)
        self.steps = 0

    def __call__(self, ys_in, tgt) -> dict[str, torch.Tensor]:
        """-> {"loss", "n_tok", "grad_norm"} as 0-d device tensors."""
        self.lm.train()
        ys_in = torch.as_tensor(ys_in).to(self.device).long()
        tgt = torch.as_tensor(tgt).to(self.device).long()
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.gen))
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(seed)
            loss, n_tok = label_smoothing_loss(self.lm(ys_in), tgt,
                                               self.smoothing)
            grads = list(torch.autograd.grad(loss, self.optimizer.params))
        norm = global_norm(grads)
        self.optimizer.update(grads, norm)
        self.steps += 1
        return {"loss": loss.detach(), "n_tok": n_tok, "grad_norm": norm}

    def state_dict(self) -> dict:
        return {"model": self.lm.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.steps,
                "generators": {"dropout": self.gen.get_state()}}

    def load_state_dict(self, state: dict) -> None:
        self.lm.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps = state["step"]
        self.gen.set_state(state["generators"]["dropout"])


@torch.no_grad()
def evaluate(lm: TransformerLM, batches, device, smoothing: float = 0.0
             ) -> float:
    """Token-weighted mean loss over `batches`, dropout off."""
    lm.eval()
    losses, counts = [], []
    for ys_in, tgt in batches:
        loss, n_tok = label_smoothing_loss(
            lm(torch.as_tensor(ys_in).to(device).long()),
            torch.as_tensor(tgt).to(device).long(), smoothing)
        losses.append(loss)
        counts.append(n_tok)
    return _weighted_mean(losses, counts)


def _weighted_mean(losses, counts) -> float:
    """sum(loss * count) / sum(count), read in one device-to-host copy."""
    if not losses:
        return float("nan")
    both = torch.stack([torch.stack(losses).double(),
                        torch.stack(counts).double()]).cpu()
    return float((both[0] * both[1]).sum() / both[1].sum().clamp(min=1))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    vocab_size = args.vocab_size
    if args.dict_path and not vocab_size:
        from tpu_asr_torch.utils.vocab import Vocab
        vocab_size = len(Vocab.load(args.dict_path))
    train_seqs, cv_seqs, vocab_size = load_token_corpus(args, vocab_size)
    sos, eos = vocab_size - 2, vocab_size - 1
    u_max = max(len(s) for s in train_seqs + cv_seqs)

    cfg = LMConfig(vocab_size=vocab_size, d_model=args.d_model,
                   d_inner=args.d_inner, num_heads=args.num_heads,
                   num_layers=args.num_layers, dropout=args.dropout)
    lm = init_random(TransformerLM(cfg), args.seed)
    opt = NoamAdam(lm.parameters(), cfg.d_model, args.warmup_steps,
                   args.lr_k, args.grad_clip)
    step = LMTrainStep(lm, opt, args.label_smoothing, device, args.seed)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"lm: {n_params / 1e6:.1f}M params, u_max={u_max}, "
          f"vocab={vocab_size} on {device}", file=sys.stderr)

    ck = Checkpointer(args.save_folder)
    save_lm_config(args.save_folder, cfg)
    start_epoch = 0
    if args.continue_from:
        state = Checkpointer(args.continue_from).restore()
        step.load_state_dict(state)
        start_epoch = state["meta"]["epoch"] + 1
        print(f"resumed from step {step.steps} (epoch {start_epoch})",
              file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    cv_batches = make_batches(cv_seqs, args.batch_size, u_max, sos, eos)
    mw = MetricsWriter(os.path.join(args.save_folder, "metrics.jsonl"))
    best_cv = float("inf")
    try:
        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            metrics = [step(ys_in, tgt) for ys_in, tgt in make_batches(
                train_seqs, args.batch_size, u_max, sos, eos, rng=rng)]
            tr_loss = _weighted_mean([m["loss"] for m in metrics],
                                     [m["n_tok"] for m in metrics])
            cv_loss = evaluate(lm, cv_batches, device, args.label_smoothing)
            is_best = cv_loss < best_cv
            best_cv = min(best_cv, cv_loss)
            ck.save(step.state_dict(), step=step.steps, epoch=epoch,
                    cv_loss=cv_loss, is_best=is_best)
            mw.write({"epoch": epoch, "step": step.steps, "phase": "cv",
                      "loss": cv_loss, "ppl": float(np.exp(cv_loss)),
                      "train_loss": tr_loss,
                      "train_ppl": float(np.exp(tr_loss)),
                      "epoch_sec": time.time() - t0})
    finally:
        mw.close()
    print("done", file=sys.stderr)


if __name__ == "__main__":
    main()
