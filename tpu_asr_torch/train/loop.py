"""Training loop: the train and eval steps and the epoch-level Solver (port
of tpu_asr/train/loop.py).

TrainStep runs SpecAugment -> forward (dropout on) -> backward ->
grad_norm of the raw gradients -> clip -> Adam, as the reference's one
jitted step does. Parameters stay float32; each Dense casts them to the
compute dtype at use (as flax does), so autograd returns float32
gradients. Steps return their metrics as device tensors: the Solver reads
them on the host only every `print_freq` steps and once per epoch, so the
host does not wait for the card at every step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from tpu_asr_torch.augment import SpecAugmentConfig, spec_augment
from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
from tpu_asr_torch.train.optim import NoamAdam, global_norm
from tpu_asr_torch.utils.device import resolve_device


def batch_features(batch: dict, frontend: FrontendConfig,
                   device: torch.device):
    """A loader batch (numpy or tensors) -> (feats [B, T, D] float32,
    feat_lengths [B], targets [B, U] int64, target_lengths [B]) on
    `device`; wav batches go through the frontend there."""
    def get(key):
        return torch.as_tensor(batch[key]).to(device, non_blocking=True)

    if "wav" in batch:
        feats, flens = wav_to_features(get("wav"), get("wav_lengths"),
                                       frontend)
    else:
        feats, flens = get("feats").float(), get("feat_lengths")
    return feats, flens, get("targets").long(), get("target_lengths")


class TrainStep:
    """One optimizer step per call (one micro-step with accum_steps > 1).

    device None means the CUDA card (RuntimeError when there is none);
    pass device="cpu" to train on the CPU. SpecAugment draws from the
    step's own generator on the device, seeded with `seed`; dropout draws
    from torch's generator of that device (the CLI seeds it)."""

    def __init__(self, model, optimizer: NoamAdam,
                 specaug: SpecAugmentConfig | None = None,
                 frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None, seed: int = 0):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.specaug = specaug
        self.frontend = frontend or FrontendConfig()
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0       # calls taken (micro-batches)

    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        """-> metrics: the model's loss dict (loss, loss_att, acc and
        loss_ctc or loss_qty as the model has them) and grad_norm (0-d
        device tensors; grad_norm of the raw, unclipped gradients)."""
        self.model.train()
        feats, flens, targets, tlens = batch_features(batch, self.frontend,
                                                      self.device)
        if self.specaug is not None:
            feats = spec_augment(self.gen, feats, flens, self.specaug)
        out = self.model(feats, flens, targets, tlens)
        grads = list(torch.autograd.grad(out["loss"],
                                         self.optimizer.params))
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["grad_norm"] = global_norm(grads)
        self.optimizer.update(grads, metrics["grad_norm"])
        self.steps += 1
        return metrics

    def state_dict(self) -> dict:
        gens = {"specaug": self.gen.get_state(),
                "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            gens["cuda"] = torch.cuda.get_rng_state(self.device)
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.steps, "generators": gens}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps = state["step"]
        gens = state["generators"]
        self.gen.set_state(gens["specaug"])
        torch.set_rng_state(gens["torch"])
        if self.device.type == "cuda" and "cuda" in gens:
            torch.cuda.set_rng_state(gens["cuda"], self.device)


class EvalStep:
    """Forward without dropout or SpecAugment -> the model's loss dict."""

    def __init__(self, model, frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model
        self.frontend = frontend or FrontendConfig()

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        self.model.eval()
        return self.model(*batch_features(batch, self.frontend, self.device))


def _mean(values: list[torch.Tensor]) -> float:
    return float(torch.stack(values).float().mean()) if values else 0.0


def _epoch_summary(step_metrics: list[dict]) -> dict:
    """Train loss, largest grad norm and count of steps whose loss or
    grad norm is not finite, in one device-to-host copy."""
    if not step_metrics:
        return dict(train_loss=0.0, grad_norm_max=0.0, nonfinite_steps=0)
    both = torch.stack([torch.stack([m["loss"].float(), m["grad_norm"]])
                        for m in step_metrics]).cpu()
    finite = torch.isfinite(both).all(dim=1)
    return dict(train_loss=float(both[:, 0].mean()),
                grad_norm_max=float(both[:, 1].max()),
                nonfinite_steps=int((~finite).sum()))


@dataclasses.dataclass
class Solver:
    """Epoch-level loop: train and cv phases, metrics every print_freq
    steps, a checkpoint per epoch, best by cv loss, optional half_lr on a
    cv plateau and early stop. `history` holds one record per epoch (the
    cv line of the metrics, with the epoch's step and cv-batch counts)."""
    train_step: TrainStep
    train_loader: Any            # iterable of batch dicts per epoch
    cv_loader: Any
    epochs: int = 30
    print_freq: int = 10
    checkpointer: Any = None     # tpu_asr_torch.train.checkpoints.Checkpointer
    metrics_writer: Any = None   # tpu_asr_torch.train.metrics.MetricsWriter
    early_stop_patience: int = 0  # 0 = off
    start_epoch: int = 0          # set by resume (continue_from)
    half_lr: bool = False         # halve the lr when cv loss stops improving
    history: list = dataclasses.field(default_factory=list)

    def train(self) -> TrainStep:
        ts = self.train_step
        eval_step = EvalStep(ts.model, ts.frontend, ts.device)
        best_cv = float("inf")
        bad_epochs = 0
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            n_batches = 0
            step_metrics = []      # device scalars, read once at epoch end
            for batch in self.train_loader:
                metrics = ts(batch)
                n_batches += 1
                if n_batches % self.print_freq == 0 and self.metrics_writer:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(epoch=epoch, step=ts.steps, phase="train",
                             lr=ts.optimizer.lr,
                             steps_per_sec=n_batches / (time.time() - t0))
                    self.metrics_writer.write(m)
                step_metrics.append(metrics)
            summary = _epoch_summary(step_metrics)
            cv_losses = [eval_step(b)["loss"] for b in self.cv_loader]
            cv_loss = _mean(cv_losses)
            record = dict(epoch=epoch, step=ts.steps, phase="cv",
                          loss=cv_loss, **summary, train_steps=n_batches,
                          cv_batches=len(cv_losses),
                          epoch_sec=time.time() - t0)
            self.history.append(record)
            if self.metrics_writer:
                self.metrics_writer.write(record)
            is_best = cv_loss < best_cv
            best_cv = min(best_cv, cv_loss)
            if self.checkpointer:
                self.checkpointer.save(ts.state_dict(), step=ts.steps,
                                       epoch=epoch, cv_loss=cv_loss,
                                       is_best=is_best)
            if not is_best and self.half_lr:
                ts.optimizer.lr_scale *= 0.5      # Adam moments carry over
                if self.metrics_writer:
                    self.metrics_writer.write(
                        dict(epoch=epoch, event="half_lr",
                             lr_scale=ts.optimizer.lr_scale))
            if self.early_stop_patience:
                bad_epochs = 0 if is_best else bad_epochs + 1
                if bad_epochs >= self.early_stop_patience:
                    break
        return ts
