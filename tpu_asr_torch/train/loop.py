"""Training loop: the train and eval steps and the epoch-level Solver (port
of tpu_asr/train/loop.py).

TrainStep runs SpecAugment -> LFR (linear-input models) -> forward
(dropout on) -> backward ->
grad_norm of the raw gradients -> clip -> Adam, as the reference's one
jitted step does. Parameters stay float32; each Dense casts them to the
compute dtype at use (as flax does), so autograd returns float32
gradients. Steps return their metrics as device tensors: the Solver reads
them on the host only every `print_freq` steps and once per epoch, so the
host does not wait for the card at every step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import torch

from tpu_asr_torch.augment import SpecAugmentConfig, spec_augment
from tpu_asr_torch.frontend import (FrontendConfig, build_lfr_features,
                                    cmvn_stats_for, lfr_length,
                                    wav_to_features)
from tpu_asr_torch.train.optim import NoamAdam, global_norm
from tpu_asr_torch.utils.device import resolve_device

# the train steps of the first epoch that Solver(profile_dir=...) traces:
# from the first to before the second (the reference's 10..15)
PROFILE_STEPS = (10, 15)


def batch_features(batch: dict, frontend: FrontendConfig,
                   device: torch.device, cmvn_stats=None):
    """A loader batch (numpy or tensors) -> (feats [B, T, D] float32,
    feat_lengths [B], targets [B, U] int64, target_lengths [B]) on
    `device`; wav batches go through the frontend there (`cmvn_stats`:
    cmvn_stats_for's pair on `device`)."""
    def get(key):
        return torch.as_tensor(batch[key]).to(device, non_blocking=True)

    if "wav" in batch:
        feats, flens = wav_to_features(get("wav"), get("wav_lengths"),
                                       frontend, cmvn_stats=cmvn_stats)
    else:
        feats, flens = get("feats").float(), get("feat_lengths")
    return feats, flens, get("targets").long(), get("target_lengths")


def apply_lfr(feats, feat_lengths, lfr: tuple[int, int]):
    """LFR stacking (frontend.build_lfr_features) for linear-input
    models; (1, 1) passes the features through."""
    m, n = lfr
    if (m, n) == (1, 1):
        return feats, feat_lengths
    return build_lfr_features(feats, m, n), lfr_length(feat_lengths, n)


def model_lfr(cfg) -> tuple[int, int]:
    """The (m, n) LFR a model takes: (lfr_m, lfr_n) for the linear input
    layer, else (1, 1)."""
    return (cfg.lfr_m, cfg.lfr_n) if cfg.input_layer == "linear" else (1, 1)


class TrainStep:
    """One optimizer step per call (one micro-step with accum_steps > 1).

    device None means the CUDA card (RuntimeError when there is none);
    pass device="cpu" to train on the CPU. SpecAugment draws from the
    step's own generator on the device, seeded with `seed`; dropout draws
    from torch's generator of that device (the CLI seeds it). `lfr`
    (model_lfr of the model's config) stacks the features after
    SpecAugment, as the reference's step does. With debug_nans, a step
    whose loss or raw gradient norm is not finite raises
    FloatingPointError before the update (a host sync a step)."""

    def __init__(self, model, optimizer: NoamAdam,
                 specaug: SpecAugmentConfig | None = None,
                 frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None, seed: int = 0,
                 debug_nans: bool = False, lfr: tuple[int, int] = (1, 1)):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.specaug = specaug
        self.lfr = tuple(lfr)
        self.frontend = frontend or FrontendConfig()
        self.cmvn_stats = cmvn_stats_for(self.frontend, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.debug_nans = debug_nans
        self.steps = 0       # calls taken (micro-batches)

    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        """-> metrics: the model's loss dict (loss, loss_att, acc and
        loss_ctc or loss_qty as the model has them) and grad_norm (0-d
        device tensors; grad_norm of the raw, unclipped gradients)."""
        self.model.train()
        feats, flens, targets, tlens = batch_features(
            batch, self.frontend, self.device, self.cmvn_stats)
        if self.specaug is not None:
            feats = spec_augment(self.gen, feats, flens, self.specaug)
        feats, flens = apply_lfr(feats, flens, self.lfr)
        out = self.model(feats, flens, targets, tlens)
        grads = list(torch.autograd.grad(out["loss"],
                                         self.optimizer.params))
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["grad_norm"] = global_norm(grads)
        if self.debug_nans and not bool(torch.isfinite(torch.stack(
                [metrics["loss"].float(), metrics["grad_norm"]])).all()):
            raise FloatingPointError(
                f"step {self.steps}: loss {float(metrics['loss'])}, grad "
                f"norm {float(metrics['grad_norm'])}")
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
    """Forward without dropout or SpecAugment (LFR as TrainStep) -> the
    model's loss dict."""

    def __init__(self, model, frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None,
                 lfr: tuple[int, int] = (1, 1)):
        self.device = resolve_device(device)
        self.model = model
        self.frontend = frontend or FrontendConfig()
        self.cmvn_stats = cmvn_stats_for(self.frontend, self.device)
        self.lfr = tuple(lfr)

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        self.model.eval()
        feats, flens, targets, tlens = batch_features(
            batch, self.frontend, self.device, self.cmvn_stats)
        feats, flens = apply_lfr(feats, flens, self.lfr)
        return self.model(feats, flens, targets, tlens)


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
    """Epoch-level loop: train and cv phases (the cv steps take the
    train step's frontend and LFR), metrics every print_freq steps, a
    checkpoint per epoch, best by cv loss, optional half_lr on a cv
    plateau and early stop. `history` holds one record per epoch (the
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
    profile_dir: str | None = None  # torch.profiler trace of PROFILE_STEPS
    history: list = dataclasses.field(default_factory=list)

    def train(self) -> TrainStep:
        ts = self.train_step
        eval_step = EvalStep(ts.model, ts.frontend, ts.device, ts.lfr)
        best_cv = float("inf")
        bad_epochs = 0
        profiler = None
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            n_batches = 0
            step_metrics = []      # device scalars, read once at epoch end
            for batch in self.train_loader:
                if self.profile_dir and epoch == self.start_epoch:
                    profiler = self._profile(n_batches, profiler)
                metrics = ts(batch)
                n_batches += 1
                if n_batches % self.print_freq == 0 and self.metrics_writer:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(epoch=epoch, step=ts.steps, phase="train",
                             lr=ts.optimizer.lr,
                             steps_per_sec=n_batches / (time.time() - t0))
                    self.metrics_writer.write(m)
                step_metrics.append(metrics)
            if profiler is not None:           # the epoch ended early
                profiler = self._profile(PROFILE_STEPS[1], profiler)
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

    def _profile(self, n_batches: int, profiler):
        """Start torch.profiler before train step PROFILE_STEPS[0] of the
        first epoch, and stop it before step PROFILE_STEPS[1] (or at the
        end of a shorter epoch), writing profile_dir/trace.json. ->
        the running profiler or None."""
        from torch.profiler import ProfilerActivity, profile
        first, last = PROFILE_STEPS
        if profiler is None and n_batches == first:
            activities = [ProfilerActivity.CPU]
            if self.train_step.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        elif profiler is not None and n_batches >= last:
            if self.train_step.device.type == "cuda":
                torch.cuda.synchronize(self.train_step.device)
            profiler.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(
                os.path.join(self.profile_dir, "trace.json"))
            profiler = None
        return profiler
