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

With a mesh (tpu_asr_torch.parallel), a step is the reference's step
under GSPMD, written out: every rank gets the same host batch and takes
its rows (shard_batch); the losses divide by the global batch's counts
(ops.losses.loss_counts), so each rank's loss is its part of the global
mean; SpecAugment is drawn for the whole batch from the step generator,
seeded alike on every rank, and each rank applies its rows' draws; the
gradients of the replicated parameters that tensor-parallel modules
read by slice are summed over the model axis, then every gradient and
every metric over the data axis; the gradient norm counts the sharded
blocks over the model axis. With dropout 0, a step on any layout equals
the single-process step up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any

import torch

from tpu_asr_torch.augment import (SpecAugmentConfig, apply_spec_augment,
                                   draw_spec_augment, spec_augment)
from tpu_asr_torch.frontend import (FrontendConfig, build_lfr_features,
                                    cmvn_stats_for, frame_lengths_of,
                                    lfr_length, wav_to_features)
from tpu_asr_torch.ops.losses import loss_counts
from tpu_asr_torch.parallel.mesh import batch_sharding, shard_batch
from tpu_asr_torch.parallel.sharding import (gather_params, shard_params,
                                             shard_tensor, sliced_params)
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


def global_counts(batch: dict, frontend: FrontendConfig,
                  device: torch.device):
    """A whole host batch -> (its feat lengths [B], loss_counts) on
    `device`: what a data-parallel shard needs of the batch it is cut
    from."""
    if "wav" in batch:
        flens = frame_lengths_of(torch.as_tensor(batch["wav_lengths"]),
                                 frontend)
    else:
        flens = torch.as_tensor(batch["feat_lengths"])
    counts = loss_counts(flens, torch.as_tensor(batch["targets"]).long(),
                         torch.as_tensor(batch["target_lengths"]))
    return flens.to(device), {k: v.to(device) for k, v in counts.items()}


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
    FloatingPointError before the update (a host sync a step).

    `mesh` (parallel.make_mesh) runs the step data- and tensor-parallel
    (see the module docstring): the model comes whole and the optimizer
    untouched, and TrainStep keeps this rank's blocks of the sharded
    weights (parallel.shard_params). Every rank of the mesh calls the
    step with the same host batch; the metrics it returns are the global
    ones. state_dict gathers the full weights and optimizer state (every
    rank of the model axis takes part), and load_state_dict takes such a
    full state on every rank."""

    def __init__(self, model, optimizer: NoamAdam,
                 specaug: SpecAugmentConfig | None = None,
                 frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None, seed: int = 0,
                 debug_nans: bool = False, lfr: tuple[int, int] = (1, 1),
                 mesh=None):
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
        self.mesh = mesh
        self.specs = None
        if mesh is not None:
            if optimizer.count or optimizer.adam.state:
                raise ValueError("shard the model before the optimizer "
                                 "takes a step")
            self.specs = shard_params(self.model, mesh)
            names = {id(p): n for n, p in self.model.named_parameters()}
            self._names = [names[id(p)] for p in optimizer.params]
            sliced = sliced_params(self.model)
            self._sliced = [n in sliced for n in self._names]
            if mesh.n_model > 1:
                optimizer.norm_fn = functools.partial(
                    global_norm, axis=mesh.model,
                    sharded=[self.specs[n] is not None for n in self._names])

    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        """-> metrics: the model's loss dict (loss, loss_att, acc and
        loss_ctc or loss_qty as the model has them) and grad_norm (0-d
        device tensors; grad_norm of the raw, unclipped gradients)."""
        self.model.train()
        extra = {}
        if self.mesh is not None:
            full_flens, extra["counts"] = global_counts(
                batch, self.frontend, self.device)
            rows = batch_sharding(self.mesh).rows(len(full_flens))
            batch = shard_batch(batch, self.mesh)
        feats, flens, targets, tlens = batch_features(
            batch, self.frontend, self.device, self.cmvn_stats)
        if self.specaug is not None and self.mesh is None:
            feats = spec_augment(self.gen, feats, flens, self.specaug)
        elif self.specaug is not None:
            draws = draw_spec_augment(self.gen, full_flens, feats.shape[-1],
                                      self.specaug)
            feats = apply_spec_augment(
                feats, flens, {k: v[rows] for k, v in draws.items()},
                self.specaug)
        feats, flens = apply_lfr(feats, flens, self.lfr)
        out = self.model(feats, flens, targets, tlens, **extra)
        grads = list(torch.autograd.grad(out["loss"],
                                         self.optimizer.params))
        metrics = {k: v.detach() for k, v in out.items()}
        if self.mesh is not None:
            if self.mesh.n_model > 1:
                self.mesh.model.all_reduce_coalesced_(
                    [g for g, s in zip(grads, self._sliced) if s])
            self.mesh.data.all_reduce_coalesced_(grads)
            self.mesh.data.all_reduce_coalesced_(list(metrics.values()))
        metrics["grad_norm"] = self.optimizer.norm_fn(grads)
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
        return {"model": gather_params(self.model, self.mesh, self.specs),
                "optimizer": self._optimizer_state(gather=True),
                "step": self.steps, "generators": gens}

    def _optimizer_state(self, state: dict | None = None,
                         gather: bool = False) -> dict:
        """The optimizer's state with its sharded tensors (Adam's moments
        and the accumulated gradients) gathered whole, or cut from a whole
        `state` to this rank's blocks."""
        state = self.optimizer.state_dict() if state is None else state
        if self.mesh is None or self.mesh.n_model == 1:
            return state
        dims = [self.specs[n] for n in self._names]

        def convert(t, dim):
            if dim is None or not torch.is_tensor(t) or t.dim() == 0:
                return t
            return (self.mesh.model.all_gather(t, dim) if gather
                    else shard_tensor(t, dim, self.mesh))
        adam = dict(state["adam"])
        adam["state"] = {i: {k: convert(v, dims[i]) for k, v in st.items()}
                         for i, st in adam["state"].items()}
        acc = state["acc"]
        return {**state, "adam": adam,
                "acc": None if acc is None else
                [convert(a, d) for a, d in zip(acc, dims)]}

    def load_state_dict(self, state: dict) -> None:
        model_state = state["model"]
        if self.specs is not None:
            model_state = {k: shard_tensor(v, self.specs.get(k), self.mesh)
                           for k, v in model_state.items()}
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(self._optimizer_state(
            state["optimizer"]))
        self.steps = state["step"]
        gens = state["generators"]
        self.gen.set_state(gens["specaug"])
        torch.set_rng_state(gens["torch"])
        if self.device.type == "cuda" and "cuda" in gens:
            torch.cuda.set_rng_state(gens["cuda"], self.device)


class EvalStep:
    """Forward without dropout or SpecAugment (LFR as TrainStep) -> the
    model's loss dict. With a mesh (the TrainStep's, whose model it
    evaluates), every rank takes its rows of the same host batch and gets
    the global losses."""

    def __init__(self, model, frontend: FrontendConfig | None = None,
                 device: str | torch.device | None = None,
                 lfr: tuple[int, int] = (1, 1), mesh=None):
        self.device = resolve_device(device)
        self.model = model
        self.frontend = frontend or FrontendConfig()
        self.cmvn_stats = cmvn_stats_for(self.frontend, self.device)
        self.lfr = tuple(lfr)
        self.mesh = mesh

    @torch.no_grad()
    def __call__(self, batch: dict) -> dict[str, torch.Tensor]:
        self.model.eval()
        extra = {}
        if self.mesh is not None:
            _, extra["counts"] = global_counts(batch, self.frontend,
                                               self.device)
            batch = shard_batch(batch, self.mesh)
        feats, flens, targets, tlens = batch_features(
            batch, self.frontend, self.device, self.cmvn_stats)
        feats, flens = apply_lfr(feats, flens, self.lfr)
        out = self.model(feats, flens, targets, tlens, **extra)
        if self.mesh is not None:
            self.mesh.data.all_reduce_coalesced_(list(out.values()))
        return out


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
    cv line of the metrics, with the epoch's step and cv-batch counts).
    Under a mesh every rank runs the Solver: the cv loss is the global
    one on every rank, so half_lr and early stop decide alike, and the
    state is gathered on every rank at each epoch's end; only the rank
    given a checkpointer and a metrics_writer (rank 0) writes."""
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
        eval_step = EvalStep(ts.model, ts.frontend, ts.device, ts.lfr,
                             ts.mesh)
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
            if self.checkpointer or ts.mesh is not None:
                state = ts.state_dict()      # a collective under a mesh
                if self.checkpointer:
                    self.checkpointer.save(state, step=ts.steps,
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
