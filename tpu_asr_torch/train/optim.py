"""Optimizer: Adam under the Noam (inverse-sqrt warmup) schedule, with
global-norm clipping and gradient accumulation (port of
tpu_asr/train/optim.py, which builds the same from optax).

- Noam: lr = k * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5), s = count+1,
  where count is the number of updates applied so far (optax's count:
  the first update uses sched(0)).
- Adam(0.9, 0.98, eps=1e-9): torch.optim.Adam's update has optax's form,
  m_hat / (sqrt(v_hat) + eps).
- Clipping is optax.clip_by_global_norm's: g * max / ||g|| when
  ||g|| >= max (torch's clip_grad_norm_ adds 1e-6 to the norm), computed
  on the device without a host sync.
- accum_steps = k works like optax.MultiSteps: micro-batch gradients are
  averaged (running mean), and clip + Adam + the schedule advance once
  per k.
- Under tensor parallelism a rank holds blocks of the sharded gradients
  and all of the replicated ones: `global_norm(..., sharded, axis)` sums
  the sharded squares over the model axis and counts the replicated ones
  once, and clipping then acts on that norm. Adam is elementwise, so it
  runs on each rank's blocks as they are.
"""

from __future__ import annotations

import torch


def noam_schedule(d_model: int, warmup_steps: int = 4000, k: float = 1.0):
    scale = k * d_model ** -0.5

    def sched(step: int) -> float:
        s = max(step, 0) + 1.0          # 1-indexed, as the reference counts
        return scale * min(s ** -0.5, s * warmup_steps ** -1.5)

    return sched


def global_norm(tensors, sharded: list[bool] | None = None,
                axis=None) -> torch.Tensor:
    """sqrt(sum of squares) over a list of float32 tensors, as a 0-d
    tensor (one multi-tensor launch for the per-tensor norms). With the
    mesh's model `axis` and a `sharded` flag per tensor, the squares of
    the sharded tensors are summed over the axis (the replicated ones are
    the same on every rank and count once)."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if axis is None or axis.size == 1:
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    mask = torch.tensor(sharded, device=sq.device)
    shard_sq = axis.all_reduce_(torch.where(mask, sq, 0.0).sum())
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + shard_sq)


def clip_by_global_norm_(grads, max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """In place, optax's form: g / ||g|| * max where ||g|| >= max, else g
    unchanged (g / 1 * 1). Returns the norm before clipping."""
    if norm is None:
        norm = global_norm(grads)
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))
    return norm


class NoamAdam:
    """Adam + Noam + clip + accumulation over `params`.

    `update(grads)` takes one micro-batch's gradients (one tensor per
    param, in order) and returns True when it applied an update. `count`
    is the number of updates applied, `lr_scale` multiplies the schedule
    (the Solver's half_lr). `norm_fn` is the gradient norm that clipping
    takes (global_norm; a tensor-parallel TrainStep sets the mesh's)."""

    def __init__(self, params, d_model: int, warmup_steps: int = 4000,
                 k: float = 1.0, grad_clip: float = 5.0,
                 accum_steps: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = noam_schedule(d_model, warmup_steps, k)
        self.grad_clip = grad_clip
        self.accum_steps = max(int(accum_steps), 1)
        self.adam = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.98),
                                     eps=1e-9)
        self.count = 0
        self.mini_step = 0
        self.lr_scale = 1.0
        self._acc: list[torch.Tensor] | None = None
        self.norm_fn = global_norm

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.lr_scale * self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor],
               grad_norm: torch.Tensor | None = None) -> bool:
        """grad_norm: global_norm(grads) if the caller has it (clipping
        reuses it when nothing is accumulated)."""
        if self.accum_steps > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            grads, grad_norm = self._acc, None
        if self.grad_clip > 0:
            clip_by_global_norm_(grads, self.grad_clip,
                                 self.norm_fn(grads) if grad_norm is None
                                 else grad_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adam.param_groups:
            group["lr"] = self.lr
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        self.mini_step = 0
        self._acc = None
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "lr_scale": self.lr_scale,
                "acc": self._acc}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        self.lr_scale = state["lr_scale"]
        self._acc = (None if state["acc"] is None else
                     [a.to(p.device) for a, p in zip(state["acc"],
                                                     self.params)])
