"""Training cells: the port's TrainStep over its DataLoader.

Set-up builds one TrainStep (model, NoamAdam, SpecAugment) with the
benchmark's seeded weights and one DataLoader over the seeded corpus,
takes the first `check_steps` steps through the same call and feed that
the window uses (recording what the check compares), then the rest of
the first epoch, which warms every bucket shape. The window then trains
for `seconds` of wall time and ends on a synchronize; every step issued
in it counts, with all of its time.

The check follows those first steps with the plain reference (float32,
TF32 off) from the same weights on the same utterances, SpecAugment
draws and dropout masks, once the window has closed and the program's
state is freed, and compares:

- loss_gap: the largest relative gap of a step's loss;
- grad_gap: the first step's clipped gradient as Adam got it (read back
  from its first moment), by the worst leaf: the gap of the two norms
  over the larger of the reference leaf's norm and the median leaf's;
- grad_geo: the same leaf gaps of the first gradient, their geometric
  mean over all leaves: steadier from seed to seed than the worst leaf,
  whose small LayerNorm and bias leaves sum many terms that cancel and
  so magnify bf16's rounding on some draws;
- change_gap: each leaf's change over the checked steps, measured the
  same way, over the leaves that the reference's first gradient moves
  (norm at least a thousandth of the median leaf's; the others, such as
  the key biases under softmax, move by round-off alone).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from benchmark import harness, traffic
from benchmark.weights import make_weights

FRAME_S = 0.01
EXCLUDE_BELOW = 1e-3     # of the median leaf's first reference gradient
GEO_FLOOR = 1e-9         # a leaf gap of exactly 0 counts as this in grad_geo


def set_seed(device, seed: int):
    """Seed the device's default generator, which dropout draws from."""
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed % 2 ** 63)
    else:
        torch.manual_seed(seed % 2 ** 63)


def rng_state(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state(torch.device(device))
    return torch.get_rng_state()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(torch.device(device))


def longest_first_seed(loader) -> int:
    """The loader's shuffle seed from its own on, the first whose first
    epoch opens with a batch of the longest bucket, so that the checked
    first gradient is always taken at the window's largest size (the
    bf16 gradient's gap to float32 grows with the length, and a check
    whose first batch fell to a random bucket drew work of a random
    difficulty). Each seed keeps its own order of the other batches."""
    from tpu_asr_torch.data.bucketing import plan_batches

    def plan(s):
        return plan_batches(loader.utts, loader.buckets, shuffle=True,
                            sort_by_length=loader.sort_by_length,
                            drop_last=loader.drop_last, seed=s,
                            length_key=loader.length_key)

    s = loader.seed
    longest = max({bi for bi, _ in plan(s)},
                  key=lambda i: loader.buckets[i].max_frames)
    while plan(s)[0][0] != longest:
        s = (s + 1) % 2 ** 32
    return s


def program_config(model: dict):
    from tpu_asr_torch.models.config import ModelConfig
    kw = dict(model)
    kw["dtype"] = getattr(torch, kw["dtype"])
    kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    kw["conv_channels"] = tuple(kw["conv_channels"])
    return ModelConfig(**kw)


class Program:
    """The system under test: one TrainStep and its DataLoader."""

    def __init__(self, cell, corpus, seed: int, device):
        from tpu_asr_torch.augment import SpecAugmentConfig
        from tpu_asr_torch.data.bucketing import make_buckets
        from tpu_asr_torch.data.loader import DataLoader
        from tpu_asr_torch.data.manifest import Utterance
        from tpu_asr_torch.models import build_model
        from tpu_asr_torch.train.loop import TrainStep
        from tpu_asr_torch.train.optim import NoamAdam
        cfg, train, mix = cell.config["model"], cell.config["train"], \
            cell.traffic
        self.device = torch.device(device)
        self.seed = seed
        with self.device:
            model = build_model(program_config(cfg))
        weights = make_weights(cell.reference.param_spec(cfg), seed,
                               self.device, cfg["d_model"])
        model.load_state_dict(weights, strict=True)
        del weights
        opt = NoamAdam(model.parameters(), cfg["d_model"],
                       train["warmup_steps"], train["lr_k"],
                       train["grad_clip"])
        self.step = TrainStep(model, opt,
                              specaug=SpecAugmentConfig(**train["specaug"]),
                              device=self.device, seed=seed % 2 ** 63)
        self.names = {id(p): n for n, p in model.named_parameters()}
        utts = [Utterance(id=u, tokens=t.tolist(), num_frames=int(f))
                for u, t, f in zip(corpus.ids, corpus.tokens, corpus.frames)]
        buckets = make_buckets(utts, num_buckets=mix["num_buckets"],
                               batch_frames=mix["batch_frames"],
                               max_frames_cap=mix["max_frames_cap"],
                               max_tokens_cap=mix["max_tokens_cap"])
        self.loader = DataLoader(utts, buckets, mode="feat",
                                 feats=corpus.feats, shuffle=True,
                                 seed=seed % 2 ** 32)
        if mix.get("first_batch") == "longest":
            self.loader.seed = longest_first_seed(self.loader)
        self.it = iter(self.loader)

    def next_batch(self) -> dict:
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def check_steps(self, n: int) -> tuple[dict, list]:
        """The first n steps, recording the losses, the first clipped
        gradient's leaf norms (Adam's first moment after step 1 over
        1 - beta1) and each leaf's change over the n steps; with each
        batch's utterances, shape and the dropout generator's state."""
        model, opt = self.step.model, self.step.optimizer
        beta1 = opt.adam.param_groups[0]["betas"][0]
        start = {n_: p.detach().clone() for n_, p in
                 model.named_parameters()}
        set_seed(self.device, self.seed)
        losses, batches, grad = [], [], None
        for k in range(n):
            batch = self.next_batch()
            batches.append({"ids": list(batch["ids"]),
                            "rows": int(len(batch["feat_lengths"])),
                            "t_pad": int(batch["feats"].shape[1]),
                            "u_pad": int(batch["targets"].shape[1]),
                            "rng": rng_state(self.device)})
            losses.append(self.step(batch)["loss"])
            if k == 0:      # a leaf the optimizer never got reads 0
                grad = {self.names[id(p)]: float(
                    opt.adam.state[p]["exp_avg"].norm() / (1 - beta1))
                    if "exp_avg" in opt.adam.state.get(p, {}) else 0.0
                    for p in opt.params}
        with torch.no_grad():
            change = {n_: float((p - start[n_]).norm())
                      for n_, p in model.named_parameters()}
        return {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}, batches

    def warm(self):
        """The rest of the first epoch: every bucket's shape once."""
        for batch in self.it:
            self.step(batch)
        self.it = iter(self.loader)
        sync(self.device)

    def window(self, seconds: float, stretch=None, traced_steps: int = 0):
        """Train for `seconds`; with a stretch, profile `traced_steps`
        steps from 40% of the window on (a window too short for them
        runs on until they are traced)."""
        from torch.profiler import record_function
        steps, wait, losses = [], 0.0, []
        traced = []
        t0 = time.perf_counter()
        while True:
            if stretch is not None and not stretch.running and not traced \
                    and time.perf_counter() - t0 >= 0.4 * seconds:
                stretch.start()
            w0 = time.perf_counter()
            if stretch is not None and stretch.running:
                with record_function("loader.next"):
                    batch = self.next_batch()
            else:
                batch = self.next_batch()
            wait += time.perf_counter() - w0
            n_real = len(batch["ids"])
            lengths = list(zip(batch["feat_lengths"][:n_real].tolist(),
                               batch["target_lengths"][:n_real].tolist()))
            if stretch is not None and stretch.running:
                with record_function("TrainStep"):
                    losses.append(self.step(batch)["loss"])
                traced.append(lengths)
                if len(traced) >= traced_steps:
                    stretch.stop()
            else:
                losses.append(self.step(batch)["loss"])
            steps.append(lengths)
            if time.perf_counter() - t0 >= seconds and (
                    stretch is None or stretch.summary is not None):
                break
        sync(self.device)
        window_s = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses).float())).sum())
        return {"window_s": window_s, "steps": steps, "traced": traced,
                "loader_wait_s": wait, "failed": bad}

    def close(self):
        self.it.close()
        del self.step, self.loader, self.it


def reference_readings(cell, corpus, batches, seed, device, precision):
    """The reference's first steps on the program's batches."""
    ref = cell.reference
    cfg = cell.config["model"]
    weights = make_weights(ref.param_spec(cfg), seed, device,
                           cfg["d_model"])
    padded = [traffic.pad_batch(corpus, b["ids"], b["rows"], b["t_pad"],
                                b["u_pad"]) for b in batches]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return ref.train_steps(cfg, cell.config["train"], weights, padded,
                               seed % 2 ** 63, [b["rng"] for b in batches],
                               ref.Precision(precision), device)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of the module docstring; a cell's limits file names
    those that its check compares."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad"])
    med_g = statistics.median(ref["grad"][n] for n in names)
    grad = {n: abs(prog["grad"][n] - ref["grad"][n])
            / max(ref["grad"][n], med_g) for n in names}
    med_raw = statistics.median(ref["raw_grad"][n] for n in names)
    moving = [n for n in names
              if ref["raw_grad"][n] >= EXCLUDE_BELOW * med_raw]
    med_c = statistics.median(ref["change"][n] for n in moving)
    change = {n: abs(prog["change"][n] - ref["change"][n])
              / max(ref["change"][n], med_c) for n in moving}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    geo = math.exp(statistics.fmean(math.log(max(g, GEO_FLOOR))
                                    for g in grad.values()))
    return {"loss_gap": loss_gap, "grad_gap": grad[worst_g],
            "grad_geo": geo, "change_gap": change[worst_c],
            "grad_leaf": worst_g, "change_leaf": worst_c,
            "excluded": sorted(set(names) - set(moving))}


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device, t_start,
        program_cls=Program):
    from benchmark import trace as tracing
    mix = cell.traffic
    corpus = traffic.make_train_corpus(mix, cell.config["model"]["vocab_size"],
                                       seed, device)
    prog = program_cls(cell, corpus, seed, device)
    readings, batches = prog.check_steps(mix["check_steps"])
    prog.warm()
    stretch = None
    if trace:
        tracing.warm_profiler(device)
        stretch = tracing.Stretch(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    win = prog.window(seconds, stretch, mix["traced_steps"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    dev_info = (harness.device_info(torch, cell.chips) if cuda else
                {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    dev_info["memory_peak_bytes"] = int(max(peak, setup_peak if cuda else 0))
    audio_s = sum(t for step in win["steps"] for t, _ in step) * FRAME_S
    e2e = {"setup_s": setup_s,
           "train_audio_s_per_s": audio_s / win["window_s"],
           "peak_mem_gib": peak / 2 ** 30}
    attempted = len(win["steps"])
    prog.close()
    del prog
    free(device)
    ref = reference_readings(cell, corpus, batches, seed, device, "f32")
    numbers = compare(readings, ref)
    checks = [(k, numbers[k], cell.limits[k])
              for k in ("loss_gap", "grad_gap", "grad_geo", "change_gap")
              if k in cell.limits]
    out = {"attempted": attempted, "failed": win["failed"],
           "checks": checks,
           "correct": harness.judge(checks) and win["failed"] == 0}
    if trace:
        summary = stretch.summary
        ctx = {"kind": "train", "config": cell.config["model"],
               "window_s": win["window_s"], "steps": win["steps"],
               "traced_steps": win["traced"], "trace": summary,
               "loader_wait_s": win["loader_wait_s"]}
        out["metrics"] = cell.read_per_layer(ctx)
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["span_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end()}
    out["device"] = dev_info
    return out

