"""Port training (tpu_asr_torch.train) vs tpu_asr.train on the CPU, from
one flax initialisation at hybrid_dev widths (float32, dropout 0, no
SpecAugment).

Tolerances: one step's losses within 1e-5 and grad_norm within 1e-4
relative (float32; sums in another order); three steps' losses within
1e-4; the parameter update of three steps within 1e-3 of its norm,
leaf by leaf, apart from the attention key biases (see
_updates_that_differ).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_asr import IGNORE_ID
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr.train import noam_schedule as jax_noam
from tpu_asr_torch.train import EvalStep, NoamAdam, TrainStep, noam_schedule
from tpu_asr_torch.train.checkpoints import Checkpointer
from tpu_asr_torch.train.optim import clip_by_global_norm_, global_norm
from tpu_asr_torch.weights import flax_to_torch
from torch_port_util import VOCAB, flax_params, jax_cfg, torch_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_MODEL, WARMUP, LR_K = 64, 100, 1.0


def make_batch(seed, b=4, t=61, u=6, flens=(61, 50, 0, 37)):
    rng = np.random.default_rng(seed)
    targets = np.full((b, u), IGNORE_ID, np.int32)
    tlens = np.zeros(b, np.int32)
    for i, fl in enumerate(flens):
        if fl:
            n = int(rng.integers(2, u + 1))
            targets[i, :n] = rng.integers(2, VOCAB - 2, n)
            tlens[i] = n
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.asarray(flens, np.int32),
            "targets": targets, "target_lengths": tlens}


def port_step(accum=1):
    model = torch_model()
    opt = NoamAdam(model.parameters(), D_MODEL, WARMUP, LR_K, 5.0, accum)
    return TrainStep(model, opt, device="cpu")


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of each package on three batches."""
    tx = make_optimizer(D_MODEL, WARMUP, LR_K, 5.0)
    state = TrainState.create(flax_params()["params"], tx,
                              jax.random.PRNGKey(1))
    jstep = make_train_step(JaxTransformer(jax_cfg()), tx, donate=False)
    ts = port_step()
    jm, tm = [], []
    for i in range(3):
        batch = make_batch(i)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in ts(batch).items()})
    return jm, tm, jax.device_get(state.params), ts


def test_one_step_matches_reference(three_steps):
    jm, tm, _, _ = three_steps
    for k in ("loss", "loss_att", "loss_ctc", "acc"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)


def test_three_steps_losses_match(three_steps):
    jm, tm, _, _ = three_steps
    for i in range(3):
        np.testing.assert_allclose(tm[i]["loss"], jm[i]["loss"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    assert tm[2]["loss"] != tm[0]["loss"]


def _updates_that_differ(got, want):
    """Leaves whose update got[k] differs from want[k] by more than 1e-3 of
    want[k]'s norm. Attention key biases are left out: their gradient is
    zero in exact arithmetic (softmax ignores a shift shared by all keys),
    so Adam (eps 1e-9) moves them by the rounding noise of each framework."""
    return [k for k in want if not k.endswith("k_proj.bias")
            and np.linalg.norm(got[k] - want[k])
            > 1e-3 * np.linalg.norm(want[k])]


def test_params_after_three_steps_match(three_steps):
    """The three updates p3 - p0 agree leaf by leaf; a no-op update and
    one of the wrong sign fail the same check."""
    _, _, jparams, ts = three_steps
    p0 = {k: v.numpy() for k, v in torch_model().state_dict().items()}
    state = ts.model.state_dict()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            walk(v, key) if isinstance(v, dict) else flat.update({key: v})
    walk(jparams, "")
    assert ts.optimizer.count == 3
    want = {}
    for path, v in flat.items():
        key, arr = flax_to_torch(path, v)
        want[key] = arr - p0[key]
    got = {k: state[k].numpy() - p0[k] for k in want}
    assert _updates_that_differ(got, want) == []
    moved = [k for k in want if not k.endswith("k_proj.bias")]
    noop = {k: np.zeros_like(v) for k, v in want.items()}
    flipped = {k: -v for k, v in want.items()}
    assert _updates_that_differ(noop, want) == moved
    assert _updates_that_differ(flipped, want) == moved


@pytest.mark.parametrize("step", [0, 1, WARMUP - 1, WARMUP, 10 * WARMUP])
def test_noam_schedule_matches(step):
    np.testing.assert_allclose(noam_schedule(D_MODEL, WARMUP, 2.0)(step),
                               float(jax_noam(D_MODEL, WARMUP, 2.0)(step)),
                               rtol=1e-6)


def test_adam_lr_follows_optax_count():
    """The first update uses sched(0), the next sched(1)."""
    opt = NoamAdam([torch.nn.Parameter(torch.zeros(2))], D_MODEL, WARMUP)
    sched = noam_schedule(D_MODEL, WARMUP)
    assert opt.lr == sched(0)
    opt.update([torch.ones(2)])
    assert opt.count == 1 and opt.lr == sched(1)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(s).astype(np.float32) * scale
          for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray(g) for g in gs], None)
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = clip_by_global_norm_(got, 5.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(gs)),
                               rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_accumulation_matches_optax_multisteps():
    pw = [1.0, -2.0, 0.5, 3.0]
    ga = [0.30, 0.11, -0.25, 0.40]
    gb = [0.50, -0.70, 0.45, 0.10]
    ms = make_optimizer(32, warmup_steps=10, accum_steps=2)
    p = {"w": jnp.asarray(pw)}
    st = ms.init(p)
    for g in (ga, gb):
        u, st = ms.update({"w": jnp.asarray(g)}, st, p)
        p = optax.apply_updates(p, u)
    w = torch.nn.Parameter(torch.tensor(pw))
    opt = NoamAdam([w], 32, warmup_steps=10, accum_steps=2)
    assert not opt.update([torch.tensor(ga)])
    assert torch.equal(w.detach(), torch.tensor(pw)) and opt.count == 0
    assert opt.update([torch.tensor(gb)])
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                               rtol=0, atol=1e-7)


def test_accum_steps_2_equals_one_step_on_the_doubled_batch():
    """Equal-length rows, so the mean losses of two halves average to the
    loss of the whole batch: two micro-steps with accum_steps=2 land the
    same update as one step on the doubled batch."""
    full = make_batch(7, flens=(61, 61, 61, 61))
    full["target_lengths"][:] = 6
    full["targets"] = np.random.default_rng(7).integers(
        2, VOCAB - 2, (4, 6)).astype(np.int32)
    half = [{k: v[sl] for k, v in full.items()}
            for sl in (slice(0, 2), slice(2, 4))]
    big, acc = port_step(), port_step(accum=2)
    big(full)
    before = [p.detach().clone() for p in acc.optimizer.params]
    acc(half[0])
    assert all(torch.equal(p, q) for p, q in zip(acc.optimizer.params,
                                                 before))
    acc(half[1])
    assert acc.optimizer.count == big.optimizer.count == 1
    lr = noam_schedule(D_MODEL, WARMUP)(0)
    for p, q in zip(acc.optimizer.params, big.optimizer.params):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=2 * lr)


def test_eval_step_matches_reference_apply():
    batch = make_batch(11)
    want = JaxTransformer(jax_cfg()).apply(
        flax_params(), *(jnp.asarray(batch[k]) for k in (
            "feats", "feat_lengths", "targets", "target_lengths")))
    got = EvalStep(torch_model(), device="cpu")(batch)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_checkpoint_save_restore_and_sidecars(tmp_path):
    from tpu_asr.train.checkpoints import _config_to_json
    ts = port_step()
    ts(make_batch(0))
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    ck.save_config(ts.model.cfg)
    ck.save_frontend(ts.frontend)
    ck.save(ts.state_dict(), step=ts.steps, epoch=0, cv_loss=1.0,
            is_best=True)
    for i in range(3):                      # the best survives cleanup
        ck.save(ts.state_dict(), step=ts.steps + 1 + i, epoch=1 + i,
                cv_loss=2.0)
    assert ck.all_steps() == [1, 3, 4] and ck.best_step() == 1
    with open(tmp_path / "model_config.json") as f:
        assert set(json.load(f)) == set(_config_to_json(jax_cfg()))
    assert ck.load_config() == ts.model.cfg
    assert ck.load_frontend() == ts.frontend

    fresh = port_step()
    fresh.load_state_dict(ck.restore(1))
    for (k, a), b in zip(ts.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert fresh.steps == 1 and fresh.optimizer.count == 1
    batch = make_batch(1)
    m1, m2 = ts(batch), fresh(batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_train_cli_runs_on_cpu_and_serve_loads_its_checkpoint(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "tpu_asr_torch.train", "--synthetic", "16",
         "--preset", "hybrid_dev", "--device", "cpu", "--epochs", "1",
         "--save-folder", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() and ck.best_step() == ck.latest_step()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    cv = json.loads(lines[-1])
    assert cv["phase"] == "cv" and np.isfinite(cv["loss"])

    from tpu_asr_torch.serve import build_server, parse_args
    server = build_server(parse_args(["--ckpt", str(tmp_path), "--device",
                                      "cpu", "--mode", "greedy_ctc",
                                      "--bucket-frames", "128"]))
    assert server.rec.cfg.vocab_size == 64
    wav = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    server.start()
    try:
        nbest = server.submit("wav", wav, timeout=120)
    finally:
        server.stop()
    assert all(0 <= t < 64 for t in nbest[0]["yseq"])


def test_grad_norm_is_of_the_raw_gradients():
    """grad_norm reports the norm before clipping (clip at 1e-3 here)."""
    model = torch_model()
    opt = NoamAdam(model.parameters(), D_MODEL, WARMUP, LR_K, 1e-3)
    batch = make_batch(2)
    m = TrainStep(model, opt, device="cpu")(batch)
    ref = torch_model().train()
    out = ref(*(torch.as_tensor(batch[k]) for k in (
        "feats", "feat_lengths", "targets", "target_lengths")))
    grads = torch.autograd.grad(out["loss"], list(ref.parameters()))
    assert m["grad_norm"].item() > 1e-3
    np.testing.assert_allclose(m["grad_norm"].item(),
                               global_norm(grads).item(), rtol=1e-6)


def _tiny_solver(tmp_path, lr_k, **kw):
    """A ctc-only d32 model on 24 synthetic wavs (the reference's Solver
    test set-up)."""
    import dataclasses as dc
    from tpu_asr_torch.data import Bucket, DataLoader
    from tpu_asr_torch.data.synthetic import make_synthetic_dataset
    from tpu_asr_torch.models.config import ModelConfig
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.train import Solver
    from tpu_asr_torch.train.metrics import MetricsWriter
    from tpu_asr_torch.weights import init_random
    cfg = dc.replace(ModelConfig(), vocab_size=16, d_model=32, d_inner=64,
                     num_heads=2, num_enc_layers=1, num_dec_layers=1,
                     dropout=0.0, model_type="ctc", conv_channels=(8, 16))
    utts, waves = make_synthetic_dataset(24, 16, min_tokens=2, max_tokens=5,
                                         tone_ms=60, seed=0)
    buckets = [Bucket(max_frames=8000, max_tokens=8, batch_size=8)]
    model = init_random(Transformer(cfg), 0)
    ts = TrainStep(model, NoamAdam(model.parameters(), 32, 20, lr_k),
                   device="cpu")
    return Solver(ts, DataLoader(utts[4:], buckets, waves=waves, seed=1),
                  DataLoader(utts[:4], buckets, waves=waves, shuffle=False),
                  metrics_writer=MetricsWriter(str(tmp_path / "m.jsonl"),
                                               echo=False), **kw)


def test_solver_trains_and_reports_each_epoch(tmp_path):
    solver = _tiny_solver(tmp_path, 1.0, epochs=4, print_freq=1,
                          checkpointer=Checkpointer(str(tmp_path / "ck")))
    solver.train()
    hist = solver.history
    assert [h["epoch"] for h in hist] == [0, 1, 2, 3]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(h["nonfinite_steps"] == 0 and h["train_steps"] == 3
               and h["cv_batches"] == 1 for h in hist)
    assert solver.checkpointer.latest_step() == solver.train_step.steps == 12
    records = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert sum(r["phase"] == "train" for r in records) == 12


def test_solver_half_lr_and_early_stop(tmp_path):
    """lr 0: the cv loss is constant after epoch 0, a plateau that halves
    the lr scale and then stops early."""
    solver = _tiny_solver(tmp_path, 0.0, epochs=10, print_freq=100,
                          half_lr=True, early_stop_patience=3)
    solver.train()
    records = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    assert [r["lr_scale"] for r in records if r.get("event") == "half_lr"] \
        == [0.5, 0.25, 0.125]
    assert len(solver.history) == 4                 # stopped after 3 flat


def test_cli_starts_from_flax_params_and_resumes(tmp_path):
    """--params-npz loads flax params of the preset's model (here
    hybrid_dev at vocab 32); --continue-from restores model, optimizer and
    step from the first run's checkpoint."""
    import dataclasses as dc
    from tpu_asr.configs.presets import get_preset as jax_preset
    from tpu_asr_torch.train.__main__ import build_solver, parse_args
    from tpu_asr_torch.weights import _flatten
    cfg = dc.replace(jax_preset("hybrid_dev").model, vocab_size=VOCAB)
    params = jax.device_get(jax.jit(JaxTransformer(cfg).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32)))
    flat = _flatten(params)
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    common = ["--preset", "hybrid_dev", "--synthetic", "12", "--vocab-size",
              str(VOCAB), "--device", "cpu", "--no-specaug"]
    solver = build_solver(parse_args(common + [
        "--save-folder", str(tmp_path / "a"), "--params-npz", str(npz)]))
    got = solver.train_step.model.state_dict()
    for path, v in flat.items():
        key, arr = flax_to_torch(path[len("params/"):], v)
        assert np.array_equal(got[key].numpy(), arr), key
    solver.epochs = 1
    solver.train()
    resumed = build_solver(parse_args(common + [
        "--save-folder", str(tmp_path / "b"), "--epochs", "2",
        "--continue-from", str(tmp_path / "a")]))
    assert resumed.start_epoch == 1
    assert resumed.train_step.steps == solver.train_step.steps
    assert resumed.train_step.optimizer.count == solver.train_step.steps
    for (k, a), b in zip(solver.train_step.model.state_dict().items(),
                         resumed.train_step.model.state_dict().values()):
        assert torch.equal(a, b), k
