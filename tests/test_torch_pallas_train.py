"""Port use_pallas training vs tpu_asr's on the CPU: the hybrid model at
hybrid_dev widths and the CIF model at cif_dev widths, with
ModelConfig(use_pallas=True) on both sides, from one flax initialisation
(float32, dropout 0, no SpecAugment). The reference differentiates its
Pallas kernels (interpret mode) through their custom VJPs; the port
takes FlashAttentionFunction and LayerNormResidualFunction, whose CPU
forward and backward are the plain versions.

The batch puts 16 x 33 = 528 rows through the encoder and 16 x 32 = 512
through the decoder, so every post-norm block takes the fused
residual+LayerNorm (the reference's 512-row switch) and every full-pass
attention the flash formulation, forward and backward.

Tolerances: one step's losses within 1e-5 and grad norm within 1e-4
relative (float32; sums in another order); three steps' updates within
1e-3 of each leaf's norm (_updates_that_differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_asr.ops.pallas.cif as jax_cif
from test_torch_train import _updates_that_differ
from tpu_asr import IGNORE_ID
from tpu_asr.models import CifModel as JaxCifModel
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch.models import modules
from tpu_asr_torch.ops import flash_attention as fa
from tpu_asr_torch.ops import layernorm as ln
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.weights import flax_to_torch
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_model, flax_params, jax_cfg,
                             torch_model)

D_MODEL, WARMUP = 64, 100
B, T, U = 16, 135, 31          # T' = 33: 528 encoder rows; U + 1 = 32


def make_batch(seed):
    """16 utterances of up to 135 frames (one of length 0) with 2-12
    tokens each, padded to U = 31 tokens."""
    rng = np.random.default_rng(seed)
    flens = rng.integers(90, T + 1, B).astype(np.int32)
    flens[0], flens[-1] = T, 0
    targets = np.full((B, U), IGNORE_ID, np.int32)
    tlens = np.zeros(B, np.int32)
    for i in range(B - 1):
        n = int(rng.integers(2, 13))
        targets[i, :n] = rng.integers(2, VOCAB - 2, n)
        tlens[i] = n
    return {"feats": rng.standard_normal((B, T, 80)).astype(np.float32),
            "feat_lengths": flens, "targets": targets,
            "target_lengths": tlens}


def _jax_steps(model, params, n):
    tx = make_optimizer(D_MODEL, WARMUP, 1.0, 5.0)
    state = TrainState.create(params["params"], tx, jax.random.PRNGKey(1))
    jstep = make_train_step(model, tx, donate=False)
    metrics = []
    for i in range(n):
        batch = {k: jnp.asarray(v) for k, v in make_batch(i).items()}
        state, m = jstep(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params)


def _port_steps(model, n, monkeypatch):
    """n TrainSteps on the CPU; records the row counts of the fused LN
    calls and counts the Functions' backward passes."""
    ts = TrainStep(model, NoamAdam(model.parameters(), D_MODEL, WARMUP),
                   device="cpu")
    ln_rows, bwd = [], {"flash": 0, "ln": 0}
    fused = modules.layer_norm_residual
    monkeypatch.setattr(modules, "layer_norm_residual",
                        lambda r, *a: ln_rows.append(r.shape[0] * r.shape[1])
                        or fused(r, *a))
    for name, fn, key in (("flash_attention_bwd_reference", fa, "flash"),
                          ("layer_norm_residual_bwd_reference", ln, "ln")):
        orig = getattr(fn, name)
        monkeypatch.setattr(fn, name, lambda *a, _f=orig, _k=key: (
            bwd.__setitem__(_k, bwd[_k] + 1), _f(*a))[1])
    metrics = [{k: float(v) for k, v in ts(make_batch(i)).items()}
               for i in range(n)]
    return metrics, ts, ln_rows, bwd


@pytest.fixture(scope="module")
def hybrid_three_steps():
    mp = pytest.MonkeyPatch()
    try:
        jm, jparams = _jax_steps(JaxTransformer(jax_cfg(use_pallas=True)),
                                 flax_params(), 3)
        tm, ts, ln_rows, bwd = _port_steps(torch_model(use_pallas=True), 3,
                                           mp)
    finally:
        mp.undo()
    return jm, jparams, tm, ts, ln_rows, bwd


def test_one_step_matches_reference(hybrid_three_steps):
    jm, _, tm, ts, ln_rows, bwd = hybrid_three_steps
    cfg = ts.model.cfg
    assert cfg.attention_pallas and cfg.layernorm_pallas
    for k in ("loss", "loss_att", "loss_ctc", "acc"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)
    # every post-norm block took the fused form (>= 512 rows), and every
    # fused LN and full-pass attention ran its backward, in each step
    n_ln = 2 * cfg.num_enc_layers + 3 * cfg.num_dec_layers
    n_flash = cfg.num_enc_layers + 2 * cfg.num_dec_layers
    assert sorted(set(ln_rows)) == [B * (U + 1), B * 33]
    assert len(ln_rows) == 3 * n_ln
    assert bwd == {"flash": 3 * n_flash, "ln": 3 * n_ln}


def test_three_steps_updates_match(hybrid_three_steps):
    """p3 - p0 agree leaf by leaf within 1e-3 of each leaf's norm."""
    jm, jparams, tm, ts, _, _ = hybrid_three_steps
    for i in range(3):
        np.testing.assert_allclose(tm[i]["loss"], jm[i]["loss"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    p0 = {k: v.numpy() for k, v in torch_model().state_dict().items()}
    state = ts.model.state_dict()
    want = {}
    for path, v in _flat(jparams).items():
        key, arr = flax_to_torch(path, v)
        want[key] = arr - p0[key]
    got = {k: state[k].numpy() - p0[k] for k in want}
    assert ts.optimizer.count == 3
    assert _updates_that_differ(got, want) == []


def _flat(tree, prefix=""):
    """A params tree as one dict keyed by the "/"-joined paths."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        flat.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return flat


def test_cif_step_matches_reference(monkeypatch):
    """One use_pallas cif_dev step: the CIF model's encoder and decoder
    share EncoderLayer, so both Functions run; the port's fire is the
    plain cif_fire on the CPU, the reference's its Pallas kernel in
    interpret mode (the model calls it without the flag, which only a TPU
    takes)."""
    fire = jax_cif.cif_fire_pallas
    monkeypatch.setattr(jax_cif, "cif_fire_pallas",
                        lambda h, a, u, interpret=True: fire(h, a, u, True))
    jm, _ = _jax_steps(JaxCifModel(cif_jax_cfg(use_pallas=True)),
                       cif_flax_params(), 1)
    tm, ts, ln_rows, bwd = _port_steps(cif_torch_model(use_pallas=True), 1,
                                       monkeypatch)
    assert set(tm[0]) == set(jm[0])
    for k in ("loss", "loss_att", "loss_qty", "loss_ctc", "acc"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)
    assert ln_rows and min(ln_rows) >= 512
    assert bwd["flash"] > 0 and bwd["ln"] == len(ln_rows)


def test_build_solver_takes_model_overrides(tmp_path, monkeypatch):
    """build_solver(..., model_overrides={"use_pallas": True}) builds the
    trainer the CLI builds with the preset's ModelConfig changed: the
    model takes both Functions in training, and the checkpoint's
    model_config.json carries the flag (so a server restores it). No CLI
    flag sets it, as in bin/train.py."""
    import json

    from tpu_asr_torch.train.__main__ import build_solver, parse_args
    argv = ["--preset", "hybrid_dev", "--synthetic", "12", "--vocab-size",
            "32", "--device", "cpu", "--no-specaug", "--epochs", "1",
            "--save-folder", str(tmp_path)]
    with pytest.raises(SystemExit):
        parse_args(argv + ["--use-pallas"])
    solver = build_solver(parse_args(argv),
                          model_overrides={"use_pallas": True})
    cfg = solver.train_step.model.cfg
    assert cfg.use_pallas and cfg.attention_pallas and cfg.layernorm_pallas
    assert cfg.vocab_size == 32 and cfg.d_model == D_MODEL
    calls = []
    bwd = fa.flash_attention_bwd_reference
    monkeypatch.setattr(fa, "flash_attention_bwd_reference",
                        lambda *a: calls.append(1) or bwd(*a))
    solver.train()
    assert calls and solver.history[0]["nonfinite_steps"] == 0
    with open(tmp_path / "model_config.json") as f:
        assert json.load(f)["use_pallas"] is True
    plain = build_solver(parse_args(argv[:-1] + [str(tmp_path / "plain")]))
    assert not plain.train_step.model.cfg.use_pallas
