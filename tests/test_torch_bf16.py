"""The bf16 bound: each package's bf16 run against its own float32 run,
from the same seeded params and batch, on the CPU.

The two packages round bf16 at different places (one of them is not
closer to float32 than the other), so neither is held to the other's
bf16 numbers. What is held is the port's drift from its own float32
run: no larger than the reference's drift from its float32 run plus a
margin fixed before any run was made:
- one train step's loss_ctc and loss_att: + 0.01 absolute;
- its grad norm: + 0.5% relative;
- an attn_rescore beam-10 decode of 8 rows: at most one more row whose
  1-best differs from float32's.
Two models: hybrid_dev widths with the aishell preset's settings (bf16,
pallas_ctc=True) and conformer_dev in bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.train import NoamAdam, TrainStep
from torch_port_util import (VOCAB, conformer_flax_params, conformer_jax_cfg,
                             conformer_torch_model, flax_params, jax_cfg,
                             torch_model, wav_batch)

LOSS_MARGIN = 0.01          # absolute, each loss
GRAD_NORM_MARGIN = 0.005    # relative
ROW_MARGIN = 1              # rows whose 1-best leaves float32's

MODELS = {
    # (jax cfg, flax params, a maker of the port model with those
    # params) of each model, by dtype; the Recognizer casts its model's
    # weights, so decoding and training take a model each
    "hybrid_dev": lambda dt: (
        jax_cfg(dtype=jnp.bfloat16 if dt else jnp.float32,
                pallas_ctc=True),
        flax_params(),
        lambda: torch_model(dtype=torch.bfloat16 if dt else torch.float32,
                            pallas_ctc=True)),
    "conformer_dev": lambda dt: (
        conformer_jax_cfg(dtype=jnp.bfloat16 if dt else jnp.float32),
        conformer_flax_params(),
        lambda: conformer_torch_model(
            dtype=torch.bfloat16 if dt else torch.float32)),
}
BEAM = dict(beam=10, max_len=12, ctc_weight=0.3, nbest=1)
DECODE_BATCH = wav_batch([9600, 8000, 7200, 6400, 5600, 4800, 4000, 3200],
                         seed=11)


def train_batch(seed=3, b=4, t=61, u=6, flens=(61, 50, 0, 37)):
    rng = np.random.default_rng(seed)
    targets = np.full((b, u), -1, np.int32)
    tlens = np.zeros(b, np.int32)
    for i, fl in enumerate(flens):
        if fl:
            n = int(rng.integers(2, u + 1))
            targets[i, :n] = rng.integers(2, VOCAB - 2, n)
            tlens[i] = n
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.asarray(flens, np.int32),
            "targets": targets, "target_lengths": tlens}


@functools.lru_cache(maxsize=8)
def run(model: str, bf16: bool) -> dict:
    """One train step and one attn_rescore decode of `model` in each
    package -> {"ref" | "port": {loss_ctc, loss_att, grad_norm, best}}."""
    jcfg, params, make = MODELS[model](bf16)
    batch = train_batch()
    tx = make_optimizer(jcfg.d_model, 100, 1.0, 5.0)
    state = TrainState.create(params["params"], tx, jax.random.PRNGKey(1))
    jstep = make_train_step(JaxTransformer(jcfg), tx, donate=False)
    _, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    jrec = JaxRecognizer(cfg=jcfg, params=params, mode="attn_rescore",
                         beam=JaxBeam(**BEAM))
    out = {"ref": {k: float(jm[k]) for k in ("loss_ctc", "loss_att",
                                             "grad_norm")}}
    out["ref"]["best"] = [h[0]["yseq"] for h in
                          jrec.decode_batch_nbest(DECODE_BATCH)]
    tmodel = make()
    trec = Recognizer(tmodel.cfg, tmodel, mode="attn_rescore", device="cpu",
                      beam=BeamConfig(**BEAM))
    best = [h[0]["yseq"] for h in trec.decode_batch_nbest(DECODE_BATCH)]
    tmodel = make()
    ts = TrainStep(tmodel, NoamAdam(tmodel.parameters(), jcfg.d_model, 100,
                                    1.0, 5.0), device="cpu")
    tm = ts(batch)
    out["port"] = {k: float(tm[k]) for k in ("loss_ctc", "loss_att",
                                             "grad_norm")}
    out["port"]["best"] = best
    return out


def drift(model: str) -> dict:
    """Each package's bf16 drift from its own float32 run."""
    f32, bf16 = run(model, False), run(model, True)
    out = {}
    for pkg in ("ref", "port"):
        a, b = f32[pkg], bf16[pkg]
        out[pkg] = {k: abs(b[k] - a[k]) for k in ("loss_ctc", "loss_att")}
        out[pkg]["grad_norm"] = abs(b["grad_norm"] - a["grad_norm"]) / \
            a["grad_norm"]
        out[pkg]["rows"] = sum(x != y for x, y in zip(a["best"], b["best"]))
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bf16_train_step_drift_bounded(model):
    d = drift(model)
    for k in ("loss_ctc", "loss_att"):
        assert d["port"][k] <= d["ref"][k] + LOSS_MARGIN, (k, d)
    assert d["port"]["grad_norm"] <= d["ref"]["grad_norm"] + \
        GRAD_NORM_MARGIN, d
    bf16 = run(model, True)["port"]
    assert np.isfinite([bf16[k] for k in ("loss_ctc", "loss_att",
                                          "grad_norm")]).all()


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bf16_decode_drift_bounded(model):
    d = drift(model)
    assert d["port"]["rows"] <= d["ref"]["rows"] + ROW_MARGIN, d
    assert len(run(model, True)["port"]["best"]) == 8
