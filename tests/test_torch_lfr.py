"""LFR stacking and the linear input layer (tpu_asr_torch.frontend
build_lfr_features / lfr_length, the encoder's input_layer "linear", the
train steps' and the Recognizer's LFR, the attention_lfr preset) vs
tpu_asr on the CPU, from the same flax params (hybrid_dev widths with
the linear input: d64, h2, 2+2 layers, LFR (4, 3), so 320 inputs) and
the same numpy inputs.

Tolerances: LFR bitwise; the encoder and the model's losses in float32
within 1e-5; one train step (SpecAugment off) within 1e-4 of the
loss and 1e-4 relative of the grad norm, each gradient within 1e-4 of
its leaf's largest entry; decoded tokens equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr import frontend as jfe
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch import frontend as tfe
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.models.transformer import Transformer
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.train.loop import EvalStep, model_lfr
from tpu_asr_torch.weights import init_random, load_jax_params
from torch_port_util import VOCAB, jax_cfg, torch_cfg, wav_batch

LFR = dict(input_layer="linear", lfr_m=4, lfr_n=3)
ATOL = 1e-5


@pytest.mark.parametrize("m,n,t", [(4, 3, 19), (4, 3, 1), (1, 1, 5),
                                   (3, 2, 8), (5, 3, 0)])
def test_lfr_bitwise_on_a_ragged_padded_batch(m, n, t):
    """T not a multiple of n; the stacks past a short row's end take the
    PADDED batch's frames (zeros), as the reference clamps to T - 1."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, 5)).astype(np.float32)
    lens = np.array([t, t // 2, 0], np.int32)
    x[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    got = tfe.build_lfr_features(torch.from_numpy(x), m, n).numpy()
    want = np.asarray(jfe.build_lfr_features(jnp.asarray(x), m, n))
    assert got.shape == want.shape == (3, -(-t // n), m * 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfe.lfr_length(torch.from_numpy(lens), n).numpy(),
        np.asarray(jfe.lfr_length(jnp.asarray(lens), n)))
    assert tfe.lfr_length(t, n) == jfe.lfr_length(t, n)


@functools.lru_cache(maxsize=2)
def _pair(kind):
    """(jax cfg, flax variables, port cfg, port model with those params)
    of a linear-input model of model_type `kind`."""
    jcfg = jax_cfg(model_type=kind, **LFR)
    v = jax.device_get(jax.jit(JaxTransformer(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 12, 320)),
        jnp.full((1,), 12, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32)))
    tcfg = torch_cfg(model_type=kind, **LFR)
    model = Transformer(tcfg)
    load_jax_params(model, v)
    return jcfg, v, tcfg, model


@pytest.fixture(scope="module", params=["transformer", "hybrid"])
def lfr_pair(request):
    return _pair(request.param)


def _batch(seed, b=4, t=37):
    rng = np.random.default_rng(seed)
    flens = np.array([t, 30, 0, 11][:b], np.int32)
    u = 6
    targets = np.full((b, u), -1, np.int32)
    tlens = np.zeros(b, np.int32)
    for i, fl in enumerate(flens):
        if fl:
            n = int(rng.integers(2, u + 1))
            targets[i, :n] = rng.integers(2, VOCAB - 2, n)
            tlens[i] = n
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": flens, "targets": targets,
            "target_lengths": tlens}


def test_linear_input_layer_weights_load_strictly(lfr_pair):
    """encoder/linear_in (Dense 320 -> 64) and encoder/norm_in (flax
    LayerNorm) map by the generic rules, no key left over either way."""
    _, v, tcfg, model = lfr_pair
    enc = v["params"]["encoder"]
    assert set(enc) >= {"linear_in", "norm_in"} and "subsample" not in enc
    state = model.state_dict()
    assert tuple(state["encoder.linear_in.weight"].shape) == (64, 320)
    np.testing.assert_array_equal(
        state["encoder.norm_in.weight"].numpy(), enc["norm_in"]["scale"])
    assert not any(k.startswith("encoder.subsample") for k in state)
    fresh = init_random(Transformer(tcfg), 0).state_dict()
    assert set(fresh) == set(state)
    assert float(fresh["encoder.norm_in.weight"].min()) == 1.0
    assert float(fresh["encoder.linear_in.weight"].std()) > 0.0


def test_encoder_and_losses_match(lfr_pair):
    jcfg, v, _, model = lfr_pair
    batch = _batch(0)
    feats, flens = jfe.build_lfr_features(jnp.asarray(batch["feats"])), \
        jfe.lfr_length(jnp.asarray(batch["feat_lengths"]))
    jm = JaxTransformer(jcfg)
    want_enc, want_len = jax.jit(lambda *a: jm.apply(*a, method="encode"))(
        v, feats, flens)
    want = jax.jit(jm.apply)(v, feats, flens, jnp.asarray(batch["targets"]),
                             jnp.asarray(batch["target_lengths"]))
    ev = EvalStep(model, device="cpu", lfr=model_lfr(model.cfg))
    got = ev(batch)
    tf = tfe.build_lfr_features(torch.from_numpy(batch["feats"]))
    with torch.no_grad():
        enc, el = model.encode(tf, tfe.lfr_length(
            torch.from_numpy(batch["feat_lengths"])))
    np.testing.assert_array_equal(el.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=ATOL)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=1e-5, err_msg=k)


def test_one_train_step_matches_reference():
    """The hybrid (both heads), SpecAugment off, dropout 0:
    make_train_step(lfr=(4, 3)) against TrainStep(lfr=model_lfr(cfg)) on
    one batch: losses and grad norm; then every gradient of the loss on
    the LFR-stacked batch against jax.grad's, within 1e-4 of the leaf's
    largest plus 1e-7."""
    from tpu_asr_torch.train.loop import apply_lfr
    jcfg, v, tcfg, _ = _pair("hybrid")
    batch = _batch(1)
    tx = make_optimizer(64, 100, 1.0, 5.0)
    state = TrainState.create(v["params"], tx, jax.random.PRNGKey(1))
    jmodel = JaxTransformer(jcfg)
    jstep = make_train_step(jmodel, tx, lfr=(4, 3), donate=False)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    _, jm = jstep(state, jb)
    model = Transformer(tcfg)
    load_jax_params(model, v)
    assert model_lfr(tcfg) == (4, 3)
    ts = TrainStep(model, NoamAdam(model.parameters(), 64, 100, 1.0, 5.0),
                   device="cpu", lfr=model_lfr(tcfg))
    tm = ts(batch)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)

    feats, flens = jfe.build_lfr_features(jb["feats"]), jfe.lfr_length(
        jb["feat_lengths"])
    jgrads = jax.jit(jax.grad(lambda p: jmodel.apply(
        {"params": p}, feats, flens, jb["targets"], jb["target_lengths"])
        ["loss"]))(v["params"])
    want = Transformer(tcfg)
    load_jax_params(want, jax.device_get({"params": jgrads}))
    model = Transformer(tcfg)
    load_jax_params(model, v)
    tf, tl = apply_lfr(torch.from_numpy(batch["feats"]),
                       torch.from_numpy(batch["feat_lengths"]), (4, 3))
    model(tf, tl, torch.from_numpy(batch["targets"]).long(),
          torch.from_numpy(batch["target_lengths"]))["loss"].backward()
    for k, p in model.named_parameters():
        g = want.state_dict()[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, err_msg=k,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-7)


def test_beam_tokens_match_on_wav_and_feats(lfr_pair):
    """The Recognizer stacks LFR frames on a wav batch and on a feats
    batch of the same features alike, and decodes as the reference."""
    from tpu_asr.decode.beam import BeamConfig as JaxBeam
    from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
    jcfg, v, tcfg, model = lfr_pair
    mode = "joint" if tcfg.model_type == "hybrid" else "beam"
    beam = dict(beam=3, max_len=8, nbest=3,
                ctc_weight=0.3 if mode == "joint" else 0.0)
    wavs = wav_batch([8000, 5000, 2400, 0], seed=4)
    rec = Recognizer(tcfg, model, mode=mode, device="cpu",
                     beam=BeamConfig(**beam))
    got = rec.decode_batch_nbest(wavs)
    feats, flens = tfe.wav_to_features(torch.from_numpy(wavs["wav"]),
                                       torch.from_numpy(wavs["wav_lengths"]))
    from_feats = rec.decode_batch_nbest({"feats": feats.numpy(),
                                         "feat_lengths": flens.numpy()})
    want = JaxRecognizer(cfg=jcfg, params=v, mode=mode,
                         beam=JaxBeam(**beam)).decode_batch_nbest(wavs)
    for i, (g, f, w) in enumerate(zip(got, from_feats, want)):
        assert [h["yseq"] for h in g] == [h["yseq"] for h in f] \
            == [h["yseq"] for h in w], i
    assert any(h[0]["yseq"] for h in got)


def test_attention_lfr_preset_equals_reference():
    from tpu_asr.configs.presets import get_preset as jax_preset
    from tpu_asr_torch.configs.presets import get_preset
    from test_torch_conformer import _plain
    got = _plain(get_preset("attention_lfr"))
    assert got == _plain(jax_preset("attention_lfr"))
    assert got["model"]["input_layer"] == "linear"
    cfg = get_preset("attention_lfr").model
    assert model_lfr(cfg) == (4, 3) and cfg.encoder_input_dim == 320
    assert model_lfr(dataclasses.replace(cfg, input_layer="conv2d")) == \
        (1, 1)
