"""Port conformer (tpu_asr_torch.models.conformer and the encoder's
conformer branch) vs tpu_asr.models.conformer on the CPU, from the same
flax params (conformer_dev widths: d64, h2, 2+2 layers, conv kernel 7)
and the same numpy inputs.

Tolerances: rel_shift and rel_sinusoid_table bit-equal; the modules,
the encoder, the heads and the cached steps in float32 within ATOL =
1e-4 (tests/test_torch_model.py); the bf16 encoder within 0.1 (as
test_bf16_encoder_close); one train step's losses within rtol 1e-5 and
three steps' within 1e-4 (as tests/test_torch_train.py holds
hybrid_dev); decoded tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.models import conformer as jconf
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.models import conformer as tconf
from tpu_asr_torch.models.transformer import Transformer
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.weights import flax_to_torch, load_jax_params
from torch_port_util import (VOCAB, conformer_flax_params, conformer_jax_cfg,
                             conformer_torch_cfg, conformer_torch_model,
                             wav_batch)

ATOL = 1e-4


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def load_subtree(module, tree, name):
    """Port module <- the flax params subtree of the module called `name`
    (its key rules read the owner's name), strictly."""
    state = dict(flax_to_torch(k, v) for k, v in flat(tree, name).items())
    module.load_state_dict({k.split(".", 1)[1]: torch.tensor(v)
                            for k, v in state.items()}, strict=True)
    return module


def layer_params(i=0):
    return conformer_flax_params()["params"]["encoder"][f"layer_{i}"]


def ragged(b, t, lens, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return x, valid


def bias_of(valid):
    return np.where(valid[:, None, None, :], 0.0, -1e30).astype(np.float32)


# ---- rel_shift and the relative table ----

@pytest.mark.parametrize("t", [1, 2, 5, 16])
def test_rel_shift_bit_equal(t):
    """Bit-equal to the reference's pad-reshape shift and to a gather
    oracle: out[..., i, j] = x[..., i, (T-1) + (j - i)]."""
    x = np.random.default_rng(t).standard_normal(
        (2, 3, t, 2 * t - 1)).astype(np.float32)
    got = tconf.rel_shift(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconf.rel_shift(
        jnp.asarray(x))))
    i, j = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    np.testing.assert_array_equal(got, x[:, :, i, (t - 1) + j - i])


@pytest.mark.parametrize("t,d", [(1, 8), (7, 64), (50, 512)])
def test_rel_sinusoid_table_equal(t, d):
    got = tconf.rel_sinusoid_table(t, d)
    assert got.shape == (2 * t - 1, d) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jconf.rel_sinusoid_table(t, d))
    table = tconf.rel_table(t, d, torch.bfloat16, "cpu")
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(table.float().numpy(), np.asarray(
        jnp.asarray(got).astype(jnp.bfloat16).astype(jnp.float32)))


# ---- the modules, float32 ----

def test_depthwise_conv_matches():
    p = layer_params()["conv"]["depthwise"]
    k, _, c = p["kernel"].shape
    h = np.random.default_rng(1).standard_normal((2, 20 + k - 1, c)).astype(
        np.float32)
    want = jconf.DepthwiseConv1d(c, k).apply({"params": p}, jnp.asarray(h))
    mod = load_subtree(tconf.DepthwiseConv1d(c, k), p, "depthwise")
    assert tuple(mod.weight.shape) == (c, 1, k)
    with torch.no_grad():
        got = mod(torch.from_numpy(h))
    assert got.shape == (2, 20, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_conv_module_matches(causal):
    """Offline (centered) and causal (enc_chunk_size > 0) padding; padded
    frames zeroed before and after the GLU."""
    kw = {"enc_chunk_size": 4} if causal else {}
    x, valid = ragged(3, 13, [13, 8, 0], seed=2)
    p = layer_params()["conv"]
    want = jconf.ConvModule(conformer_jax_cfg(**kw)).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(valid))
    mod = load_subtree(tconf.ConvModule(conformer_torch_cfg(**kw)), p,
                       "conv").eval()
    assert mod.causal is causal
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rel_pos_attention_matches():
    x, valid = ragged(3, 11, [11, 6, 0], seed=3)
    pos = tconf.rel_sinusoid_table(11, 64)
    p = layer_params()["slf_attn"]
    want = jconf.RelPosMultiHeadAttention(conformer_jax_cfg()).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(bias_of(valid)))
    mod = load_subtree(tconf.RelPosMultiHeadAttention(conformer_torch_cfg()),
                       p, "slf_attn")
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.tensor(pos),
                  torch.from_numpy(bias_of(valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---- the streaming steps, chunk by chunk ----

CHUNK, T_MAX = 3, 9


def _chunks(seed):
    x = np.random.default_rng(seed).standard_normal(
        (2, T_MAX, 64)).astype(np.float32)
    return [x[:, i:i + CHUNK] for i in range(0, T_MAX, CHUNK)]


def _step_bias(pos):
    allowed = np.arange(T_MAX) < pos + CHUNK
    return bias_of(np.broadcast_to(allowed, (2, T_MAX)))


@pytest.mark.parametrize("which", ["attention", "conv", "layer"])
def test_step_matches_reference(which):
    """Three chunks through each module's step on both sides, caches
    carried: every chunk's output (and the new caches) agree."""
    jcfg, tcfg = (conformer_jax_cfg(enc_chunk_size=CHUNK),
                  conformer_torch_cfg(enc_chunk_size=CHUNK))
    h, dh, d, k = 2, 32, 64, jcfg.conv_kernel
    if which == "attention":
        p = layer_params()["slf_attn"]
        jm = jconf.RelPosMultiHeadAttention(jcfg)
        tm = load_subtree(tconf.RelPosMultiHeadAttention(tcfg), p,
                          "slf_attn")
    elif which == "conv":
        p = layer_params()["conv"]
        jm, tm = jconf.ConvModule(jcfg), load_subtree(
            tconf.ConvModule(tcfg), p, "conv")
    else:
        p = layer_params(1)
        jm, tm = jconf.ConformerLayer(jcfg), load_subtree(
            tconf.ConformerLayer(tcfg), p, "layer")
    tm.eval()
    jk = jv = jnp.zeros((2, T_MAX, h, dh))
    tk, tv = torch.zeros(2, T_MAX, h, dh), torch.zeros(2, T_MAX, h, dh)
    jc, tc = jnp.zeros((2, k - 1, d)), torch.zeros(2, k - 1, d)
    for n, x in enumerate(_chunks(7)):
        pos, bias = n * CHUNK, _step_bias(n * CHUNK)
        with torch.no_grad():
            if which == "attention":
                want, jk, jv = jm.apply({"params": p}, jnp.asarray(x), pos,
                                        jk, jv, jnp.asarray(bias),
                                        method="step")
                got, tk, tv = tm.step(torch.from_numpy(x), pos, tk, tv,
                                      torch.from_numpy(bias))
            elif which == "conv":
                want, jc = jm.apply({"params": p}, jnp.asarray(x), jc,
                                    method="step")
                got, tc = tm.step(torch.from_numpy(x), tc)
            else:
                want, jk, jv, jc = jm.apply(
                    {"params": p}, jnp.asarray(x), pos, jk, jv, jc,
                    jnp.asarray(bias), method="step")
                got, tk, tv, tc = tm.step(torch.from_numpy(x), pos, tk, tv,
                                          tc, torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=f"chunk {n}")
        for a, b in ((tk, jk), (tv, jv), (tc, jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_causal_conv_step_equals_offline():
    """The chunked conv steps give the causal module's offline output."""
    tm = load_subtree(tconf.ConvModule(conformer_torch_cfg(
        enc_chunk_size=CHUNK)), layer_params()["conv"], "conv").eval()
    chunks = _chunks(8)
    cache = torch.zeros(2, 6, 64)
    outs = []
    with torch.no_grad():
        for x in chunks:
            out, cache = tm.step(torch.from_numpy(x), cache)
            outs.append(out)
        full = tm(torch.from_numpy(np.concatenate(chunks, 1)),
                  torch.ones(2, T_MAX, dtype=torch.bool))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-6)


# ---- the encoder and the model ----

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 41, 80)).astype(np.float32)
    flens = np.array([41, 30, 0], np.int32)     # incl. a length-0 dummy row
    ys = rng.integers(0, VOCAB, (3, 5)).astype(np.int32)
    jm, params = JaxTransformer(conformer_jax_cfg()), conformer_flax_params()
    enc, el = jm.apply(params, jnp.asarray(feats), jnp.asarray(flens),
                       method="encode")
    tm = conformer_torch_model()
    with torch.no_grad():
        tenc, tel = tm.encode(torch.from_numpy(feats), torch.from_numpy(flens))
    return dict(feats=feats, flens=flens, ys=ys, jm=jm, params=params,
                enc=enc, el=el, tm=tm, tenc=tenc, tel=tel)


def test_encoder_matches(setup):
    np.testing.assert_array_equal(np.asarray(setup["el"]),
                                  setup["tel"].numpy())
    assert setup["tenc"].shape == (3, 9, 64)
    assert not hasattr(setup["tm"].encoder, "pe")    # no absolute PE
    np.testing.assert_allclose(setup["tenc"].numpy(),
                               np.asarray(setup["enc"]), atol=ATOL)


def test_use_pallas_encoder_stays_plain(setup):
    """use_pallas leaves the conformer layers plain (their output is
    the plain encoder's) as in the reference."""
    jm = JaxTransformer(conformer_jax_cfg(use_pallas=True))
    enc, _ = jm.apply(setup["params"], jnp.asarray(setup["feats"]),
                      jnp.asarray(setup["flens"]), method="encode")
    tm = conformer_torch_model(use_pallas=True)
    with torch.no_grad():
        got, _ = tm.encode(torch.from_numpy(setup["feats"]),
                           torch.from_numpy(setup["flens"]))
    assert torch.equal(got, setup["tenc"])
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), atol=ATOL)


def test_bf16_encoder_close(setup):
    jm = JaxTransformer(conformer_jax_cfg(dtype=jnp.bfloat16))
    want, _ = jm.apply(setup["params"], jnp.asarray(setup["feats"][:2]),
                       jnp.asarray(setup["flens"][:2]), method="encode")
    tm = conformer_torch_model(dtype=torch.bfloat16)
    with torch.no_grad():
        got, _ = tm.encode(torch.from_numpy(setup["feats"][:2]),
                           torch.from_numpy(setup["flens"][:2]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.1)


def test_encoder_invariant_to_pad_width(setup):
    """The same utterances in a wider bucket: equal outputs on the valid
    frames, zeros past them."""
    feats = np.zeros((3, 77, 80), np.float32)
    feats[:, :41] = setup["feats"]
    with torch.no_grad():
        wide, wl = setup["tm"].encode(torch.from_numpy(feats),
                                      torch.from_numpy(setup["flens"]))
    assert torch.equal(wl, setup["tel"])
    t = setup["tenc"].shape[1]
    np.testing.assert_allclose(wide[:, :t].numpy(), setup["tenc"].numpy(),
                               atol=1e-5)
    assert not wide[:, t:].any()


def test_ctc_logits_match(setup):
    want = setup["jm"].apply(setup["params"], setup["enc"],
                             method="ctc_logits")
    with torch.no_grad():
        got = setup["tm"].ctc_logits(setup["tenc"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_teacher_forced_decoder_matches(setup):
    want = setup["jm"].apply(setup["params"], setup["enc"], setup["el"],
                             jnp.asarray(setup["ys"]),
                             method="decode_logits")
    with torch.no_grad():
        got = setup["tm"].decode_logits(setup["tenc"], setup["tel"],
                                        torch.from_numpy(setup["ys"]).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---- training ----

D_MODEL, WARMUP = 64, 100


def make_batch(seed, b=4, t=61, u=6, flens=(61, 50, 0, 37)):
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


@pytest.fixture(scope="module")
def three_steps():
    tx = make_optimizer(D_MODEL, WARMUP, 1.0, 5.0)
    state = TrainState.create(conformer_flax_params()["params"], tx,
                              jax.random.PRNGKey(1))
    jstep = make_train_step(JaxTransformer(conformer_jax_cfg()), tx,
                            donate=False)
    model = conformer_torch_model()
    ts = TrainStep(model, NoamAdam(model.parameters(), D_MODEL, WARMUP, 1.0,
                                   5.0), device="cpu")
    jm, tm = [], []
    for i in range(3):
        batch = make_batch(i)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in ts(batch).items()})
    return jm, tm


def test_one_step_matches_reference(three_steps):
    jm, tm = three_steps
    for k in ("loss", "loss_att", "loss_ctc", "acc"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)


def test_three_steps_losses_match(three_steps):
    jm, tm = three_steps
    for i in range(3):
        np.testing.assert_allclose(tm[i]["loss"], jm[i]["loss"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    assert tm[2]["loss"] != tm[0]["loss"]


def test_pallas_ctc_false_matches_reference_scan():
    """pallas_ctc=False changes no route in the port (the device picks
    it): the step equals the default's, and its CTC loss equals the
    reference's XLA scan, which that flag selects there."""
    batch = make_batch(5)
    out = {}
    for flag in (None, False):
        model = conformer_torch_model(pallas_ctc=flag)
        ts = TrainStep(model, NoamAdam(model.parameters(), D_MODEL, WARMUP),
                       device="cpu")
        out[flag] = {k: float(v) for k, v in ts(batch).items()}
    assert out[False] == out[None]
    tx = make_optimizer(D_MODEL, WARMUP, 1.0, 5.0)
    state = TrainState.create(conformer_flax_params()["params"], tx,
                              jax.random.PRNGKey(1))
    jstep = make_train_step(JaxTransformer(conformer_jax_cfg(
        pallas_ctc=False)), tx, donate=False)
    _, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out[False]["loss_ctc"], float(m["loss_ctc"]),
                               rtol=1e-5)


# ---- decoding ----

BATCH = wav_batch([9600, 6400, 3000, 0], seed=5)


@pytest.mark.parametrize("mode,beam_kw", [
    ("joint", dict(beam=3, max_len=8, ctc_weight=0.3, nbest=3)),
    ("attn_rescore", dict(beam=4, max_len=8, ctc_weight=0.3, nbest=4)),
])
def test_decode_tokens_match(mode, beam_kw):
    jrec = JaxRecognizer(cfg=conformer_jax_cfg(),
                         params=conformer_flax_params(), mode=mode,
                         beam=JaxBeam(**beam_kw))
    trec = Recognizer(conformer_torch_cfg(), conformer_torch_model(),
                      mode=mode, device="cpu", beam=BeamConfig(**beam_kw))
    want, got = jrec.decode_batch_nbest(BATCH), trec.decode_batch_nbest(BATCH)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert [h["yseq"] for h in g] == [h["yseq"] for h in w], i
        for hw, hg in zip(w, g):
            assert abs(hg["score"] - hw["score"]) <= 1e-4, i
    assert any(h[0]["yseq"] for h in got)


# ---- weights ----

def test_load_is_strict_on_conformer_trees():
    params = {k[len("params/"):]: v for k, v in
              flat(conformer_flax_params()).items()}
    model = Transformer(conformer_torch_cfg())
    load_jax_params(model, params)
    assert "encoder.layers.0.slf_attn.u_bias" in model.state_dict()
    assert model.encoder.layers[0].slf_attn.pos_proj.bias is None
    dw = "encoder/layer_1/conv/depthwise/kernel"
    missing = dict(params)
    missing.pop("encoder/layer_0/slf_attn/v_bias")
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    extra = dict(params)
    extra["encoder/layer_0/slf_attn/pos_proj/bias"] = np.zeros((2, 32))
    with pytest.raises(KeyError):
        load_jax_params(model, extra)
    k, _, c = params[dw].shape
    for bad in (np.zeros((k, c), np.float32),          # not [k, 1, C]
                np.zeros((k, 2, c), np.float32),
                np.zeros((k + 2, 1, c), np.float32)):  # another kernel size
        with pytest.raises(ValueError):
            load_jax_params(model, dict(params, **{dw: bad}))


def _plain(x):
    """A config as nested dicts, dtypes by name (jnp or torch)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).rsplit(".", 1)[-1]
    if isinstance(x, type):                      # jnp.float32 and the like
        return np.dtype(x).name
    return x


@pytest.mark.parametrize("name", ["conformer_dev", "conformer"])
def test_presets_equal_reference(name):
    from tpu_asr.configs.presets import get_preset as jax_preset
    from tpu_asr_torch.configs.presets import get_preset
    got = _plain(get_preset(name))
    assert got == _plain(jax_preset(name))
    assert got["model"]["encoder_type"] == "conformer"
