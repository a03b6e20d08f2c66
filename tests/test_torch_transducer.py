"""Port RNN-T loss and TransducerModel (tpu_asr_torch.ops.transducer,
models.transducer) vs tpu_asr on the CPU: the same numpy inputs from a
seed, the same flax params carried across by load_jax_params.

Tolerances (float32): NLL rtol 1e-5, atol 1e-4; gradients rtol 1e-4,
atol 1e-5; model losses 1e-4; encoder outputs 1e-4 (ATOL).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models import TransducerModel as JaxTransducer
from tpu_asr.ops import transducer as jt
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch.models import build_model
from tpu_asr_torch.models.transducer import Predictor, TransducerModel
from tpu_asr_torch.ops import transducer as tt
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.weights import init_random, load_jax_params
from torch_port_util import (VOCAB, transducer_flax_params,
                             transducer_jax_cfg, transducer_torch_cfg,
                             transducer_torch_model)

NLL_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-4
ATOL = 1e-4
PRESETS = ("transducer_dev", "conformer_transducer_dev")


# ---- the lattice ----

@pytest.mark.parametrize("u1", [1, 2, 5, 17, 41])
def test_row_scan_matches_reference(u1):
    """The doubling scan against the reference's associative scan, with
    the tail of each row masked to NEG_INF as the lattice masks it."""
    rng = np.random.default_rng(u1)
    b = 4
    below = (rng.standard_normal((b, u1)) * 3 - 2).astype(np.float32)
    emit = (rng.standard_normal((b, u1 - 1)) * 3 - 2).astype(np.float32)
    for i, n in enumerate((u1 - 1, (u1 - 1) // 2, 0, min(1, u1 - 1))):
        emit[i, n:] = tt.NEG_INF
        below[i, n + 1:] = tt.NEG_INF
    want = np.asarray(jt._row_scan(jnp.asarray(below), jnp.asarray(emit)))
    got = tt._row_scan(torch.from_numpy(below), torch.from_numpy(emit))
    live = want > tt.NEG_INF / 2
    np.testing.assert_allclose(got.numpy()[live], want[live], **NLL_TOL)
    assert (got.numpy()[~live] < -1e29).all()


def _case(seed, b, t, u1, v, h=6):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, t, h)).astype(np.float32)
    g = rng.standard_normal((b, u1, h)).astype(np.float32)
    w = (rng.standard_normal((h, v)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(v) * 0.1).astype(np.float32)
    labels = rng.integers(1, v, (b, u1 - 1)).astype(np.int32)
    return f, g, w, bias, labels


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _brute_force_nll(lp, labels, t_len, u_len, blank=0):
    """float64 sum over every monotonic alignment of one utterance: lp
    [T, U+1, V] log-softmaxed joint outputs; emit u at frame t_u with
    t_0 <= t_1 <= ..., blank everywhere else (the terminal blank too)."""
    total = -np.inf
    for frames in itertools.product(range(t_len), repeat=u_len):
        if any(frames[i] > frames[i + 1] for i in range(u_len - 1)):
            continue
        s, u = 0.0, 0
        for t in range(t_len):
            while u < u_len and frames[u] == t:
                s += lp[t, u, labels[u]]
                u += 1
            s += lp[t, u, blank]
        total = np.logaddexp(total, s)
    return -total


def test_loss_matches_brute_force_enumeration():
    b, t, u1, v = 4, 4, 4, 5
    f, g, w, bias, labels = _case(0, b, t, u1, v)
    t_lens = np.array([4, 3, 2, 4], np.int32)
    u_lens = np.array([3, 1, 0, 2], np.int32)
    nll = tt.transducer_loss(*_t(f, g, w, bias, labels, t_lens, u_lens),
                             reduction="none").numpy()
    joint = np.tanh(f[:, :, None, :].astype(np.float64) + g[:, None])
    logits = joint @ w.astype(np.float64) + bias
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for i in range(b):
        want = _brute_force_nll(lp[i], labels[i], int(t_lens[i]),
                                int(u_lens[i]))
        np.testing.assert_allclose(nll[i], want, **NLL_TOL, err_msg=str(i))


@pytest.mark.parametrize("chunk_frames", [0, 1, 3])
def test_fused_equals_from_logits(chunk_frames, monkeypatch):
    """The chunked joint equals the fully materialized logits, with one
    chunk of all frames (0), a frame a chunk, and chunks of 3 frames
    over 7 (a short last chunk); under autograd too."""
    b, t, u1, v = 4, 7, 5, 9
    if chunk_frames:
        monkeypatch.setattr(tt, "JOINT_CHUNK_BYTES",
                            chunk_frames * b * u1 * v * 4)
    f, g, w, bias, labels = _case(1, b, t, u1, v)
    t_lens = np.array([7, 5, 6, 1], np.int32)
    u_lens = np.array([4, 2, 0, 1], np.int32)
    tf, tg, tw, tb, tl, tt_len, tu_len = _t(f, g, w, bias, labels, t_lens,
                                            u_lens)
    tf.requires_grad_(True)
    fused = tt.transducer_loss(tf, tg, tw, tb, tl, tt_len, tu_len,
                               reduction="none")
    joint = torch.tanh(tf[:, :, None, :] + tg[:, None])
    full = tt.transducer_loss_from_logits(joint @ tw + tb, tl, tt_len,
                                          tu_len)
    np.testing.assert_allclose(fused.detach().numpy(),
                               full.detach().numpy(), **NLL_TOL)
    gf, = torch.autograd.grad(fused.sum(), tf)
    gl, = torch.autograd.grad(full.sum(), tf)
    np.testing.assert_allclose(gf.numpy(), gl.numpy(), **GRAD_TOL)


def _grad_case():
    """Dummy row (length 0), a label_lengths 0 row, ragged lengths."""
    b, t, u1, v = 5, 6, 5, 8
    f, g, w, bias, labels = _case(2, b, t, u1, v)
    t_lens = np.array([6, 4, 0, 5, 2], np.int32)
    u_lens = np.array([4, 2, 3, 0, 2], np.int32)
    return f, g, w, bias, labels, t_lens, u_lens


@pytest.mark.parametrize("reduction", ["none", "sum", "mean", "mean_label"])
def test_nll_and_grads_match_jax(reduction):
    f, g, w, bias, labels, t_lens, u_lens = _grad_case()
    weights = np.linspace(0.5, 1.5, f.shape[0]).astype(np.float32)

    def jax_loss(f_, g_, w_, b_):
        out = jt.transducer_loss(f_, g_, w_, b_, jnp.asarray(labels),
                                 jnp.asarray(t_lens), jnp.asarray(u_lens),
                                 reduction=reduction)
        return out, (out * weights).sum() if reduction == "none" else out

    jargs = [jnp.asarray(x) for x in (f, g, w, bias)]
    want = jax_loss(*jargs)[0]
    jgrads = jax.grad(lambda *a: jax_loss(*a)[1], argnums=(0, 1, 2, 3))(
        *jargs)
    targs = [x.requires_grad_(True) for x in _t(f, g, w, bias)]
    got = tt.transducer_loss(*targs, *_t(labels, t_lens, u_lens),
                             reduction=reduction)
    scalar = (got * torch.from_numpy(weights)).sum() \
        if reduction == "none" else got
    tgrads = torch.autograd.grad(scalar, targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **NLL_TOL)
    if reduction == "none":
        assert got[2] == 0.0                     # the dummy row
        assert got[3] > 0.0                      # label_lengths 0: blanks
    for name, tg_, jg in zip("fgwb", tgrads, jgrads):
        np.testing.assert_allclose(tg_.numpy(), np.asarray(jg), **GRAD_TOL,
                                   err_msg=name)
    assert not tgrads[0][2].any()                # no gradient into a dummy


def test_padding_invariance():
    """Padding frames and labels past every length changes nothing: the
    NLL and the gradients on the unpadded part are equal."""
    f, g, w, bias, labels, t_lens, u_lens = _grad_case()
    rng = np.random.default_rng(9)
    fp = np.concatenate([f, rng.standard_normal((5, 3, 6)).astype(
        np.float32)], 1)
    gp = np.concatenate([g, rng.standard_normal((5, 2, 6)).astype(
        np.float32)], 1)
    lp = np.concatenate([labels, rng.integers(1, 8, (5, 2)).astype(
        np.int32)], 1)
    out = []
    for ff, gg, ll in ((f, g, labels), (fp, gp, lp)):
        tf, tg = (x.requires_grad_(True) for x in _t(ff, gg))
        nll = tt.transducer_loss(tf, tg, *_t(w, bias, ll, t_lens, u_lens),
                                 reduction="none")
        out.append((nll.detach(), *torch.autograd.grad(nll.sum(), (tf, tg))))
    np.testing.assert_allclose(out[1][0].numpy(), out[0][0].numpy(),
                               **NLL_TOL)
    np.testing.assert_allclose(out[1][1][:, :6].numpy(), out[0][1].numpy(),
                               **GRAD_TOL)
    np.testing.assert_allclose(out[1][2][:, :5].numpy(), out[0][2].numpy(),
                               **GRAD_TOL)
    assert not out[1][1][:, 6:].any() and not out[1][2][:, 5:].any()


# ---- the predictor ----

def test_predictor_forward_equals_step_rows():
    """Predictor.forward equals its per-row cached step (step_at): each
    row at its own position, some rows holding their position (rewriting
    it with the same token) while others advance; and the forward equals
    the reference's predict_sequence."""
    model = transducer_torch_model()
    jm = JaxTransducer(transducer_jax_cfg())
    params = transducer_flax_params()
    rng = np.random.default_rng(4)
    b, u1 = 3, 6
    ys = np.concatenate([np.full((b, 1), VOCAB - 2),
                         rng.integers(1, VOCAB - 2, (b, u1 - 1))], 1)
    want = np.asarray(jm.apply(params, jnp.asarray(ys, jnp.int32),
                               method="predict_sequence"))
    with torch.no_grad():
        g = model.predict_sequence(torch.from_numpy(ys))
        h = model.predictor(torch.from_numpy(ys))
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL)
        cache = model.predictor_init_cache(b, u1)
        pos = torch.zeros(b, dtype=torch.long)
        got = torch.full_like(h, float("nan"))
        mixed = 0          # steps where some rows hold and others advance
        while True:
            y = torch.from_numpy(ys)[torch.arange(b), pos]
            out, cache = model.predictor.step_at(y, pos, cache)
            got[torch.arange(b), pos] = out
            if bool((pos == u1 - 1).all()):
                break
            advance = torch.from_numpy(rng.random(b) < 0.5)
            mixed += bool(advance.any() and not advance.all())
            pos = (pos + advance).clamp(max=u1 - 1)
    assert not got.isnan().any() and mixed >= 3
    np.testing.assert_allclose(got.numpy(), h.numpy(), atol=1e-5)
    assert not hasattr(model.predictor, "out_proj")    # no output layer


# ---- the model ----

def _batch(seed, b=4, t=61, u=6, flens=(61, 50, 0, 37)):
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


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
@pytest.mark.parametrize("preset", PRESETS)
def test_model_losses_match(preset, ctc_weight):
    batch = _batch(3)
    jm = JaxTransducer(transducer_jax_cfg(preset, ctc_weight=ctc_weight))
    want = jm.apply(transducer_flax_params(preset, 0, ctc_weight),
                    *(jnp.asarray(batch[k]) for k in (
                        "feats", "feat_lengths", "targets",
                        "target_lengths")))
    model = transducer_torch_model(preset, ctc_weight=ctc_weight)
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in (
            "feats", "feat_lengths", "targets", "target_lengths")))
    assert set(got) == set(want)
    assert ("loss_ctc" in got) == (ctc_weight > 0)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)


@pytest.mark.parametrize("left_chunks", [-1, 1])
@pytest.mark.parametrize("preset", PRESETS)
def test_chunk_masked_encoder_matches(preset, left_chunks):
    """enc_chunk_size=4 offline, for both encoder types (the conformer's
    depthwise conv turns causal): the encoder output and the model's
    losses equal the reference's; the mask changes the output."""
    kw = dict(enc_chunk_size=4, enc_left_chunks=left_chunks)
    batch = _batch(6, t=81, flens=(81, 64, 0, 45))
    params = transducer_flax_params(preset)
    jm = JaxTransducer(transducer_jax_cfg(preset, **kw))
    feats, flens = (batch[k] for k in ("feats", "feat_lengths"))
    want, wl = jm.apply(params, jnp.asarray(feats), jnp.asarray(flens),
                        method="encode")
    model = transducer_torch_model(preset, **kw)
    full = transducer_torch_model(preset)
    with torch.no_grad():
        got, gl = model.encode(*_t(feats, flens))
        unmasked, _ = full.encode(*_t(feats, flens))
        losses = model(*_t(*(batch[k] for k in (
            "feats", "feat_lengths", "targets", "target_lengths"))))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not np.allclose(got.numpy(), unmasked.numpy(), atol=1e-2)
    jl = jm.apply(params, *(jnp.asarray(batch[k]) for k in (
        "feats", "feat_lengths", "targets", "target_lengths")))
    np.testing.assert_allclose(float(losses["loss"]), float(jl["loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


D_MODEL, WARMUP = 64, 100


@pytest.fixture(scope="module", params=PRESETS)
def three_steps(request):
    """Three train steps of each package on three batches (float32,
    dropout 0, no SpecAugment)."""
    preset = request.param
    tx = make_optimizer(D_MODEL, WARMUP, 1.0, 5.0)
    state = TrainState.create(transducer_flax_params(preset)["params"], tx,
                              jax.random.PRNGKey(1))
    jstep = make_train_step(JaxTransducer(transducer_jax_cfg(preset)), tx,
                            donate=False)
    model = transducer_torch_model(preset)
    ts = TrainStep(model, NoamAdam(model.parameters(), D_MODEL, WARMUP, 1.0,
                                   5.0), device="cpu")
    jm, tm = [], []
    for i in range(3):
        batch = _batch(10 + i)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in ts(batch).items()})
    return jm, tm


def test_train_steps_match_reference(three_steps):
    """Three steps' losses within 1e-4, step 1's grad norm within 1e-4
    relative; the Solver's metrics carry loss_rnnt."""
    jm, tm = three_steps
    assert {"loss", "loss_rnnt", "loss_ctc", "grad_norm"} <= set(tm[0])
    for i in range(3):
        for k in ("loss", "loss_rnnt", "loss_ctc"):
            np.testing.assert_allclose(tm[i][k], jm[i][k], rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=f"{i} {k}")
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)
    assert tm[2]["loss"] != tm[0]["loss"]


# ---- weights, presets ----

def test_load_is_strict_on_transducer_trees():
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            walk(v, key) if isinstance(v, dict) else flat.update({key: v})
    walk(transducer_flax_params()["params"], "")
    model = TransducerModel(transducer_torch_cfg())
    load_jax_params(model, flat)
    np.testing.assert_array_equal(model.joint_out_kernel.detach().numpy(),
                                  flat["joint_out_kernel"])   # [dj, V] kept
    assert model.joint_out_kernel.shape == (64, VOCAB)
    missing = dict(flat)
    missing.pop("joint_out_kernel")
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    extra = dict(flat, **{"predictor/out_proj/kernel":
                          np.zeros((64, VOCAB), np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(model, extra)
    for key, bad in (("joint_out_kernel", flat["joint_out_kernel"].T),
                     ("joint_out_bias", np.zeros(VOCAB + 1, np.float32))):
        with pytest.raises(ValueError):
            load_jax_params(model, dict(flat, **{key: bad}))


def test_init_random_joint_out():
    """joint_out_kernel [d_joint, V] is lecun_normal over fan_in =
    d_joint (variance 1/d_joint within 10%), joint_out_bias zeros; the
    same seed gives the same weights."""
    cfg = dataclasses.replace(transducer_torch_cfg(), d_joint=128,
                              vocab_size=2000)
    model = init_random(TransducerModel(cfg), 3)
    w = model.joint_out_kernel.detach()
    assert abs(float(w.var()) * 128 - 1.0) < 0.1
    assert float(w.abs().max()) <= 2.0 / (128 ** 0.5 * 0.8796) + 1e-6
    assert not model.joint_out_bias.any()
    again = init_random(TransducerModel(cfg), 3)
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))


def test_build_model_builds_a_transducer():
    for preset in PRESETS:
        model = build_model(transducer_torch_cfg(preset))
        assert isinstance(model, TransducerModel)
        assert isinstance(model.predictor, Predictor)
        assert not model.training
    assert not hasattr(build_model(transducer_torch_cfg(ctc_weight=0.0)),
                       "ctc_head")


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


@pytest.mark.parametrize("name", ["transducer_dev",
                                  "conformer_transducer_dev", "transducer",
                                  "conformer_transducer"])
def test_presets_equal_reference(name):
    from tpu_asr.configs.presets import get_preset as jax_preset
    from tpu_asr_torch.configs.presets import get_preset
    got = _plain(get_preset(name))
    assert got == _plain(jax_preset(name))
    assert got["model"]["model_type"] == "transducer"
