"""Port CIF model, decode, training and serving vs tpu_asr's CIF model on
the CPU, from one flax initialisation at cif_dev widths (d64, h2, 2+2
layers, conv (8, 16), vocab 32, ctc weight 0.5, float32, dropout 0).

Tolerances: activations 1e-4 absolute, losses 1e-5 (float32; sums in
another order), the gradients' global norm 1e-4 relative, three train
steps' losses 1e-4; decoded tokens equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_asr import IGNORE_ID
from tpu_asr.decode.beam import BeamConfig as JaxBeam
from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
from tpu_asr.models import CifModel as JaxCifModel
from tpu_asr.models.cif import CifDecoder as JaxCifDecoder
from tpu_asr.train import TrainState, make_optimizer, make_train_step
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.decode.recognizer import Recognizer
from tpu_asr_torch.models import CifModel, Transformer, build_model
from tpu_asr_torch.train import NoamAdam, TrainStep
from tpu_asr_torch.train.checkpoints import Checkpointer
from tpu_asr_torch.train.optim import global_norm
from tpu_asr_torch.weights import flax_to_torch, load_jax_params
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_cfg, cif_torch_model, torch_cfg,
                             wav_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
D_MODEL, WARMUP = 64, 100
# a long row, a shorter one, a short one and a length-0 dummy row
WAVS = wav_batch([12000, 9600, 4800, 0], seed=7)


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


def _args(batch, to):
    return [to(batch[k]) for k in ("feats", "feat_lengths", "targets",
                                   "target_lengths")]


@pytest.fixture(scope="module")
def encoded():
    batch = make_batch(0)
    jm = JaxCifModel(cif_jax_cfg())
    want = jax.jit(lambda v, f, fl: jm.apply(v, f, fl, method="encode"))(
        cif_flax_params(), *_args(batch, jnp.asarray)[:2])
    tm = cif_torch_model()
    with torch.no_grad():
        got = tm.encode(*_args(batch, torch.from_numpy)[:2])
    return batch, jm, want, tm, got


def test_encode_matches(encoded):
    """enc_out, enc_lengths, alphas and the valid mask."""
    _, _, want, _, got = encoded
    enc, el, alphas, valid = got
    np.testing.assert_allclose(enc.numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_array_equal(el.numpy(), np.asarray(want[1]))
    assert alphas.dtype == torch.float32
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want[2]),
                               atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want[3]))
    assert not alphas[2].any()                       # the dummy row


def test_decoder_steps_match_reference_and_teacher_forcing(encoded):
    """Three cached CifDecoder steps equal the reference's step API and the
    teacher-forced logits at the same positions."""
    batch, _, _, tm, (enc, _, alphas, _) = encoded
    rng = np.random.default_rng(2)
    ys = rng.integers(0, VOCAB, (4, 5)).astype(np.int32)
    with torch.no_grad():
        fired = tm.fire(enc, alphas, 5)
        teacher = tm.decode_logits(torch.from_numpy(ys).long(), fired)
    jd = JaxCifDecoder(cif_jax_cfg())
    dp = {"params": cif_flax_params()["params"]["decoder"]}
    jcache = jd.apply(dp, 4, 5, method="init_cache")
    tcache = tm.decoder.init_cache(4, 5)
    jfired = jnp.asarray(fired.numpy())
    for pos in range(3):
        jl, jcache = jd.apply(dp, jnp.asarray(ys[:, pos]), jfired[:, pos],
                              pos, jcache, method="step")
        with torch.no_grad():
            tl, tcache = tm.decoder.step(torch.from_numpy(ys[:, pos]).long(),
                                         fired[:, pos], pos, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {pos}")
        np.testing.assert_allclose(tl.numpy(), teacher[:, pos].numpy(),
                                   atol=ATOL)


def test_forward_losses_match(encoded):
    """loss, loss_att, loss_qty, loss_ctc and acc, with a dummy row."""
    batch, jm, _, tm, _ = encoded
    want = jax.jit(jm.apply)(cif_flax_params(), *_args(batch, jnp.asarray))
    with torch.no_grad():
        got = tm(*_args(batch, torch.from_numpy))
    assert set(got) == set(want) == {"loss", "loss_att", "loss_qty",
                                     "loss_ctc", "acc"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    c = cif_torch_cfg()
    np.testing.assert_allclose(
        got["loss"].item(), got["loss_att"].item() + c.cif_quantity_weight
        * got["loss_qty"].item() + c.ctc_weight * got["loss_ctc"].item(),
        rtol=1e-6)


def test_gradient_global_norm_matches(encoded):
    batch, jm, _, _, _ = encoded
    params = cif_flax_params()

    def loss(p):
        return jm.apply({"params": p}, *_args(batch, jnp.asarray))["loss"]
    jgrads = jax.jit(jax.grad(loss))(params["params"])
    tm = cif_torch_model()
    out = tm(*_args(batch, torch.from_numpy))
    tgrads = torch.autograd.grad(out["loss"], list(tm.parameters()))
    np.testing.assert_allclose(global_norm(tgrads).item(),
                               float(optax.global_norm(jgrads)), rtol=1e-4)


def _fire_margin(tm, batch):
    """Distance of each row's sum(alpha) from the nearest multiple of 0.5
    (where fire_count's floor and 0.5 tail could flip by one ulp)."""
    from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
    feats, flens = wav_to_features(torch.from_numpy(batch["wav"]),
                                   torch.from_numpy(batch["wav_lengths"]),
                                   FrontendConfig())
    with torch.no_grad():
        _, _, alphas, valid = tm.encode(feats, flens)
    total = alphas.double().sum(1)[batch["wav_lengths"] > 0]
    frac = torch.remainder(total, 0.5)
    return float(torch.minimum(frac, 0.5 - frac).min())


@pytest.mark.parametrize("mode", ["cif_greedy", "cif_beam"])
@pytest.mark.parametrize("scale_fire", [True, False])
def test_decode_matches_jax(mode, scale_fire):
    tm = cif_torch_model()
    assert _fire_margin(tm, WAVS) > 1e-4
    jrec = JaxRecognizer(cfg=cif_jax_cfg(), params=cif_flax_params(),
                         mode=mode, beam=JaxBeam(beam=3, max_len=10),
                         cif_scale_fire=scale_fire)
    trec = Recognizer(cif_torch_cfg(), tm, mode=mode, device="cpu",
                      beam=BeamConfig(beam=3, max_len=10),
                      cif_scale_fire=scale_fire)
    want = jrec.decode_batch_nbest(WAVS)
    got = trec.decode_batch_nbest(WAVS)
    assert [h[0]["yseq"] for h in got] == [h[0]["yseq"] for h in want]
    assert got == want
    assert any(h[0]["yseq"] for h in got) and not got[3][0]["yseq"]
    assert trec.decode_steps > 0


def test_greedy_equals_beam_1():
    trec = Recognizer(cif_torch_cfg(), cif_torch_model(), mode="cif_greedy",
                      device="cpu", beam=BeamConfig(beam=1, max_len=10))
    brec = Recognizer(cif_torch_cfg(), cif_torch_model(), mode="cif_beam",
                      device="cpu", beam=BeamConfig(beam=1, max_len=10))
    assert trec.decode_batch(WAVS) == brec.decode_batch(WAVS)


def test_cif_modes_need_a_cif_model():
    with pytest.raises(ValueError):
        Recognizer(torch_cfg(), Transformer(torch_cfg()), mode="cif_greedy",
                   device="cpu")
    with pytest.raises(ValueError):
        Recognizer(cif_torch_cfg(), cif_torch_model(), mode="joint",
                   device="cpu")
    with pytest.raises(NotImplementedError):
        Transformer(cif_torch_cfg())
    assert isinstance(build_model(cif_torch_cfg()), CifModel)
    assert isinstance(build_model(torch_cfg()), Transformer)


# ---- training ----

def port_step():
    model = cif_torch_model()
    return TrainStep(model, NoamAdam(model.parameters(), D_MODEL, WARMUP),
                     device="cpu")


@pytest.fixture(scope="module")
def three_steps():
    tx = make_optimizer(D_MODEL, WARMUP, 1.0, 5.0)
    state = TrainState.create(cif_flax_params()["params"], tx,
                              jax.random.PRNGKey(1))
    jstep = make_train_step(JaxCifModel(cif_jax_cfg()), tx, donate=False)
    ts = port_step()
    jm, tm = [], []
    for i in range(3):
        batch = make_batch(10 + i)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in ts(batch).items()})
    return jm, tm, ts


def test_one_train_step_matches_reference(three_steps):
    jm, tm, _ = three_steps
    assert set(tm[0]) == set(jm[0])
    for k in ("loss", "loss_att", "loss_qty", "loss_ctc", "acc"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm[0]["grad_norm"], jm[0]["grad_norm"],
                               rtol=1e-4)


def test_three_train_steps_losses_match(three_steps):
    jm, tm, ts = three_steps
    for i in range(3):
        for k in ("loss", "loss_qty"):
            np.testing.assert_allclose(tm[i][k], jm[i][k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    assert tm[2]["loss"] != tm[0]["loss"] and ts.optimizer.count == 3


def test_train_cli_then_serve_its_checkpoint(tmp_path):
    """python -m tpu_asr_torch.train --preset cif_dev, then the server
    loads the checkpoint (model_config.json restores model_type cif) and
    answers in cif_greedy; /healthz reports the model type."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_asr_torch.train", "--preset", "cif_dev",
         "--synthetic", "32", "--epochs", "2", "--device", "cpu",
         "--save-folder", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    ck = Checkpointer(str(tmp_path))
    cfg = ck.load_config()
    from tpu_asr_torch.configs.presets import get_preset
    assert cfg.model_type == "cif" and cfg == dataclasses.replace(
        get_preset("cif_dev").model, vocab_size=64)
    records = [json.loads(x) for x in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    cv = [r for r in records if r.get("phase") == "cv"]
    assert len(cv) == 2 and all(np.isfinite(r["loss"]) and
                                r["nonfinite_steps"] == 0 for r in cv)

    from tpu_asr_torch.serve import build_server, make_http_server, parse_args
    server = build_server(parse_args(["--ckpt", str(tmp_path), "--device",
                                      "cpu", "--bucket-frames", "128"]))
    assert server.rec.mode == "cif_greedy"
    wav = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    server.start()
    httpd = make_http_server("127.0.0.1", 0, server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        nbest = server.submit("wav", wav, timeout=120)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        server.stop()
    assert all(0 <= t < 63 for t in nbest[0]["yseq"])
    assert health["model_type"] == "cif" and health["mode"] == "cif_greedy"


# ---- weights ----

def test_load_is_strict_for_the_cif_tree():
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            walk(v, key) if isinstance(v, dict) else flat.update({key: v})
    walk(cif_flax_params()["params"], "")
    groups = {k.split("/")[0] for k in flat}
    assert groups == {"encoder", "assigner", "decoder", "ctc_head"}
    assert {"assigner/conv/kernel", "assigner/proj/kernel",
            "decoder/embed/embedding", "decoder/fuse/kernel",
            "decoder/layer_1/post_ffn/LayerNorm_0/scale",
            "ctc_head/ctc_proj/kernel"} <= set(flat)
    model = CifModel(cif_torch_cfg())
    load_jax_params(model, flat)
    missing = dict(flat)
    missing.pop("assigner/conv/bias")
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    bad = dict(flat, **{"assigner/proj/kernel": np.zeros((64, 2),
                                                         np.float32)})
    with pytest.raises(ValueError):
        load_jax_params(model, bad)


def test_conv1d_kernel_mapping():
    """flax Conv WIO [3, D_in, D_out] -> torch Conv1d [D_out, D_in, 3]."""
    k = np.random.default_rng(0).standard_normal((3, 4, 5)).astype(
        np.float32)
    key, v = flax_to_torch("assigner/conv/kernel", k)
    assert key == "assigner.conv.weight" and v.shape == (5, 4, 3)
    assert v[2, 1, 0] == k[0, 1, 2] and v[4, 3, 2] == k[2, 3, 4]
    model = cif_torch_model()
    np.testing.assert_array_equal(
        model.assigner.conv.weight.detach().numpy(),
        np.asarray(cif_flax_params()["params"]["assigner"]["conv"]
                   ["kernel"]).transpose(2, 1, 0))


def test_init_random_conv1d_draws_flax_lecun_normal():
    """fan_in = in_channels * 3; std within 2% of flax's, none beyond 2
    sigma of the untruncated scale."""
    from flax import linen as fnn
    from torch import nn as tnn
    from tpu_asr_torch.weights import TRUNC_STD, init_random
    want = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (3, 512, 512)))
    w = init_random(tnn.Sequential(tnn.Conv1d(512, 512, 3)),
                    0)[0].weight.detach().numpy()
    fan_in = 512 * 3
    np.testing.assert_allclose(w.std(), want.std(), rtol=0.02)
    np.testing.assert_allclose(w.std(), fan_in ** -0.5, rtol=0.02)
    assert np.abs(w).max() <= 2 / (fan_in ** 0.5 * TRUNC_STD) * (1 + 1e-6)
