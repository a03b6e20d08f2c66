"""Port model (tpu_asr_torch.models) vs tpu_asr.models.Transformer on the
CPU, from the same flax params."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.models.decoder import Decoder as JaxDecoder
from tpu_asr_torch.weights import flax_to_torch, load_jax_params
from torch_port_util import (VOCAB, flat_flax_params, flax_params, jax_cfg,
                             torch_cfg, torch_model)

ATOL = 1e-4   # float32 on both sides; sums taken in another order


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 41, 80)).astype(np.float32)
    flens = np.array([41, 30, 0], np.int32)     # incl. a length-0 dummy row
    ys = rng.integers(0, VOCAB, (3, 5)).astype(np.int32)
    jm, params = JaxTransformer(jax_cfg()), flax_params()
    enc, el = jm.apply(params, jnp.asarray(feats), jnp.asarray(flens),
                       method="encode")
    tm = torch_model()
    with torch.no_grad():
        tenc, tel = tm.encode(torch.from_numpy(feats), torch.from_numpy(flens))
    return dict(feats=feats, flens=flens, ys=ys, jm=jm, params=params,
                enc=enc, el=el, tm=tm, tenc=tenc, tel=tel)


def test_encoder_matches(setup):
    np.testing.assert_array_equal(np.asarray(setup["el"]),
                                  setup["tel"].numpy())
    assert setup["tenc"].shape == (3, 9, 64)
    np.testing.assert_allclose(setup["tenc"].numpy(),
                               np.asarray(setup["enc"]), atol=ATOL)


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
    assert got.shape == (3, 5, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cached_steps_match(setup):
    """Cached decode steps (`step_at`: the position a device tensor, all
    cache rows attended with those after pos masked; the beam's static
    step) at every position of the cache equal the reference's step API
    and the teacher-forced logits."""
    jd = JaxDecoder(jax_cfg())
    dp = {"params": setup["params"]["params"]["decoder"]}
    enc = setup["enc"]
    u_max = setup["ys"].shape[1]
    jcache = jd.apply(dp, 3, u_max, method="init_cache")
    jkv = jd.apply(dp, enc, method="precompute_cross_kv")
    td = setup["tm"].decoder
    tcache = td.init_cache(3, u_max)
    tkv = td.init_cache(3, setup["tenc"].shape[1])
    with torch.no_grad():
        td.write_cross_kv(setup["tenc"], tkv)
        for pos in range(u_max):
            y = setup["ys"][:, pos]
            jl, jcache = jd.apply(dp, jnp.asarray(y), pos, jcache, jkv,
                                  setup["el"], method="step")
            tl, tcache = td.step_at(torch.from_numpy(y).long(),
                                    torch.tensor([pos]), tcache, tkv,
                                    setup["tel"])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                       err_msg=f"step {pos}")
            # step logits == teacher-forced logits at the same position
            np.testing.assert_allclose(
                tl.numpy(), setup["tm"].decode_logits(
                    setup["tenc"], setup["tel"],
                    torch.from_numpy(setup["ys"][:, :pos + 1]).long()
                )[:, pos].numpy(), atol=ATOL)


def test_bf16_encoder_close():
    """bf16 compute on both sides: rounding happens at other places in
    the two frameworks, so the bound is loose (bf16 keeps ~3 digits)."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((2, 41, 80)).astype(np.float32)
    flens = np.array([41, 33], np.int32)
    jm = JaxTransformer(jax_cfg(dtype=jnp.bfloat16))
    want, _ = jm.apply(flax_params(), jnp.asarray(feats), jnp.asarray(flens),
                       method="encode")
    tm = torch_model(dtype=torch.bfloat16)
    with torch.no_grad():
        got, _ = tm.encode(torch.from_numpy(feats), torch.from_numpy(flens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=0.1)


def test_load_rejects_missing_and_misshaped_keys():
    from tpu_asr_torch.models.transformer import Transformer
    flat = {k[len("params/"):]: v for k, v in flat_flax_params().items()}
    model = Transformer(torch_cfg())
    load_jax_params(model, flat)                       # flat form works
    missing = dict(flat)
    missing.pop("encoder/layer_0/ffn/w_1/bias")
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    extra = dict(flat, **{"encoder/bogus/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        load_jax_params(model, extra)
    bad = dict(flat)
    bad["decoder/embed/embedding"] = np.zeros((VOCAB + 1, 64), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(model, bad)


def test_load_from_npz(tmp_path):
    from tpu_asr_torch.models.transformer import Transformer
    flat = flat_flax_params()
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    model = Transformer(torch_cfg())
    load_jax_params(model, str(path))
    ref = torch_model()
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              ref.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("path,shape,key,tshape", [
    ("encoder/layer_0/slf_attn/q_proj/kernel", (64, 2, 32),
     "encoder.layers.0.slf_attn.q_proj.weight", (64, 64)),
    ("decoder/layer_1/crs_attn/out_proj/kernel", (2, 32, 64),
     "decoder.layers.1.crs_attn.out_proj.weight", (64, 64)),
    ("encoder/subsample/conv2/kernel", (3, 3, 8, 16),
     "encoder.subsample.conv2.weight", (16, 8, 3, 3)),
    ("decoder/layer_0/post_crs/LayerNorm_0/scale", (64,),
     "decoder.layers.0.post_crs.norm.weight", (64,)),
    ("ctc_head/ctc_proj/kernel", (64, 32), "ctc_head.ctc_proj.weight",
     (32, 64)),
])
def test_flax_key_mapping(path, shape, key, tshape):
    k, v = flax_to_torch(path, np.zeros(shape, np.float32))
    assert (k, v.shape) == (key, tshape)


@pytest.mark.parametrize("shape", [(512, 2048), (3, 3, 32, 128)])
def test_init_random_draws_flax_lecun_normal(shape):
    """Dense [in, out] and Conv HWIO kernels: the port's draws have flax's
    std within 2% and, like flax's truncated normal, none beyond 2 sigma
    (sigma = sqrt(1/fan_in) / 0.8796, the untruncated scale)."""
    import jax
    from flax import linen as fnn
    from torch import nn as tnn
    from tpu_asr_torch.weights import TRUNC_STD, init_random
    want = np.asarray(fnn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), shape))
    if len(shape) == 2:
        m = tnn.Linear(*shape)
    else:
        m = tnn.Conv2d(shape[2], shape[3], shape[:2])
    w = init_random(tnn.Sequential(m), 0)[0].weight.detach().numpy()
    fan_in = int(np.prod(shape[:-1]))
    sigma = 1.0 / (fan_in ** 0.5 * TRUNC_STD)
    np.testing.assert_allclose(w.std(), want.std(), rtol=0.02)
    np.testing.assert_allclose(w.std(), fan_in ** -0.5, rtol=0.02)
    assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6)
    assert np.abs(want).max() <= 2 * sigma * (1 + 1e-6)


def test_dropout_only_in_train_mode():
    """Dropout sits where the reference puts it: eval mode (the decoders'
    mode) is deterministic and equals the reference's deterministic pass;
    train mode with dropout > 0 drops."""
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((2, 41, 80)).astype(
        np.float32))
    flens = torch.tensor([41, 30], dtype=torch.int32)
    model = torch_model(dropout=0.3)
    n_drop = sum(isinstance(m, torch.nn.Dropout) for m in model.modules())
    assert n_drop == 1 + 2 * 3 + 1 + 2 * 4    # encoder PE, 2 enc layers,
    #                                           decoder emb, 2 dec layers
    with torch.no_grad():
        a, _ = model.encode(feats, flens)
        b, _ = model.encode(feats, flens)
        jm = JaxTransformer(jax_cfg(dropout=0.3))
        want, _ = jm.apply(flax_params(), jnp.asarray(feats.numpy()),
                           jnp.asarray(flens.numpy()), method="encode")
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL)
        model.train()
        c, _ = model.encode(feats, flens)
    assert not torch.allclose(a, c, atol=1e-3)


# ---- the use_pallas configuration (flash attention, fused residual+LN) ----

@pytest.mark.parametrize("flags", [
    {}, {"use_pallas": True}, {"use_pallas": True, "pallas_ctc": False},
    {"pallas_attention": True}, {"use_pallas": True,
                                 "pallas_layernorm": False}])
def test_pallas_flags_resolve_like_reference(flags):
    j, t = jax_cfg(**flags), torch_cfg(**flags)
    for name in ("attention_pallas", "ctc_pallas", "cif_pallas",
                 "layernorm_pallas"):
        assert getattr(t, name) == getattr(j, name), name


def _pallas_pair(dtype=None, **batch):
    """The JAX model and the port with use_pallas, from the same params
    (the reference keeps one param tree under the flag, so load_jax_params
    needs no key added or missing)."""
    kw = {"use_pallas": True}
    jkw = dict(kw, **({} if dtype is None else {"dtype": jnp.bfloat16}))
    tkw = dict(kw, **({} if dtype is None else {"dtype": torch.bfloat16}))
    return JaxTransformer(jax_cfg(**jkw)), torch_model(**tkw)


def _pallas_batch(b, t, u, flens, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 80)).astype(np.float32)
    ys = rng.integers(0, VOCAB - 2, (b, u)).astype(np.int32)
    return feats, np.asarray(flens, np.int32), ys


@pytest.mark.parametrize("dtype,atol", [(None, ATOL), ("bf16", 0.05)])
def test_use_pallas_encode_and_decoder_match(dtype, atol):
    """encode and the teacher-forced decoder logits within 1e-4 in
    float32; in bf16 within 0.05, a few bf16 ulps at their scale (~1-4):
    the fused forms round at the reference's places, but sums run in
    other orders."""
    feats, flens, ys = _pallas_batch(3, 41, 5, [41, 30, 0], 1)
    jm, tm = _pallas_pair(dtype)
    assert tm.cfg.attention_pallas and tm.cfg.layernorm_pallas
    params = flax_params()
    enc, el = jm.apply(params, jnp.asarray(feats), jnp.asarray(flens),
                       method="encode")
    want = jm.apply(params, enc, el, jnp.asarray(ys), method="decode_logits")
    with torch.no_grad():
        tenc, tel = tm.encode(torch.from_numpy(feats),
                              torch.from_numpy(flens))
        got = tm.decode_logits(tenc, tel, torch.from_numpy(ys).long())
    np.testing.assert_allclose(tenc.float().numpy(),
                               np.asarray(enc.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)


def test_use_pallas_forward_loss_matches():
    """The training objective of the use_pallas model on the CPU (plain
    versions under autograd) equals the reference's within rtol 1e-5."""
    feats, flens, _ = _pallas_batch(3, 61, 5, [61, 50, 0], 2)
    rng = np.random.default_rng(2)
    targets = np.full((3, 5), -1, np.int32)
    tlens = np.array([5, 3, 0], np.int32)
    for i, n in enumerate(tlens):
        targets[i, :n] = rng.integers(2, VOCAB - 2, n)
    jm, tm = _pallas_pair()
    args = (feats, flens, targets, tlens)
    want = jm.apply(flax_params(), *(jnp.asarray(a) for a in args))
    got = tm(*(torch.from_numpy(a) for a in args))
    for k in ("loss", "loss_att", "loss_ctc"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    got["loss"].backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters()
               if p.grad is not None)


def test_use_pallas_batch_straddles_the_512_row_switch(monkeypatch):
    """bf16, 4 x 131 = 524 encoder rows (fused LN) and 4 x 5 = 20 decoder
    rows (plain LN): both equal the reference, which switches at the same
    row count; the fused form runs exactly at the encoder's blocks."""
    from tpu_asr_torch.models import modules
    feats, flens, ys = _pallas_batch(4, 527, 5, [527, 400, 300, 0], 3)
    jm, tm = _pallas_pair("bf16")
    calls = []
    fused = modules.layer_norm_residual
    monkeypatch.setattr(modules, "layer_norm_residual",
                        lambda r, *a: calls.append(r.shape) or fused(r, *a))
    params = flax_params()
    enc, el = jm.apply(params, jnp.asarray(feats), jnp.asarray(flens),
                       method="encode")
    want = jm.apply(params, enc, el, jnp.asarray(ys), method="decode_logits")
    with torch.no_grad():
        tenc, tel = tm.encode(torch.from_numpy(feats),
                              torch.from_numpy(flens))
        got = tm.decode_logits(tenc, tel, torch.from_numpy(ys).long())
    assert tenc.shape[:2] == (4, 131)
    assert calls == [(4, 131, 64)] * (2 * tm.cfg.num_enc_layers)
    np.testing.assert_allclose(tenc.float().numpy(),
                               np.asarray(enc.astype(jnp.float32)), atol=0.05)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=0.05)
