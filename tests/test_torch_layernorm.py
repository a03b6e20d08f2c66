"""Port fused residual+LayerNorm (ops/layernorm.py, PostNormBlock) vs
tpu_asr.ops.pallas.layernorm and tpu_asr.models.modules.PostNormBlock on
the CPU: the plain version against the Pallas forward in interpret mode
(out, mean, rstd), the plain backward against the Pallas backward (dx and
the summed dgamma/dbeta partials), the dispatcher's gradients against
jax.grad of the reference's custom VJP, and the 512-row switch of the
post-norm block, whose gradients reach norm.weight and norm.bias.

float32 within 1e-5 (dx: atol 1e-5 / rtol 1e-4); bfloat16 within one bf16
ulp of the reference at the tensor's scale (bf16_ulp_error: the float32
statistics differ in their last bits and may flip a rounding). dgamma and
dbeta are sums over the rows: within rtol 1e-5 of their largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models.modules import PostNormBlock as JaxPostNormBlock
from tpu_asr.ops.pallas.layernorm import _bwd, _fwd
from tpu_asr.ops.pallas.layernorm import \
    layer_norm_residual as jax_layer_norm_residual
from tpu_asr_torch.models import modules
from tpu_asr_torch.models.modules import LN_EPS, PostNormBlock
from tpu_asr_torch.ops.layernorm import (ALIGN, _aligned, _workspace,
                                         bf16_ulp_error, layer_norm_residual,
                                         layer_norm_residual_bwd,
                                         layer_norm_residual_bwd_reference,
                                         layer_norm_residual_fwd,
                                         layer_norm_residual_reference)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            (1 + 0.5 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


def _assert_out_close(got, want, dtype):
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert got.dtype == torch.bfloat16
        assert bf16_ulp_error(got, want.to(torch.bfloat16)) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 511, 512, 1000])
@pytest.mark.parametrize("d", [64, 512])
def test_plain_version_matches_pallas_forward(rows, d, dtype):
    tdt, jdt = DTYPES[dtype]
    r, h, g, b = _inputs((rows, d), rows + d)
    want, want_mean, want_rstd = _fwd(
        jnp.asarray(r, jdt), jnp.asarray(h, jdt), jnp.asarray(g),
        jnp.asarray(b), LN_EPS, True)
    out, mean, rstd = layer_norm_residual_reference(
        torch.from_numpy(r).to(tdt), torch.from_numpy(h).to(tdt),
        torch.from_numpy(g), torch.from_numpy(b))
    _assert_out_close(out, want, dtype)
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (rows,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean)[:rows, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd)[:rows, 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_matches_reference_public_function(dtype):
    """[..., D] inputs; the CPU runs the plain version, no launch."""
    tdt, jdt = DTYPES[dtype]
    r, h, g, b = _inputs((3, 7, 64), 11)
    want = jax_layer_norm_residual(jnp.asarray(r, jdt), jnp.asarray(h, jdt),
                                   jnp.asarray(g), jnp.asarray(b),
                                   interpret=True)
    before = layer_norm_residual_fwd.launches
    got = layer_norm_residual(torch.from_numpy(r).to(tdt),
                              torch.from_numpy(h).to(tdt),
                              torch.from_numpy(g), torch.from_numpy(b))
    assert layer_norm_residual_fwd.launches == before
    assert got.shape == (3, 7, 64)
    _assert_out_close(got, want, dtype)
    with pytest.raises(ValueError):
        layer_norm_residual_fwd(*(torch.from_numpy(x) for x in (r, h, g, b)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("rows", [511, 512])
def test_post_norm_block_switch_matches_reference(rows, use_pallas,
                                                  monkeypatch):
    """bf16 PostNormBlock on both sides of the 512-row switch: the fused
    form (float32 add) exactly when use_pallas and rows >= 512, as the
    reference's block; its parameters are norm.weight/bias either way."""
    r, h, g, b = _inputs((rows, 64), rows)
    jm = JaxPostNormBlock(64, dropout=0.0, dtype=jnp.bfloat16,
                          use_pallas=use_pallas)
    params = {"params": {"LayerNorm_0": {"scale": jnp.asarray(g),
                                         "bias": jnp.asarray(b)}}}
    want = jm.apply(params, jnp.asarray(r, jnp.bfloat16),
                    jnp.asarray(h, jnp.bfloat16))
    block = PostNormBlock(64, dropout=0.0, dtype=torch.bfloat16,
                          use_pallas=use_pallas)
    assert sorted(block.state_dict()) == ["norm.bias", "norm.weight"]
    with torch.no_grad():
        block.norm.weight.copy_(torch.from_numpy(g))
        block.norm.bias.copy_(torch.from_numpy(b))
    calls = []
    monkeypatch.setattr(modules, "layer_norm_residual",
                        lambda *a: calls.append(1) or
                        layer_norm_residual(*a))
    with torch.no_grad():
        got = block(torch.from_numpy(r).bfloat16(),
                    torch.from_numpy(h).bfloat16())
    assert len(calls) == (1 if use_pallas and rows >= 512 else 0)
    _assert_out_close(got, want, "bfloat16")


def test_fused_and_plain_forms_differ_in_bf16():
    """The formulation matters: adding in float32 (fused) and in bf16
    (LayerNorm(residual + h)) give different bf16 outputs, so a block that
    took the wrong form for its flag would drift from the reference."""
    r, h, g, b = (torch.from_numpy(x) for x in _inputs((600, 64), 1))
    fused = PostNormBlock(64, 0.0, torch.bfloat16, use_pallas=True)
    plain = PostNormBlock(64, 0.0, torch.bfloat16, use_pallas=False)
    for m in (fused, plain):
        m.norm.weight.data.copy_(g)
        m.norm.bias.data.copy_(b)
    with torch.no_grad():
        a = fused(r.bfloat16(), h.bfloat16())
        c = plain(r.bfloat16(), h.bfloat16())
    assert not torch.equal(a, c)


# ---- the backward (the reference's custom VJP) ----

def _assert_grads_close(got, want, dtype):
    """(dx, dgamma, dbeta) against the reference's: dx float32 within atol
    1e-5 / rtol 1e-4, bf16 within one ulp at its scale; dgamma and dbeta
    (float32 sums over the rows) within rtol 1e-5 of their largest
    magnitude."""
    dx, dg, db = got
    want = [np.array(jnp.asarray(w, jnp.float32)) for w in want]
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), want[0], atol=1e-5, rtol=1e-4)
    else:
        assert dx.dtype == torch.bfloat16
        assert bf16_ulp_error(dx, torch.from_numpy(want[0]).bfloat16()) <= 1
    for got_, w in ((dg, want[1]), (db, want[2])):
        assert got_.dtype == torch.float32
        np.testing.assert_allclose(got_.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [100, 512, 700])
def test_plain_backward_matches_pallas_backward(rows, dtype):
    """layer_norm_residual_bwd_reference against the reference's _bwd (its
    _bwd_kernel in interpret mode, partials summed) from the reference
    forward's mean and rstd: rows below, at and across the 512-row tile
    (one and two reference programs)."""
    tdt, jdt = DTYPES[dtype]
    d = 64
    r, h, g, b = _inputs((rows, d), rows)
    dy = np.random.default_rng(rows + 1).standard_normal((rows, d)).astype(
        np.float32)
    jr, jh, jdy = (jnp.asarray(x, jdt) for x in (r, h, dy))
    _, mean, rstd = _fwd(jr, jh, jnp.asarray(g), jnp.asarray(b), LN_EPS, True)
    want = _bwd(jr, jh, jnp.asarray(g), mean, rstd, jdy, True)
    got = layer_norm_residual_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in (r, h)), torch.from_numpy(g),
        torch.from_numpy(np.array(mean)[:rows, 0]),
        torch.from_numpy(np.array(rstd)[:rows, 0]),
        torch.from_numpy(dy).to(tdt))
    _assert_grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 64), (4, 150, 64)])
def test_dispatcher_grads_match_jax_grad(shape, dtype):
    """torch.autograd.grad through the dispatcher (the Function on the
    CPU) against jax.grad of the reference's public function in interpret
    mode, for the loss sum(out * w): 21 and 600 rows; residual and h get
    the same dx."""
    tdt, jdt = DTYPES[dtype]
    r, h, g, b = _inputs(shape, shape[1])
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)

    def loss(r, h, g, b):
        out = jax_layer_norm_residual(r, h, g, b, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(r, jdt), jnp.asarray(h, jdt), jnp.asarray(g),
        jnp.asarray(b))
    xs = [torch.from_numpy(r).to(tdt).requires_grad_(True),
          torch.from_numpy(h).to(tdt).requires_grad_(True),
          torch.from_numpy(g).requires_grad_(True),
          torch.from_numpy(b).requires_grad_(True)]
    before = (layer_norm_residual_fwd.launches,
              layer_norm_residual_bwd.launches)
    out = layer_norm_residual(*xs)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), xs)
    assert (layer_norm_residual_fwd.launches,
            layer_norm_residual_bwd.launches) == before
    assert torch.equal(got[0], got[1])
    d = shape[-1]
    _assert_grads_close((got[0].reshape(-1, d), got[2], got[3]),
                        (want[0].reshape(-1, d), want[2], want[3]), dtype)
    with pytest.raises(ValueError):
        layer_norm_residual_bwd(*(x.detach() for x in xs[:3]),
                                torch.zeros(shape[:-1]),
                                torch.ones(shape[:-1]), xs[0].detach())


def test_post_norm_block_grads_reach_norm_params_through_fused_form():
    """With use_pallas at >= 512 rows the block's gradients (residual,
    sublayer output, norm.weight, norm.bias) come from the fused form's
    backward and equal jax.grad of the reference's block."""
    rows, d = 600, 64
    r, h, g, b = _inputs((rows, d), 9)
    w = np.random.default_rng(9).standard_normal((rows, d)).astype(
        np.float32)
    jm = JaxPostNormBlock(d, dropout=0.0, dtype=jnp.float32, use_pallas=True)

    def loss(params, r, h):
        return jnp.sum(jm.apply(params, r, h) * jnp.asarray(w))
    params = {"params": {"LayerNorm_0": {"scale": jnp.asarray(g),
                                         "bias": jnp.asarray(b)}}}
    gp, gr, gh = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(r),
                                                    jnp.asarray(h))
    block = PostNormBlock(d, dropout=0.0, use_pallas=True)
    with torch.no_grad():
        block.norm.weight.copy_(torch.from_numpy(g))
        block.norm.bias.copy_(torch.from_numpy(b))
    tr, th = (torch.from_numpy(x).requires_grad_(True) for x in (r, h))
    out = block(tr, th)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tr, th, block.norm.weight, block.norm.bias))
    ln = gp["params"]["LayerNorm_0"]
    _assert_grads_close((got[0], got[2], got[3]),
                        (gr, ln["scale"], ln["bias"]), "float32")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(gh), atol=1e-5,
                               rtol=1e-4)


# ---- the backward kernel's wrapper: what it does before a launch ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_input_is_copied_to_an_aligned_one(dtype):
    """The backward kernel reads 16 bytes a lane: a tensor whose base is
    off a 16-byte boundary is copied (same values), an aligned one is
    passed as it is."""
    flat = torch.arange(1 + 4 * 64, dtype=dtype)
    base = flat[:-1].view(4, 64)
    off = flat[1:].view(4, 64)
    assert base.data_ptr() % ALIGN == 0 and off.data_ptr() % ALIGN != 0
    assert _aligned(base) is base
    copied = _aligned(off)
    assert copied.data_ptr() % ALIGN == 0 and torch.equal(copied, off)


def test_workspace_is_kept_per_device_and_stream_and_grows():
    """The kernel's scratch is allocated once per (device, stream) and
    reused for calls that fit; a larger call replaces it."""
    dev = torch.device("cpu")
    first = _workspace(dev, 12345, 1000)
    assert first.dtype == torch.float32 and first.numel() == 1000
    assert _workspace(dev, 12345, 600) is first
    assert _workspace(dev, 54321, 600) is not first
    grown = _workspace(dev, 12345, 2000)
    assert grown.numel() == 2000 and _workspace(dev, 12345, 1500) is grown
