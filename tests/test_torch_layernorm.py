"""Port fused residual+LayerNorm (ops/layernorm.py, PostNormBlock) vs
tpu_asr.ops.pallas.layernorm and tpu_asr.models.modules.PostNormBlock on
the CPU: the plain version against the Pallas forward in interpret mode
(out, mean, rstd), and the 512-row switch of the post-norm block.

float32 within 1e-5; bfloat16 within one bf16 ulp of the reference output
at the output's scale (bf16_ulp_error: the float32 statistics differ in
their last bits and may flip a rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models.modules import PostNormBlock as JaxPostNormBlock
from tpu_asr.ops.pallas.layernorm import _fwd
from tpu_asr.ops.pallas.layernorm import \
    layer_norm_residual as jax_layer_norm_residual
from tpu_asr_torch.models import modules
from tpu_asr_torch.models.modules import LN_EPS, PostNormBlock
from tpu_asr_torch.ops.layernorm import (bf16_ulp_error, layer_norm_residual,
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
