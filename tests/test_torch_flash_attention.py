"""Port flash attention (ops/flash_attention.py) vs
tpu_asr.ops.pallas.flash_attention on the CPU: the plain version against
the Pallas kernel in interpret mode (out and lse), the plain backward
against the Pallas backward (dq, dk/dv) in interpret mode, the
dispatcher's gradients against jax.grad of the reference's custom VJP,
the dispatcher's reading of mask biases, and the fallback against
`_xla_attention`.

Tolerances are those of tests/unit/test_flash_attention.py for the
forward: float32 within atol 1e-5 / rtol 1e-4, bfloat16 within 2e-2 (p
is rounded to bf16 before the product with V, and the two sides sum in
other orders); lse within 1e-4. Gradients: float32 within atol 1e-5 /
rtol 1e-4; bfloat16 within one bf16 ulp at the gradient's scale
(bf16_ulp_error) for the backward alone, since both sides round ds and p
at the same points. Through the dispatcher the backward reads each
side's own bf16 forward output (delta = rowsum(dO * out)), which may
differ by an ulp, so there the bf16 gradients are held at two ulps.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_asr.ops.pallas.flash_attention as jax_fa
from tpu_asr.models.attention import mask_to_bias as jax_mask_to_bias
from tpu_asr.ops.pallas.flash_attention import _fwd_impl, _xla_attention
from tpu_asr.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from tpu_asr_torch.models.attention import mask_to_bias
from tpu_asr_torch.ops.cuda_build import CSRC_DIR
from tpu_asr_torch.ops.flash_attention import (HEAD_DIMS, KERNELS, NEG_INF,
                                               _strides, flash_attention,
                                               flash_attention_bwd_dkv,
                                               flash_attention_bwd_dq,
                                               flash_attention_bwd_reference,
                                               flash_attention_fwd,
                                               flash_attention_reference,
                                               kernel_operand, kernel_route,
                                               kernel_symbol, tma_ready,
                                               xla_attention)
from tpu_asr_torch.ops.layernorm import bf16_ulp_error

DTYPES = {"float32": (torch.float32, jnp.float32,
                      dict(atol=1e-5, rtol=1e-4)),
          "bfloat16": (torch.bfloat16, jnp.bfloat16,
                       dict(atol=2e-2, rtol=2e-2))}


def _qkv(b, tq, tk, h, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, dh)).astype(np.float32),
            rng.standard_normal((b, tk, h, dh)).astype(np.float32),
            rng.standard_normal((b, tk, h, dh)).astype(np.float32))


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,dh,causal,lens", [
    (3, 20, 20, 2, 32, False, [20, 11, 0]),      # key padding, a length-0 row
    (2, 24, 24, 2, 32, True, [24, 24]),          # causal
    (3, 18, 18, 2, 64, True, [18, 9, 0]),        # causal and key padding
    (3, 1, 9, 2, 32, False, [9, 4, 0]),          # Tq = 1 (a decode step)
    (2, 5, 600, 2, 32, False, [600, 517]),       # Tk > the 512-key tile
])
def test_plain_version_matches_pallas_kernel(b, tq, tk, h, dh, causal, lens,
                                             dtype):
    (tq_, tk_, tv_), (jq, jk, jv) = _both(_qkv(b, tq, tk, h, dh, tq + tk),
                                          dtype)
    valid = np.arange(tk)[None, :] < np.asarray(lens)[:, None]
    want_out, want_lse = _fwd_impl(jq, jk, jv, jnp.asarray(valid, jnp.float32),
                                   causal, True)
    out, lse = flash_attention_reference(tq_, tk_, tv_,
                                         torch.from_numpy(valid), causal)
    assert out.dtype == DTYPES[dtype][0] and lse.shape == (b, h, tq)
    np.testing.assert_allclose(_np(out), _np(want_out), **DTYPES[dtype][2])
    want_lse = np.asarray(want_lse)[:, :, :tq, 0]
    np.testing.assert_allclose(np.maximum(lse.numpy(), -1e31),
                               np.maximum(want_lse, -1e31), atol=1e-4,
                               rtol=1e-5)
    dead = np.asarray(lens) == 0
    if dead.any():         # every key masked: zeros and lse NEG_INF
        assert not out[dead].any()
        assert (lse[dead] == NEG_INF).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["padding", "padding_broadcast",
                                       "causal"])
def test_dispatcher_reads_mask_biases_like_reference(bias_kind, dtype):
    """The public function with the model's biases equals the reference's
    public function (which picks the same masks)."""
    b, t, h, dh = 3, 21, 2, 32
    (tq_, tk_, tv_), (jq, jk, jv) = _both(_qkv(b, t, t, h, dh, 7), dtype)
    if bias_kind == "causal":
        mask = np.tril(np.ones((t, t), bool))[None, None]
    elif bias_kind == "padding":
        mask = (np.arange(t)[None, :] < np.array([21, 8, 0])[:, None]
                )[:, None, None, :]
    else:
        mask = (np.arange(t) < 15)[None, None, None, :]
    tdt, jdt, tol = DTYPES[dtype]
    want = jax_flash_attention(jq, jk, jv, bias=jax_mask_to_bias(
        jnp.asarray(mask), jdt), interpret=True)
    got = flash_attention(tq_, tk_, tv_, mask_to_bias(torch.from_numpy(mask),
                                                      tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_other_bias_falls_back_to_xla_attention(dtype):
    """A bias of another shape ([B, 1, Tq, Tk]) takes xla_attention, which
    equals the reference's _xla_attention; so does xla_attention itself
    with key padding and a causal mask."""
    b, t, h, dh = 2, 13, 2, 32
    (tq_, tk_, tv_), (jq, jk, jv) = _both(_qkv(b, t, t, h, dh, 3), dtype)
    tdt, jdt, tol = DTYPES[dtype]
    bias = np.where(np.random.default_rng(0).random((b, 1, t, t)) < 0.3,
                    NEG_INF, 0.0).astype(np.float32)
    want = jax_flash_attention(jq, jk, jv, bias=jnp.asarray(bias, jdt),
                               interpret=True)
    got = flash_attention(tq_, tk_, tv_, torch.from_numpy(bias).to(tdt))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    valid = np.arange(t)[None, :] < np.array([13, 6])[:, None]
    want = _xla_attention(jq, jk, jv, jnp.asarray(valid, jnp.float32), True)
    got = xla_attention(tq_, tk_, tv_, torch.from_numpy(valid), True)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_float_kv_valid_and_defaults():
    """kv_valid may be float (> 0.5 valid); with neither mask nor bias
    every key is valid."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 6, 9, 2, 32, 5))
    valid = torch.arange(9)[None, :] < torch.tensor([[9], [4]])
    np.testing.assert_array_equal(
        flash_attention(q, k, v, kv_valid=valid.float()).numpy(),
        flash_attention(q, k, v, kv_valid=valid).numpy())
    np.testing.assert_array_equal(
        flash_attention(q, k, v).numpy(),
        flash_attention_reference(q, k, v, torch.ones(2, 9, dtype=torch.bool)
                                  )[0].numpy())


def test_cpu_runs_plain_version_under_autograd_without_launching():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(2, 5, 7, 2, 32, 9))
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert [f.launches for f in counters] == before
    assert all(torch.isfinite(g).all() for g in grads)
    valid = torch.ones(2, 7, dtype=torch.bool)
    with pytest.raises(ValueError):
        flash_attention_fwd(q.detach(), k.detach(), v.detach(), valid)
    d, lse = q.detach(), torch.zeros(2, 2, 5)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq(d, k.detach(), v.detach(), d, lse, lse, valid)
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv(d, k.detach(), v.detach(), d, lse, lse,
                                valid)


# ---- the kernels' route and operand layout (no launch) ----

@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_route_sends_bf16_to_wgmma_and_float32_to_simt(dh):
    assert kernel_route(torch.bfloat16, dh) == "wgmma"
    assert kernel_route(torch.float32, dh) == "simt"


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("which,source", [
    ("fwd", "flash_attention.cu"), ("dq", "flash_attention_bwd.cu"),
    ("dkv", "flash_attention_bwd.cu")])
def test_kernel_symbol_follows_the_route(which, source, dh):
    """bf16 takes the wgmma kernel for the forward, dq and dk/dv alike,
    float32 the SIMT one; each name is a kernel that the CUDA source
    defines."""
    bf16 = kernel_symbol(which, torch.bfloat16, dh)
    f32 = kernel_symbol(which, torch.float32, dh)
    assert bf16 == f"{KERNELS[which]}_wgmma_kernel"
    assert f32 == f"{KERNELS[which]}_simt_kernel"
    with open(os.path.join(CSRC_DIR, source)) as f:
        text = f.read()
    for name in (bf16, f32):
        assert re.search(rf"^{name}\(", text, re.MULTILINE), name


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError),      # no kernel takes float16
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError),    # nor a head size outside HEAD_DIMS
    (torch.float32, 256, ValueError),
])
def test_call_no_kernel_takes_raises(dtype, dh, error):
    """kernel_route raises for what neither kernel takes, and so does a
    wrapper called with it, before it would launch: nothing falls back to
    the other kernel or to the plain version."""
    with pytest.raises(error):
        kernel_route(dtype, dh)
    q = torch.zeros(2, 5, 2, dh, dtype=dtype)
    valid = torch.ones(2, 5, dtype=torch.bool)
    lse = torch.zeros(2, 2, 5)
    with pytest.raises(error):
        flash_attention_fwd(q, q, q, valid)
    with pytest.raises(error):
        flash_attention_bwd_dkv(q, q, q, q, lse, lse, valid)


def _views(kind, dtype=torch.bfloat16):
    """[B, T, H, dh] = [2, 9, 4, 64] tensors laid out as `kind` says."""
    b, t, h, dh = 2, 9, 4, 64
    if kind == "contiguous":
        return torch.zeros(b, t, h, dh, dtype=dtype)
    if kind == "packed":                 # one of q, k, v of [B, T, 3, H, dh]
        return torch.zeros(b, t, 3, h, dh, dtype=dtype)[:, :, 1]
    if kind == "heads_first":            # [B, H, T, dh] transposed
        return torch.zeros(b, h, t, dh, dtype=dtype).transpose(1, 2)
    if kind == "head_pad_16":            # head stride dh + 8: 144 bytes
        return torch.zeros(b, t, h, dh + 8, dtype=dtype)[..., :dh]
    if kind == "head_pad_8":             # head stride dh + 4: 136 bytes
        return torch.zeros(b, t, h, dh + 4, dtype=dtype)[..., :dh]
    if kind == "odd_time":               # time stride h dh + 1
        flat = torch.zeros(b, t, h * dh + 1, dtype=dtype)
        return flat[..., :h * dh].unflatten(-1, (h, dh))
    if kind == "base_offset":            # base 2 bytes past an aligned one
        return torch.zeros(b * t * h * dh + 1, dtype=dtype)[1:].view(
            b, t, h, dh)
    if kind == "dh_strided":             # head axis not contiguous
        return torch.zeros(b, t, h, dh, 2, dtype=dtype)[..., 0]
    raise ValueError(kind)


@pytest.mark.parametrize("kind,ready", [
    ("contiguous", True), ("packed", True), ("heads_first", True),
    ("head_pad_16", True), ("head_pad_8", False), ("odd_time", False),
    ("base_offset", False), ("dh_strided", False),
])
def test_tma_rule_decides_the_copy(kind, ready):
    """The wgmma route copies an operand exactly when TMA's 16-byte rule
    (base and every stride) or a non-contiguous head axis forbids reading
    it where it lies; the copy is contiguous, aligned and equal. The SIMT
    route copies only for a non-contiguous head axis."""
    x = _views(kind)
    x.copy_(torch.randn(x.shape).to(x.dtype))
    assert tma_ready(x) == ready
    for route, copies in (("wgmma", not ready),
                          ("simt", kind == "dh_strided")):
        y = kernel_operand(x, route)
        assert (y.data_ptr() != x.data_ptr()) == copies, route
        assert torch.equal(y, x)
        if route == "wgmma":
            assert tma_ready(y)


def test_strides_of_length_one_axes_are_packed():
    """An axis of length 1 addresses nothing, so its stride, whatever torch
    made it, is replaced by the packed one for the tensor map: it never
    forces a copy."""
    y = torch.zeros(7, 2, 64, dtype=torch.bfloat16).as_strided(
        (1, 7, 1, 64), (3, 128, 5, 1))
    assert tma_ready(y)
    assert _strides(y) == [7 * 64, 128, 64]
    assert _strides(torch.zeros(2, 5, 3, 32)) == [5 * 3 * 32, 3 * 32, 32]


# ---- the backward (the reference's custom VJP) ----

def _assert_grads_close(got, want, dtype, what="", bf16_ulps=1.0):
    """float32 within atol 1e-5 / rtol 1e-4; bf16 within `bf16_ulps` bf16
    ulps at the gradient's scale."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.array(jnp.asarray(w, jnp.float32))
        assert g.dtype == DTYPES[dtype][0], name
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name} {what}")
        else:
            err = bf16_ulp_error(g, torch.from_numpy(w).bfloat16())
            assert err <= bf16_ulps, f"{name} {what}: {err} bf16 ulps"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,causal,lens,tile", [
    (3, 37, 45, False, [45, 20, 0], None),   # Tq != Tk, a length-0 row
    (3, 37, 37, True, [37, 20, 0], None),    # causal and key padding
    (2, 40, 40, True, [40, 23], 16),         # 3 x 3 tiles of 16, padded
    (3, 9, 40, False, [40, 17, 0], 16),      # Tq < one tile, 3 key tiles
])
def test_plain_backward_matches_pallas_backward(b, tq, tk, causal, lens,
                                                tile, dtype, monkeypatch):
    """flash_attention_bwd_reference against the reference's
    _flash_backward (dq and dk/dv kernels) in interpret mode, with its
    inputs prepared by _flash_bwd, from the reference forward's out and
    lse; multi-tile grids by shrinking the reference's tiles, as
    tests/unit/test_flash_attention.py does."""
    if tile:
        for attr in ("DEFAULT_TQ", "DEFAULT_TK", "DEFAULT_BWD_TQ",
                     "DEFAULT_BWD_TK"):
            monkeypatch.setattr(jax_fa, attr, tile)
    h, dh = 2, 32
    q, k, v = _qkv(b, tq, tk, h, dh, tq + tk)
    dout = np.random.default_rng(tk).standard_normal(q.shape).astype(
        np.float32)
    (tq_, tk_, tv_, tdo), (jq, jk, jv, jdo) = _both((q, k, v, dout), dtype)
    valid = np.arange(tk)[None, :] < np.asarray(lens)[:, None]
    out, res = jax_fa._flash_fwd(jq, jk, jv, jnp.asarray(valid, jnp.float32),
                                 causal, True)
    want = jax_fa._flash_bwd(causal, True, res, jdo)[:3]
    lse = torch.from_numpy(np.array(res[5])[:, :, :tq, 0])
    tout = torch.from_numpy(_np(out).copy()).to(DTYPES[dtype][0])
    got = flash_attention_bwd_reference(tq_, tk_, tv_, tout, tdo, lse,
                                        torch.from_numpy(valid), causal)
    _assert_grads_close(got, want, dtype)
    dead = np.asarray(lens) == 0
    for g in got:                # a length-0 row's gradients are exactly 0
        assert not g[dead].any()
    for g in got[1:]:            # and so are a masked key's
        assert not g[torch.from_numpy(~valid)].any()


@pytest.mark.parametrize("dtype,causal,lens", [
    ("float32", True, [24, 24, 9]),
    ("float32", False, [31, 12, 0]),
    ("bfloat16", False, [31, 12, 0]),
])
def test_dispatcher_grads_match_jax_grad(dtype, causal, lens):
    """torch.autograd.grad through the dispatcher (FlashAttentionFunction
    on the CPU) against jax.grad of the reference's public function in
    interpret mode, for the loss sum(out * g). bf16 within two ulps: each
    side's backward reads its own forward's bf16 out (see the module
    docstring)."""
    b, h, dh = 3, 2, 32
    t = max(lens)
    q, k, v = _qkv(b, 17, t, h, dh, 21) if not causal else \
        _qkv(b, t, t, h, dh, 21)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    (tq_, tk_, tv_, tg), (jq, jk, jv, jg) = _both((q, k, v, g), dtype)
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    jvalid = jnp.asarray(valid, jnp.float32)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, kv_valid=jvalid, causal=causal,
                                  interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    xs = [x.requires_grad_(True) for x in (tq_, tk_, tv_)]
    out = flash_attention(*xs, kv_valid=torch.from_numpy(valid),
                          causal=causal)
    got = torch.autograd.grad((out.float() * tg.float()).sum(), xs)
    _assert_grads_close(got, want, dtype, bf16_ulps=2.0)
