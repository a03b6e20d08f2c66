"""Flash attention, forward and backward, through hand-written CUDA
kernels (port of tpu_asr/ops/pallas/flash_attention.py).

q [B, Tq, H, dh], k/v [B, Tk, H, dh] -> out [B, Tq, H, dh], the layout of
the reference's public function. The flash formulation differs from
models.attention.attend, and the model picks it with `attention_pallas`:
the scores are a float32 dot scaled afterwards (attend scales in the
compute dtype), p is rounded to the input dtype before the product with
V, and a row whose keys are all masked gives 0 (attend gives the uniform
average). The backward is the reference's custom VJP (`_flash_bwd` with
`_rebuild_p_ds`): p rebuilt as exp(s - lse), ds = p (dO V^T - delta)
scale with delta = rowsum(dO * out), and ds and p rounded to the input
dtype before the products that give dq, dk and dv.

`flash_attention` reads the reference's two mask biases (key padding,
causal) and falls back to `xla_attention`, the reference's
`_xla_attention`, for any other bias. Without a gradient it runs the
forward alone: on CUDA tensors the kernel of csrc/flash_attention.cu
(counted in `flash_attention_fwd.launches`), on CPU tensors the plain
version. When a gradient is wanted it goes through
`FlashAttentionFunction`: on the card the forward kernel, then the dq and
dk/dv kernels of csrc/flash_attention_bwd.cu (`flash_attention_bwd_dq`,
`flash_attention_bwd_dkv`); on the CPU the plain forward and the plain
backward (`flash_attention_bwd_reference`). Other devices raise.

On the card the dtype picks the kernel (`kernel_route`, and
`kernel_symbol` names it): bfloat16 takes the forward, dq and dk/dv
kernels built on wgmma (tensor cores, TMA-fed tiles), float32 the SIMT
ones (wgmma has no full-float32 product, and TF32 would break the float32
tolerance). Nothing falls back: a call the routed kernel does not take
raises.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

LIBRARY = KernelLibrary("flash_attention")
BWD_LIBRARY = KernelLibrary("flash_attention_bwd")
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GRID = 65535       # grid y (heads) and z (batch) extents
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma"}
TMA_ALIGN = 16         # bytes: TMA's rule for a tensor's base and strides


def _mask(kv_valid: torch.Tensor, causal: bool, tq: int) -> torch.Tensor:
    """[B, 1, Tq|1, Tk] boolean: True where query i may attend key j."""
    mask = kv_valid[:, None, None, :]
    if causal:
        tk = kv_valid.shape[1]
        rows = torch.arange(tq, device=kv_valid.device)[:, None]
        cols = torch.arange(tk, device=kv_valid.device)[None, :]
        mask = mask & (rows >= cols)
    return mask


def flash_attention_reference(q, k, v, kv_valid: torch.Tensor,
                              causal: bool = False):
    """Plain version of the kernel: (out [B, Tq, H, dh] in q's dtype,
    lse [B, H, Tq] float32). kv_valid [B, Tk] boolean."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / dh ** 0.5)
    s = torch.where(_mask(kv_valid, causal, q.shape[1]), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                       # [B, H, Tq, 1]
    p = torch.where(s <= NEG_INF / 2, 0.0,
                    torch.exp(s - m.clamp(min=NEG_INF / 2)))
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(l))
    return out, lse[..., 0]


def flash_attention_delta(out: torch.Tensor,
                          dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in float32, [B, H, Tq] (the reference's
    `_flash_bwd` computes it in XLA outside its kernels)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)


def flash_attention_bwd_reference(q, k, v, out, dout, lse: torch.Tensor,
                                  kv_valid: torch.Tensor,
                                  causal: bool = False):
    """Plain backward: (dq, dk, dv), each in its input's dtype, from the
    forward's out (in q's dtype) and lse [B, H, Tq] float32."""
    dh = q.shape[-1]
    scale = 1.0 / dh ** 0.5
    delta = flash_attention_delta(out, dout)[..., None]      # [B, H, Tq, 1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(_mask(kv_valid, causal, q.shape[1]), s, NEG_INF)
    p = torch.exp(s - lse.clamp(min=NEG_INF / 2)[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def xla_attention(q, k, v, kv_valid: torch.Tensor, causal: bool = False):
    """The reference's fallback (`_xla_attention`): float32 scores divided
    by sqrt(dh), a where-mask, float32 softmax into the product with V."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / dh ** 0.5
    s = torch.where(_mask(kv_valid, causal, q.shape[1]), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def kernel_route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call in `dtype` with head size `dh` launches, the
    same for the forward, dq and dk/dv: "wgmma" for bfloat16 (the tensor
    cores), "simt" for float32 (wgmma has no full-float32 product, and
    TF32 would break the float32 tolerance). Raises for any other dtype or
    head size: no kernel takes it, and nothing falls back."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel needs dh in {HEAD_DIMS}, "
                         f"got {dh}")
    if dtype not in ROUTES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return ROUTES[dtype]


KERNELS = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
           "dkv": "flash_attention_bwd_dkv"}


def kernel_symbol(which: str, dtype: torch.dtype, dh: int) -> str:
    """The name of the CUDA kernel (csrc/flash_attention.cu or
    csrc/flash_attention_bwd.cu) that the wrapper of `which` ("fwd", "dq"
    or "dkv") launches for `dtype` and `dh`, e.g.
    "flash_attention_bwd_dq_wgmma_kernel"."""
    return f"{KERNELS[which]}_{kernel_route(dtype, dh)}_kernel"


def tma_ready(x: torch.Tensor) -> bool:
    """Whether TMA can read x [B, T, H, dh] where it lies: the head axis
    contiguous, the base 16-byte aligned, and the batch, time and head
    strides of every axis longer than 1 positive multiples of 16 bytes.
    The model's q/k/v projections ([B, T, H, dh] views of [B, T, H dh])
    and views of one [B, T, 3, H, dh] tensor are."""
    e = x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % TMA_ALIGN == 0
            and all(s > 0 and s * e % TMA_ALIGN == 0
                    for n, s in zip(x.shape[:3], x.stride()[:3]) if n > 1))


def kernel_operand(x: torch.Tensor, route: str) -> torch.Tensor:
    """x as the routed kernel reads it: x itself where it can, else a
    contiguous copy (a layout step, not a fallback). The SIMT kernels need
    the head axis contiguous; the wgmma kernels read through TMA, so also
    `tma_ready`."""
    ok = tma_ready(x) if route == "wgmma" else x.stride(-1) == 1
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _strides(x: torch.Tensor) -> list[int]:
    """x's batch, time and head strides in elements, with the stride of
    an axis of length <= 1 (which addresses nothing) replaced by that of a
    packed layout: TMA checks every stride of a tensor map."""
    t, h, dh = (max(n, 1) for n in x.shape[1:])
    packed = [t * h * dh, h * dh, dh]
    return [s if n > 1 else p
            for n, s, p in zip(x.shape[:3], x.stride()[:3], packed)]


def _check_operands(names, xs, ts):
    """Shape, dtype and device checks shared by the wrappers: each x of
    xs must be [B, t, H, dh] (t from ts) in q's dtype on q's device.
    -> (route, b, h, dh)."""
    q = xs[0]
    b, _, h, dh = q.shape
    route = kernel_route(q.dtype, dh)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if b > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"flash attention kernel needs B and H <= "
                         f"{MAX_GRID}, got {b}, {h}")
    for name, x, t in zip(names, xs, ts):
        if tuple(x.shape) != (b, t, h, dh) or x.dtype != q.dtype or \
                x.device != q.device:
            raise ValueError(f"{name} must be a {q.dtype} tensor of shape "
                             f"{(b, t, h, dh)} on {q.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    return route, b, h, dh


def _bind(lib: ctypes.CDLL):
    if lib.flash_attention_fwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd_launch.argtypes = (
            [p] * 6 + [i] * 5 + [p, ctypes.c_float, i, i, p])
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, kv_valid: torch.Tensor,
                        causal: bool = False):
    """The kernel on CUDA tensors: (out, lse) as the plain version gives
    them. q/k/v one of float32 (the SIMT kernel) or bfloat16 (the wgmma
    kernel), with dh in HEAD_DIMS; any batch, time and head strides, but
    an operand that the routed kernel cannot read where it lies (the head
    axis not contiguous; for bf16 also TMA's 16-byte rule, `tma_ready`) is
    copied contiguous first. kv_valid [B, Tk] boolean. Launches on the
    current stream."""
    tq, tk = q.shape[1], k.shape[1]
    route, b, h, dh = _check_operands(("q", "k", "v"), (q, k, v),
                                      (tq, tk, tk))
    dev, dt = q.device, q.dtype
    q, k, v = (kernel_operand(x, route) for x in (q, k, v))
    valid = kv_valid.to(torch.bool).contiguous().view(torch.uint8)
    check_tensor("kv_valid", valid, (b, tk), torch.uint8, dev)
    out = torch.empty((b, tq, h, dh), dtype=dt, device=dev)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 9)(*_strides(q), *_strides(k),
                                   *_strides(v))
    lib = _bind(LIBRARY.load())
    with torch.cuda.device(dev):
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, tq, tk, h, dh, strides,
            1.0 / dh ** 0.5, int(causal), DTYPES[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention {route} launch failed: {msg} "
                           f"({err})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0   # kernel launches (not CPU calls)


def _bwd_bind(lib: ctypes.CDLL):
    if lib.flash_attention_bwd_dq_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_out in ((lib.flash_attention_bwd_dq_launch, 1),
                          (lib.flash_attention_bwd_dkv_launch, 2)):
            fn.argtypes = ([p] * (7 + n_out) + [i] * 5
                           + [p, ctypes.c_float, i, i, p])
            fn.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_launch(name, q, k, v, dout, lse, delta, kv_valid, causal, outs):
    """Checks shared by the two backward wrappers, then the launch of
    `name` on the current stream writing `outs`: `kernel_route`'s kernel,
    its operands copied as `kernel_operand` says."""
    tq, tk = q.shape[1], k.shape[1]
    route, b, h, dh = _check_operands(("q", "k", "v", "dout"),
                                      (q, k, v, dout), (tq, tk, tk, tq))
    dev, dt = q.device, q.dtype
    checked = [kernel_operand(x, route) for x in (q, k, v, dout)]
    check_tensor("lse", lse, (b, h, tq), torch.float32, dev)
    check_tensor("delta", delta, (b, h, tq), torch.float32, dev)
    valid = kv_valid.to(torch.bool).contiguous().view(torch.uint8)
    check_tensor("kv_valid", valid, (b, tk), torch.uint8, dev)
    strides = (ctypes.c_int64 * 12)(*(s for x in checked
                                      for s in _strides(x)))
    lib = _bwd_bind(BWD_LIBRARY.load())
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            *(x.data_ptr() for x in checked), lse.data_ptr(),
            delta.data_ptr(), valid.data_ptr(),
            *(o.data_ptr() for o in outs), b, tq, tk, h, dh, strides,
            1.0 / dh ** 0.5, int(causal), DTYPES[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def flash_attention_bwd_dq(q, k, v, dout, lse: torch.Tensor,
                           delta: torch.Tensor, kv_valid: torch.Tensor,
                           causal: bool = False) -> torch.Tensor:
    """The dq kernel on CUDA tensors: dq [B, Tq, H, dh] in q's dtype, as
    the plain backward gives it. q/k/v/dout in one dtype: bfloat16 takes
    the wgmma kernel, float32 the SIMT one (`kernel_route`); an operand
    the routed kernel cannot read where it lies is copied first
    (`kernel_operand`). lse and delta (flash_attention_delta) [B, H, Tq]
    float32; kv_valid [B, Tk]."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, dout, lse, delta,
                kv_valid, causal, (dq,))
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0   # kernel launches (not CPU calls)


def flash_attention_bwd_dkv(q, k, v, dout, lse: torch.Tensor,
                            delta: torch.Tensor, kv_valid: torch.Tensor,
                            causal: bool = False):
    """The dk/dv kernel on CUDA tensors: (dk, dv) [B, Tk, H, dh] in k's
    dtype, as the plain backward gives them; inputs and routes as for
    flash_attention_bwd_dq."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, dout, lse, delta,
                kv_valid, causal, (dk, dv))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0   # kernel launches (not CPU calls)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the kernels on the
    card, the plain versions on the CPU. Saves q, k, v, out, lse and the
    boolean key mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal):
        valid = kv_valid.to(torch.bool).contiguous()
        fwd = (flash_attention_reference if q.device.type == "cpu"
               else flash_attention_fwd)
        out, lse = fwd(q, k, v, valid, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, valid,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bwd(q, k, v, out, dout, lse: torch.Tensor,
                        kv_valid: torch.Tensor, causal: bool = False):
    """FlashAttentionFunction's backward, from what it saved and dO:
    (dq, dk, dv). On CUDA tensors delta, then the dq and the dk/dv
    kernels; on CPU tensors the plain backward."""
    if dout.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, dout, lse,
                                             kv_valid, causal)
    delta = flash_attention_delta(out, dout).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_valid, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_valid,
                                     causal)
    return dq, dk, dv


def flash_attention(q, k, v, bias=None, kv_valid=None, causal=False):
    """q [B, Tq, H, dh], k/v [B, Tk, H, dh] -> [B, Tq, H, dh].

    kv_valid [B, Tk] (bool or float, > 0.5 = valid) and/or causal. A
    `bias` [B|1, 1, 1, Tk] is read as a key-padding mask (entries above
    NEG_INF / 2 valid), a [1, 1, Tk, Tk] bias as the causal mask; any
    other bias takes xla_attention."""
    b, tk = k.shape[0], k.shape[1]
    ones = lambda: torch.ones((b, tk), dtype=torch.bool,  # noqa: E731
                              device=k.device)
    if bias is not None:
        if bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1:
            kv_valid = (bias[:, 0, 0, :] > NEG_INF / 2).expand(b, tk)
        elif (bias.ndim == 4 and bias.shape[0] == 1 and bias.shape[1] == 1
              and bias.shape[2] == bias.shape[3] == tk):
            causal, kv_valid = True, ones()
        else:
            return xla_attention(q, k, v, ones(), causal)
    if kv_valid is None:
        kv_valid = ones()
    elif kv_valid.dtype != torch.bool:
        kv_valid = kv_valid > 0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, kv_valid, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_valid, causal)[0]
    return flash_attention_fwd(q, k, v, kv_valid, causal)[0]
