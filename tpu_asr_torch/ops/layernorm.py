"""Fused residual-add + LayerNorm, forward and backward, through
hand-written CUDA kernels (port of tpu_asr/ops/pallas/layernorm.py).

LN(residual + h) over the last axis with the TPU kernel's numerics
(`_fwd_kernel`): the add in float32 (not in the input dtype), a two-pass
mean and variance in float32, rsqrt(var + eps), out = x_hat * gamma +
beta cast to the input dtype; mean and rstd float32, one per row. The
backward is the reference's custom VJP (`_bwd_kernel` + `_vjp_bwd`): x_hat
rebuilt from the saved inputs and statistics, dx = rstd (a - mean(a) -
x_hat mean(a x_hat)) with a = dy gamma, the same dx for residual and h,
and dgamma, dbeta as float32 sums over the rows cast to gamma's dtype.

`layer_norm_residual` is the dispatcher. Without a gradient it runs the
forward alone: on CUDA tensors the kernel of csrc/layer_norm_residual.cu
(counted in `layer_norm_residual_fwd.launches`), on CPU tensors the plain
version. When a gradient is wanted it goes through
`LayerNormResidualFunction`: on the card the forward kernel, then the
backward kernel (`layer_norm_residual_bwd.launches`); on the CPU the plain
forward and the plain backward (`layer_norm_residual_bwd_reference`).
Other devices raise.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

LIBRARY = KernelLibrary("layer_norm_residual")
LN_EPS = 1e-6
MAX_D = 2048          # one warp a row: D / 32 values a lane in registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16            # bytes: the backward kernel's vector loads


def layer_norm_residual_reference(residual: torch.Tensor, h: torch.Tensor,
                                  gamma: torch.Tensor, beta: torch.Tensor,
                                  eps: float = LN_EPS):
    """Plain version: (out [..., D] in residual's dtype, mean [...]
    float32, rstd [...] float32)."""
    x = residual.float() + h.float()
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = xc * rstd * gamma.float() + beta.float()
    return out.to(residual.dtype), mean[..., 0], rstd[..., 0]


def layer_norm_residual_bwd_reference(residual: torch.Tensor,
                                      h: torch.Tensor, gamma: torch.Tensor,
                                      mean: torch.Tensor, rstd: torch.Tensor,
                                      dy: torch.Tensor):
    """Plain backward: (dx [..., D] in residual's dtype, dgamma [D],
    dbeta [D] in gamma's dtype) from the forward's mean and rstd."""
    x = residual.float() + h.float()
    m, r = mean.float()[..., None], rstd.float()[..., None]
    xhat = (x - m) * r
    g = dy.float()
    a = g * gamma.float()
    m1 = a.mean(dim=-1, keepdim=True)
    m2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (a - m1 - xhat * m2)).to(residual.dtype)
    d = residual.shape[-1]
    dgamma = (g * xhat).reshape(-1, d).sum(dim=0).to(gamma.dtype)
    dbeta = g.reshape(-1, d).sum(dim=0).to(gamma.dtype)
    return dx, dgamma, dbeta


def bf16_ulp_error(got: torch.Tensor, want: torch.Tensor,
                   floor: float = 2.0 ** -8) -> float:
    """Largest |got - want| in bf16 ulps of `want`, each ulp taken at
    |want| but at no less than `floor` times the largest |want|. Near 0 an
    output is the difference of x_hat * gamma and -beta, float32 terms of
    the output's scale, whose last-bit rounding (a summation order, an
    fma) is itself many bf16 ulps of so small a value."""
    g, w = got.float(), want.float()
    mag = w.abs().clamp(min=floor * float(w.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)    # 8-bit significand
    return float(((g - w).abs() / ulp).max())


def _bind(lib: ctypes.CDLL):
    if lib.layer_norm_residual_launch.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.layer_norm_residual_launch.argtypes = (
            [p] * 7 + [i64, i, ctypes.c_float, i, p])
        lib.layer_norm_residual_launch.restype = i
        lib.layer_norm_residual_bwd_launch.argtypes = (
            [p] * 9 + [i64, i, i, p])
        lib.layer_norm_residual_bwd_launch.restype = i
        lib.layer_norm_residual_bwd_max_blocks.argtypes = [i, i]
        lib.layer_norm_residual_bwd_max_blocks.restype = i
        lib.layer_norm_residual_error_string.argtypes = [i]
        lib.layer_norm_residual_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_input(residual: torch.Tensor) -> None:
    if residual.device.type != "cuda":
        raise ValueError(f"no LayerNorm kernel for device {residual.device}")
    d = residual.shape[-1]
    if d % 32 or not 32 <= d <= MAX_D:
        raise ValueError(f"layer_norm_residual kernel needs D a multiple of "
                         f"32 in [32, {MAX_D}], got {d}")
    if residual.dtype not in DTYPES:
        raise TypeError(f"layer_norm_residual kernel takes float32 or "
                        f"bfloat16, got {residual.dtype}")


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        msg = lib.layer_norm_residual_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself if its base is ALIGN-byte aligned, else a copy (a layout
    step, not a fallback): the backward kernel reads 16 bytes a lane."""
    return x if x.data_ptr() % ALIGN == 0 else x.clone()


# float32 scratch of the backward kernel (its blocks' partial sums of
# dgamma and dbeta), one per (device, stream): launches on one stream use
# it in turn; and the most blocks a launch has, by (device, D, dtype)
_WORKSPACE: dict = {}
_MAX_BLOCKS: dict = {}


def _workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    ws = _WORKSPACE.get((dev, stream))
    if ws is None or ws.numel() < n:
        ws = torch.empty(n, dtype=torch.float32, device=dev)
        _WORKSPACE[dev, stream] = ws
    return ws


def layer_norm_residual_fwd(residual: torch.Tensor, h: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = LN_EPS):
    """The kernel on CUDA tensors: (out, mean, rstd) as the plain version
    gives them. residual/h [..., D] float32 or bfloat16 (one dtype),
    gamma/beta [D] (read as float32). Launches on the current stream."""
    _check_kernel_input(residual)
    shape, dev, dt = tuple(residual.shape), residual.device, residual.dtype
    d = shape[-1]
    rows = residual.numel() // d
    residual = residual.contiguous()
    h = h.contiguous()
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    check_tensor("residual", residual, shape, dt, dev)
    check_tensor("h", h, shape, dt, dev)
    check_tensor("gamma", gamma, (d,), torch.float32, dev)
    check_tensor("beta", beta, (d,), torch.float32, dev)
    out = torch.empty(shape, dtype=dt, device=dev)
    mean = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    rstd = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
    lib = _bind(LIBRARY.load())
    with torch.cuda.device(dev):
        err = lib.layer_norm_residual_launch(
            residual.data_ptr(), h.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), rows, d, eps, DTYPES[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "layer_norm_residual")
    layer_norm_residual_fwd.launches += 1
    return out, mean, rstd


layer_norm_residual_fwd.launches = 0   # kernel launches (not CPU calls)


def layer_norm_residual_bwd(residual: torch.Tensor, h: torch.Tensor,
                            gamma: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, dy: torch.Tensor):
    """The backward kernel on CUDA tensors: (dx, dgamma, dbeta) as the
    plain backward gives them. residual/h/dy [..., D] in one dtype
    (float32 or bfloat16), gamma [D], mean/rstd [...] float32 from the
    forward. One launch: the kernel writes dx and sums dgamma and dbeta
    itself (its blocks' partials in a fixed order, in scratch this module
    keeps per device and stream); an input not 16-byte aligned is copied
    first."""
    _check_kernel_input(residual)
    shape, dev, dt = tuple(residual.shape), residual.device, residual.dtype
    d = shape[-1]
    rows = residual.numel() // d
    residual, h, dy = (_aligned(x.contiguous()) for x in (residual, h, dy))
    g32 = _aligned(gamma.float().contiguous())
    for name, x in (("residual", residual), ("h", h), ("dy", dy)):
        check_tensor(name, x, shape, dt, dev)
    check_tensor("gamma", g32, (d,), torch.float32, dev)
    check_tensor("mean", mean, shape[:-1], torch.float32, dev)
    check_tensor("rstd", rstd, shape[:-1], torch.float32, dev)
    lib = _bind(LIBRARY.load())
    dx = torch.empty(shape, dtype=dt, device=dev)
    dgb = torch.empty((2, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        blocks = _MAX_BLOCKS.get((dev, d, dt))
        if blocks is None:
            blocks = lib.layer_norm_residual_bwd_max_blocks(d, DTYPES[dt])
            _raise_on(lib, max(-blocks, 0), "layer_norm_residual_bwd sizing")
            _MAX_BLOCKS[dev, d, dt] = blocks
        stream = torch.cuda.current_stream(dev).cuda_stream
        part = _workspace(dev, stream, blocks * 2 * d)
        err = lib.layer_norm_residual_bwd_launch(
            residual.data_ptr(), h.data_ptr(), dy.data_ptr(),
            g32.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dgb.data_ptr(), rows, d, DTYPES[dt], stream)
    _raise_on(lib, err, "layer_norm_residual_bwd")
    layer_norm_residual_bwd.launches += 1
    return dx, dgb[0].to(gamma.dtype), dgb[1].to(gamma.dtype)


layer_norm_residual_bwd.launches = 0   # kernel launches (not CPU calls)


class LayerNormResidualFunction(torch.autograd.Function):
    """LN(residual + h) with the reference's custom VJP: the kernels on the
    card, the plain versions on the CPU. Saves residual, h, gamma and the
    forward's mean and rstd."""

    @staticmethod
    def forward(ctx, residual, h, gamma, beta, eps):
        if residual.device.type == "cpu":
            out, mean, rstd = layer_norm_residual_reference(
                residual, h, gamma, beta, eps)
        else:
            out, mean, rstd = layer_norm_residual_fwd(residual, h, gamma,
                                                      beta, eps)
        ctx.save_for_backward(residual, h, gamma, mean, rstd)
        ctx.beta_dtype = beta.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        residual, h, gamma, mean, rstd = ctx.saved_tensors
        bwd = (layer_norm_residual_bwd_reference
               if dy.device.type == "cpu" else layer_norm_residual_bwd)
        dx, dgamma, dbeta = bwd(residual, h, gamma, mean, rstd, dy)
        # d(residual + h) flows identically to both addends
        return dx, dx.to(h.dtype), dgamma, dbeta.to(ctx.beta_dtype), None


def layer_norm_residual(residual: torch.Tensor, h: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = LN_EPS) -> torch.Tensor:
    """LN(residual + h) over the last axis -> out in residual's dtype."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (residual, h, gamma, beta)):
        return LayerNormResidualFunction.apply(residual, h, gamma, beta, eps)
    if residual.device.type == "cpu":
        return layer_norm_residual_reference(residual, h, gamma, beta,
                                             eps)[0]
    return layer_norm_residual_fwd(residual, h, gamma, beta, eps)[0]
