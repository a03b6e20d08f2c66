"""Fused residual-add + LayerNorm forward through a hand-written CUDA
kernel (port of tpu_asr/ops/pallas/layernorm.py, the forward).

LN(residual + h) over the last axis with the TPU kernel's numerics
(`_fwd_kernel`): the add in float32 (not in the input dtype), a two-pass
mean and variance in float32, rsqrt(var + eps), out = x_hat * gamma +
beta cast to the input dtype; mean and rstd float32, one per row.

`layer_norm_residual` is the dispatcher: on CUDA tensors it launches
csrc/layer_norm_residual.cu (counted in `layer_norm_residual_fwd.launches`)
or raises; on CPU tensors it runs the plain version. The kernel's
backward is the next slice of the port: on CUDA tensors that need a
gradient the dispatcher raises NotImplementedError instead of running
the plain version quietly. On the CPU the plain version runs under
autograd.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

LIBRARY = KernelLibrary("layer_norm_residual")
LN_EPS = 1e-6
MAX_D = 2048          # one warp a row: D / 32 values a lane in registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.layer_norm_residual_launch.argtypes = (
            [p] * 7 + [ctypes.c_int64, i, ctypes.c_float, i, p])
        lib.layer_norm_residual_launch.restype = i
        lib.layer_norm_residual_error_string.argtypes = [i]
        lib.layer_norm_residual_error_string.restype = ctypes.c_char_p
    return lib


def layer_norm_residual_fwd(residual: torch.Tensor, h: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = LN_EPS):
    """The kernel on CUDA tensors: (out, mean, rstd) as the plain version
    gives them. residual/h [..., D] float32 or bfloat16 (one dtype),
    gamma/beta [D] (read as float32). Launches on the current stream."""
    if residual.device.type != "cuda":
        raise ValueError(f"no LayerNorm kernel for device {residual.device}")
    d = residual.shape[-1]
    if d % 32 or not 32 <= d <= MAX_D:
        raise ValueError(f"layer_norm_residual kernel needs D a multiple of "
                         f"32 in [32, {MAX_D}], got {d}")
    if residual.dtype not in DTYPES:
        raise TypeError(f"layer_norm_residual kernel takes float32 or "
                        f"bfloat16, got {residual.dtype}")
    shape, dev, dt = tuple(residual.shape), residual.device, residual.dtype
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
    if err:
        msg = lib.layer_norm_residual_error_string(err).decode()
        raise RuntimeError(f"layer_norm_residual launch failed: {msg} "
                           f"({err})")
    layer_norm_residual_fwd.launches += 1
    return out, mean, rstd


layer_norm_residual_fwd.launches = 0   # kernel launches (not CPU calls)


def layer_norm_residual(residual: torch.Tensor, h: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float = LN_EPS) -> torch.Tensor:
    """LN(residual + h) over the last axis -> out in residual's dtype."""
    if residual.device.type == "cpu":
        return layer_norm_residual_reference(residual, h, gamma, beta,
                                             eps)[0]
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (residual, h, gamma, beta)):
        raise NotImplementedError(
            "the fused LayerNorm kernel's backward is not ported yet (the "
            "use_pallas training slice); train with pallas_layernorm=False")
    return layer_norm_residual_fwd(residual, h, gamma, beta, eps)[0]
