"""CIF fire through a hand-written CUDA kernel: the wrapper, the autograd
Function and the dispatcher (port of tpu_asr/ops/pallas/cif.py,
cif_fire_pallas).

The wrapper makes c = cumsum(alpha) in torch as the reference does; the
kernel (csrc/cif_fire.cu) takes c_prev = c - alpha (the same single float
subtraction as the reference's, not an exclusive cumsum: the two differ
in the last ulp) and fuses the overlap weights with the weighted sum, so
W [B, T, U] never exists.
The backward recomputes the plain formulation (ops/cif.py) under autograd,
as the reference's custom VJP differentiates its XLA formula; its [B, T, U]
product runs in full float32.

`cif_fire_kernel` is the port's one entry for firing (CifModel.fire and
the CIF decoders): on CUDA tensors it goes through the Function, which
launches the kernel or raises; on CPU tensors it runs the plain version
under native autograd, so the CPU computes the firing once. It reads no
`pallas_cif` flag.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.cif import cif_fire
from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

LIBRARY = KernelLibrary("cif_fire")
KERNEL_SYMBOL = "cif_fire_kernel"   # the __global__ name
MAX_B = 65535          # one grid row per utterance


def _bind(lib: ctypes.CDLL):
    if lib.cif_fire_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cif_fire_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.cif_fire_launch.restype = i
        lib.cif_fire_error_string.argtypes = [i]
        lib.cif_fire_error_string.restype = ctypes.c_char_p
    return lib


def cif_fire_fwd(hidden: torch.Tensor, alphas: torch.Tensor,
                 u_max: int) -> torch.Tensor:
    """fired [B, u_max, D] float32 from hidden [B, T, D] (any float dtype)
    and alphas [B, T]. On CUDA tensors launches the kernel on the current
    stream and counts it in `cif_fire_fwd.launches`; on CPU tensors runs
    the plain cif_fire."""
    if hidden.device.type == "cpu":
        return cif_fire(hidden.float(), alphas, u_max)
    if hidden.device.type != "cuda":
        raise ValueError(f"no CIF fire kernel for device {hidden.device}")
    b, t, d = hidden.shape
    if b > MAX_B:
        raise ValueError(f"CIF fire kernel needs B <= {MAX_B}, got {b}")
    dev = hidden.device
    alphas = alphas.float().contiguous()
    c = torch.cumsum(alphas, dim=-1)
    hidden = hidden.float().contiguous()
    check_tensor("alphas", alphas, (b, t), torch.float32, dev)
    check_tensor("c", c, (b, t), torch.float32, dev)
    check_tensor("hidden", hidden, (b, t, d), torch.float32, dev)
    lib = _bind(LIBRARY.load())
    out = torch.empty((b, u_max, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cif_fire_launch(c.data_ptr(), alphas.data_ptr(),
                                  hidden.data_ptr(), out.data_ptr(), b, t,
                                  u_max, d,
                                  torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.cif_fire_error_string(err).decode()
        raise RuntimeError(f"cif_fire launch failed: {msg} ({err})")
    cif_fire_fwd.launches += 1
    return out


cif_fire_fwd.launches = 0   # kernel launches (not CPU reference calls)


class CifFire(torch.autograd.Function):
    """fired [B, U, D] from (hidden, alphas); the backward differentiates
    the plain formulation, recomputed (reference: cif.py:109-113)."""

    @staticmethod
    def forward(ctx, hidden, alphas, u_max):
        ctx.save_for_backward(hidden, alphas)
        ctx.u_max = u_max
        return cif_fire_fwd(hidden, alphas, u_max)

    @staticmethod
    def backward(ctx, g):
        hidden, alphas = ctx.saved_tensors
        with torch.enable_grad():
            h = hidden.detach().requires_grad_()
            a = alphas.detach().requires_grad_()
            gh, ga = torch.autograd.grad(cif_fire(h.float(), a, ctx.u_max),
                                         (h, a), g)
        return gh, ga, None


def cif_fire_kernel(hidden: torch.Tensor, alphas: torch.Tensor,
                    u_max: int) -> torch.Tensor:
    """Integrate-and-fire: hidden [B, T, D] + alphas [B, T] -> fired
    [B, u_max, D] float32, differentiable in both inputs."""
    if hidden.device.type == "cpu":
        return cif_fire(hidden.float(), alphas, u_max)
    return CifFire.apply(hidden, alphas, u_max)
