"""CTC prefix-score recursion (joint CTC/attention decoding): the CUDA
kernel's wrapper and its plain PyTorch version.

Port of tpu_asr/ops/pallas/ctc_prefix.py::ctc_prefix_scan_pallas. The
kernel (csrc/ctc_prefix_scan.cu) runs one thread per (beam, candidate)
chain over time; see its source note for what bounds it on the card.

`ctc_prefix_scan` dispatches on the device of its inputs: CUDA tensors
launch the kernel (or raise), CPU tensors run `ctc_prefix_scan_reference`.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_asr_torch.ops.cuda_build import KernelLibrary, check_tensor

NEG_INF = -1e30

LIBRARY = KernelLibrary("ctc_prefix_scan")


def _bind(lib: ctypes.CDLL):
    fn = lib.ctc_prefix_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ctc_prefix_scan_error_string.argtypes = [ctypes.c_int]
        lib.ctc_prefix_scan_error_string.restype = ctypes.c_char_p
    return fn


def ctc_prefix_scan_reference(x_cand, phi, x_blank, r_nb0, r_b0, psi0,
                              lengths, return_hist: bool = True):
    """Plain PyTorch version: the step loop of the reference's lax.scan
    (tpu_asr/decode/ctc_prefix.py) with torch.logaddexp / torch.where.

    x_cand/phi: [N, T, K]; x_blank: [N, T]; inits [N, K]; lengths [N].
    Returns (psi [N, K], nb_hist [N, T, K], b_hist [N, T, K]); histories
    are None when return_hist=False."""
    n, t, k = x_cand.shape
    r_nb, r_b, psi = r_nb0, r_b0, psi0
    nb_steps, b_steps = [r_nb0], [r_b0]
    for s in range(1, t):
        xc, ph, xb = x_cand[:, s], phi[:, s - 1], x_blank[:, s, None]
        new_nb = torch.logaddexp(r_nb, ph) + xc
        new_b = torch.logaddexp(r_nb, r_b) + xb
        new_psi = torch.logaddexp(psi, ph + xc)
        keep = (s < lengths)[:, None]
        r_nb = torch.where(keep, new_nb, r_nb)
        r_b = torch.where(keep, new_b, r_b)
        psi = torch.where(keep, new_psi, psi)
        if return_hist:
            nb_steps.append(r_nb)
            b_steps.append(r_b)
    if not return_hist:
        return psi, None, None
    return psi, torch.stack(nb_steps, dim=1), torch.stack(b_steps, dim=1)


def ctc_prefix_scan(x_cand, phi, x_blank, r_nb0, r_b0, psi0, lengths,
                    return_hist: bool = True):
    """Run the prefix recursion for K candidates per beam.

    Same contract as ctc_prefix_scan_reference. On CUDA tensors: float32,
    contiguous, lengths int32; launches the kernel on the current stream
    and counts the launch in `ctc_prefix_scan.launches`."""
    if x_cand.device.type == "cpu":
        return ctc_prefix_scan_reference(x_cand, phi, x_blank, r_nb0, r_b0,
                                         psi0, lengths, return_hist)
    if x_cand.device.type != "cuda":
        raise ValueError(f"no ctc_prefix_scan for device {x_cand.device}")
    n, t, k = x_cand.shape
    dev, f32 = x_cand.device, torch.float32
    check_tensor("x_cand", x_cand, (n, t, k), f32, dev)
    check_tensor("phi", phi, (n, t, k), f32, dev)
    check_tensor("x_blank", x_blank, (n, t), f32, dev)
    for name, x in (("r_nb0", r_nb0), ("r_b0", r_b0), ("psi0", psi0)):
        check_tensor(name, x, (n, k), f32, dev)
    check_tensor("lengths", lengths, (n,), torch.int32, dev)
    fn = _bind(LIBRARY.load())
    psi = torch.empty((n, k), dtype=f32, device=dev)
    if return_hist:
        nb_hist = torch.empty((n, t, k), dtype=f32, device=dev)
        b_hist = torch.empty((n, t, k), dtype=f32, device=dev)
        hist_ptrs = (nb_hist.data_ptr(), b_hist.data_ptr())
    else:
        nb_hist = b_hist = None
        hist_ptrs = (None, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(x_cand.data_ptr(), phi.data_ptr(), x_blank.data_ptr(),
                 r_nb0.data_ptr(), r_b0.data_ptr(), psi0.data_ptr(),
                 lengths.data_ptr(), psi.data_ptr(), *hist_ptrs, n, t, k,
                 int(return_hist), stream)
    if err:
        msg = LIBRARY.load().ctc_prefix_scan_error_string(err).decode()
        raise RuntimeError(f"ctc_prefix_scan launch failed: {msg} ({err})")
    ctc_prefix_scan.launches += 1
    return psi, nb_hist, b_hist


ctc_prefix_scan.launches = 0   # kernel launches (not CPU reference calls)
