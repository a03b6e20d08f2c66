"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the `gpu` marker and skips on a machine
without a card.

This file imports no JAX (the card's machine has none), so it runs there
without the suite's conftest:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from tpu_asr_torch.ops.ctc import (_interleave_blanks, lattice_emissions,
                                   lattice_masks)
from tpu_asr_torch.ops.ctc_loss import (ctc_loss_bwd, ctc_loss_bwd_reference,
                                        ctc_loss_fwd, ctc_loss_fwd_reference)
from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                          ctc_prefix_scan_reference)

# entries at NEG_INF (-1e30) differ between implementations by float ulps
# of 1e30; clip both before comparing
CLIP = -1e31
TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(got.clamp(min=CLIP).cpu().numpy(),
                               want.clamp(min=CLIP).cpu().numpy(),
                               err_msg=what, **tol)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """ctc_prefix_scan."""
    _need_card()
    rng = np.random.default_rng(1)
    for n, t, k in [(40, 249, 11), (13, 9, 21), (3, 1, 11)]:
        dev = "cuda"
        x = torch.log_softmax(torch.from_numpy(
            rng.standard_normal((n, t, k + 1)).astype(np.float32)), -1)
        xc, xb = x[..., 1:].contiguous(), x[..., 0].contiguous()
        phi = xc.flip(-1).contiguous()
        nb0 = xc[:, 0].contiguous()
        b0 = torch.full((n, k), -1e30)
        lens = torch.from_numpy(rng.integers(0, t + 1, n).astype(np.int32))
        args = [a.to(dev) for a in (xc, phi, xb, nb0, b0, nb0.clone(), lens)]
        for hist in (True, False):
            before = ctc_prefix_scan.launches
            got = ctc_prefix_scan(*args, return_hist=hist)
            want = ctc_prefix_scan_reference(*args, return_hist=hist)
            torch.cuda.synchronize()
            assert ctc_prefix_scan.launches == before + 1
            for g, w in zip(got, want):
                if w is not None:
                    _close(g, w, f"N={n} T={t} K={k}")
        with pytest.raises(TypeError):
            ctc_prefix_scan(args[0].double(), *args[1:])


def ctc_case(seed, b, t, u, v):
    """Emission-level inputs with ragged rows: a full row, a dummy row
    (ilen 0, llen 0), an infeasible row, an empty transcript, repeats."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(
        np.float32))
    labels = rng.integers(1, v, (b, u))
    ilens = rng.integers(min(u + 2, t), t + 1, b).astype(np.int32)
    llens = rng.integers(1, u + 1, b).astype(np.int32)
    ilens[0], llens[0] = t, u
    ilens[1], llens[1] = 0, 0
    ilens[2], llens[2] = 3, min(5, u)
    llens[3] = 0
    labels[4, :3] = labels[4, 0]
    llens[4] = min(max(llens[4], 4), u)
    dev = "cuda"
    z = _interleave_blanks(torch.from_numpy(labels).to(dev), 0)
    ln = torch.from_numpy(llens).to(dev)
    skip, valid = lattice_masks(z, ln)
    e = lattice_emissions(logits.to(dev), z).contiguous()
    return e, skip, valid, torch.from_numpy(ilens).to(dev), ln


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u,v", [(32, 249, 24, 4233), (6, 20, 6, 12),
                                     (6, 1, 2, 9), (6, 30, 200, 300)])
def test_ctc_loss_kernels_match_plain_versions(b, t, u, v):
    _need_card()
    args = ctc_case(b + t, b, t, u, v)
    before = (ctc_loss_fwd.launches, ctc_loss_bwd.launches)
    nll, alpha = ctc_loss_fwd(*args)
    grad = ctc_loss_bwd(*args, alpha, nll)
    torch.cuda.synchronize()
    assert (ctc_loss_fwd.launches, ctc_loss_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want_nll, want_alpha = ctc_loss_fwd_reference(*args)
    want_grad = ctc_loss_bwd_reference(*args, want_alpha, want_nll)
    _close(nll, want_nll, "nll")
    _close(alpha, want_alpha, "alpha")
    _close(grad, want_grad, "grad_E", GRAD_TOL)
    assert not grad[1].any() and not grad[2].any()   # dummy, infeasible
    with pytest.raises(TypeError):
        ctc_loss_fwd(args[0].double(), *args[1:])
