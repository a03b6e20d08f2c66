"""Port CTC loss (tpu_asr_torch.ops.ctc_loss.ctc_loss_kernel, which runs
its plain recursions on the CPU) vs tpu_asr.ops.ctc.ctc_loss,
tpu_asr.ops.pallas.ctc.ctc_loss_pallas in interpret mode, and
torch.nn.functional.ctc_loss.

Tolerances: values rtol/atol 1e-5 and gradients rtol 1e-4 / atol 1e-5
(float32 on both sides; the recursions sum in the same order but
torch's and XLA's exp/log differ in the last ulps, which 249 dependent
steps at most amplify to ~1e-6 relative).

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_asr.ops.ctc import ctc_loss as jax_ctc_loss
from tpu_asr.ops.ctc import lattice_emissions as jax_lattice_emissions
from tpu_asr.ops.pallas.ctc import ctc_loss_pallas
from tpu_asr_torch.ops.ctc import (_interleave_blanks, lattice_emissions,
                                   lattice_masks)
from tpu_asr_torch.ops.ctc_loss import (ctc_loss_bwd, ctc_loss_bwd_reference,
                                        ctc_loss_fwd, ctc_loss_fwd_reference,
                                        ctc_loss_kernel,
                                        ctc_nll_from_emissions_reference)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def make_case(seed, b=6, t=20, u=6, v=12):
    """Ragged rows: a full row, a length-0 dummy row (ilen 0, llen 0), an
    infeasible row (ilen < llen), a row with llen 0, repeated labels."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    ilens = rng.integers(min(u + 2, t), t + 1, b).astype(np.int32)
    llens = rng.integers(1, u + 1, b).astype(np.int32)
    ilens[0], llens[0] = t, u
    ilens[1], llens[1] = 0, 0                      # dummy row
    ilens[2], llens[2] = 3, min(5, u)              # infeasible
    llens[3] = 0                                   # empty transcript
    labels[4, :3] = labels[4, 0]                   # repeats need blanks
    llens[4] = min(max(llens[4], 4), u)
    return logits, labels, ilens, llens


def _jax_loss(fn, logits, labels, ilens, llens, reduction, **kw):
    return fn(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(ilens),
              jnp.asarray(llens), reduction=reduction, **kw)


def _jax_grad(fn, logits, labels, ilens, llens, **kw):
    return np.asarray(jax.grad(lambda lg: fn(
        lg, jnp.asarray(labels), jnp.asarray(ilens), jnp.asarray(llens),
        reduction="mean_label", **kw))(jnp.asarray(logits)))


def _torch_value_and_grad(fn, logits, labels, ilens, llens):
    lg = torch.from_numpy(logits).requires_grad_(True)
    args = (torch.from_numpy(labels).long(), torch.from_numpy(ilens),
            torch.from_numpy(llens))
    nll = fn(lg, *args, reduction="none")
    loss = fn(lg, *args, reduction="mean_label")
    loss.backward()
    return nll.detach().numpy(), lg.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_scan_matches_jax_scan(seed):
    """ctc_loss_kernel on the CPU against the reference's autograd scan.
    A row of length 0 has nll = -E[0, 0] in both; the scan differentiates
    it, while the kernel pair (like the Pallas pair it ports) gives it no
    gradient, so gradients are compared on rows with frames."""
    case = make_case(seed)
    want = _jax_loss(jax_ctc_loss, *case, "none")
    got, grad = _torch_value_and_grad(ctc_loss_kernel, *case)
    np.testing.assert_allclose(got, np.asarray(want), **VAL)
    rows = case[2] > 0
    np.testing.assert_allclose(grad[rows],
                               _jax_grad(jax_ctc_loss, *case)[rows], **GRAD)
    assert not grad[~rows].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_path_matches_pallas_interpret(seed):
    """ctc_loss_kernel on the CPU (plain alpha pass + explicit beta pass)
    against the Pallas kernel pair run in interpret mode."""
    case = make_case(seed)
    want = _jax_loss(ctc_loss_pallas, *case, "none", interpret=True)
    got, grad = _torch_value_and_grad(ctc_loss_kernel, *case)
    np.testing.assert_allclose(got, np.asarray(want), **VAL)
    np.testing.assert_allclose(
        grad, _jax_grad(ctc_loss_pallas, *case, interpret=True), **GRAD)
    assert got[2] == 0.0                     # infeasible: zero_infinity
    assert np.isfinite(grad).all()
    assert not grad[1].any() and not grad[2].any()   # dummy, infeasible


def test_scan_and_kernel_path_agree_with_torch_ctc_loss():
    """Independent check: torch's own CTC (blank 0, zero_infinity) on the
    log-probabilities, rows with a real transcript and length."""
    logits, labels, ilens, llens = make_case(2)
    rows = [0, 3, 4, 5]
    logits, labels, ilens, llens = (x[rows] for x in (logits, labels, ilens,
                                                      llens))
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    want = F.ctc_loss(lp.transpose(0, 1), torch.from_numpy(labels).long(),
                      torch.from_numpy(ilens).long(),
                      torch.from_numpy(llens).long(), blank=0,
                      reduction="none", zero_infinity=True)
    got, _ = _torch_value_and_grad(ctc_loss_kernel, logits, labels, ilens,
                                   llens)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-4)


def test_infeasible_and_dummy_rows_give_finite_zero_gradient():
    """Rows whose nll is NEG_INF-bound (no path) or that the model masks
    out (upstream gradient 0) must give exactly 0, never 0 * inf = NaN."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 4, 8)).astype(np.float32)
    labels = np.array([[1, 1, 1], [2, 3, 4], [5, 6, 0]], np.int32)
    ilens = np.array([4, 2, 0], np.int32)       # 1 1 1 needs 5 frames
    llens = np.array([3, 3, 0], np.int32)
    lg = torch.from_numpy(logits).requires_grad_(True)
    nll = ctc_loss_kernel(lg, torch.from_numpy(labels).long(),
                          torch.from_numpy(ilens), torch.from_numpy(llens),
                          reduction="none")
    assert nll[0].item() == 0.0 and nll[1].item() == 0.0
    nll.sum().backward()
    assert torch.isfinite(lg.grad).all()
    assert not lg.grad[:2].any()


def test_emissions_reference_grad_is_the_autograd_grad():
    """grad_E of the explicit beta pass equals autograd through the plain
    alpha loop (d nll / d E), on rows with a length and a path. A row of
    length 0 keeps its t = 0 alpha (nll = -E[0, 0]) but gets no gradient,
    as in the TPU kernel: the beta pass starts at t = ilen - 1."""
    logits, labels, ilens, llens = make_case(3)
    z = _interleave_blanks(torch.from_numpy(labels).long(), 0)
    skip, valid = lattice_masks(z, torch.from_numpy(llens))
    e = lattice_emissions(torch.from_numpy(logits), z).detach()
    il, ln = torch.from_numpy(ilens), torch.from_numpy(llens)
    nll, grad_e = ctc_nll_from_emissions_reference(e, skip, valid, il, ln)
    e_req = e.clone().requires_grad_(True)
    nll_ad, _ = ctc_loss_fwd_reference(e_req, skip, valid, il, ln)
    keep = (nll_ad < 5e29) & (il > 0)
    nll_ad[keep].sum().backward()
    assert torch.equal(nll, nll_ad.detach())
    assert not grad_e[il == 0].any()
    np.testing.assert_allclose(grad_e[keep].numpy(),
                               e_req.grad[keep].numpy(), **GRAD)


def test_bf16_emissions_equal_the_reference_einsum():
    """bf16 logits: gathering the float32 copy gives the values of the
    reference's one-hot einsum at HIGHEST precision, cast to float32."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 7, 30)).astype(np.float32)
    labels = rng.integers(1, 30, (2, 4)).astype(np.int32)
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    from tpu_asr.ops.ctc import _interleave_blanks as jax_interleave
    want = jax_lattice_emissions(jl, jax_interleave(jnp.asarray(labels), 0),
                                 False)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).bfloat16()
    got = lattice_emissions(tl, _interleave_blanks(
        torch.from_numpy(labels).long(), 0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def test_cpu_wrappers_run_plain_versions_without_counting():
    logits, labels, ilens, llens = make_case(6)
    z = _interleave_blanks(torch.from_numpy(labels).long(), 0)
    skip, valid = lattice_masks(z, torch.from_numpy(llens))
    e = lattice_emissions(torch.from_numpy(logits), z)
    args = (e, skip, valid, torch.from_numpy(ilens), torch.from_numpy(llens))
    before = (ctc_loss_fwd.launches, ctc_loss_bwd.launches)
    nll, alpha = ctc_loss_fwd(*args)
    grad = ctc_loss_bwd(*args, alpha, nll)
    assert (ctc_loss_fwd.launches, ctc_loss_bwd.launches) == before
    want_nll, want_alpha = ctc_loss_fwd_reference(*args)
    assert torch.equal(nll, want_nll) and torch.equal(alpha, want_alpha)
    assert torch.equal(grad, ctc_loss_bwd_reference(*args, alpha, nll))
    # frozen alpha past each length; the dummy row keeps its t = 0 row
    il = int(ilens[0])
    assert torch.equal(alpha[0, il:], alpha[0, il - 1:il].expand(
        alpha.shape[1] - il, -1))
    assert torch.equal(alpha[1, 1:], alpha[1, :1].expand(
        alpha.shape[1] - 1, -1))
