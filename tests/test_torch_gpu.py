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

from tpu_asr_torch.ops.cif import cif_fire
from tpu_asr_torch.ops.cif_fire import cif_fire_fwd, cif_fire_kernel
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


def prefix_inputs(rng, n, t, k, lens):
    x = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((n, t, k + 1)).astype(np.float32)), -1)
    xc, xb = x[..., 1:].contiguous(), x[..., 0].contiguous()
    phi = xc.flip(-1).contiguous()
    phi[:, :, 0] = -1e30
    nb0 = xc[:, 0].contiguous()
    b0 = torch.full((n, k), -1e30)
    lens = torch.tensor(lens, dtype=torch.int32)
    return [a.cuda() for a in (xc, phi, xb, nb0, b0, nb0.clone(), lens)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,k,lens", [
    (5, 65, 11, [65, 64, 33, 32, 2]),      # 64, 63, 32, 31, 1 steps
    (4, 3000, 11, [3000, 2999, 1500, 33]),  # (2K + 1) T 4 = 276 KB of rows
    (3, 40, 11, [100, 40, 0]),              # a length past T
    (3, 70, 300, [70, 69, 5]),              # three chain groups a beam
    (2, 249, 130, [249, 120]),              # a ring over 99 KB
])
def test_prefix_scan_ring_edges(n, t, k, lens):
    """The ring of tiles at its edges: steps a whole number of tiles and
    one past, rows far larger than shared memory, lengths past T, K over
    a block's chains. Two calls give the same bits."""
    _need_card()
    args = prefix_inputs(np.random.default_rng(n * t + k), n, t, k, lens)
    for hist in (True, False):
        got = ctc_prefix_scan(*args, return_hist=hist)
        again = ctc_prefix_scan(*args, return_hist=hist)
        want = ctc_prefix_scan_reference(*args, return_hist=hist)
        torch.cuda.synchronize()
        for g, a, w in zip(got, again, want):
            if w is not None:
                _close(g, w, f"N={n} T={t} K={k} hist={hist}")
                assert torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u,ilens,llens", [
    (5, 20, 5, [25, 20, 16, 17, 1], [5, 5, 2, 5, 0]),   # ilen past T
    (3, 3000, 24, [3000, 2999, 1601], [24, 24, 10]),    # 1.2 MB of rows
    (4, 249, 31, [249, 200, 33, 32], [31, 31, 8, 5]),   # S = 63, 2 a lane
    (4, 249, 32, [249, 200, 33, 32], [32, 31, 8, 5]),   # S = 65, 2 + 1
    (5, 60, 63, [60, 59, 17, 16, 1], [63, 60, 8, 5, 0]),  # S = 127, 4
    (3, 50, 33, [50, 49, 2], [33, 20, 1]),              # S = 67, 3
    (3, 50, 48, [50, 49, 20], [48, 40, 8]),             # S = 97, 3 + 1
    (3, 30, 64, [30, 29, 1], [64, 30, 0]),              # S = 129, block
    (9, 48, 24, [48] * 9, [24] * 9),  # 3 rows of tiles; a block not full
])
def test_ctc_loss_bwd_routes_and_ring_edges(b, t, u, ilens, llens):
    """The backward on the route its S picks (counted in
    BWD_ROUTE_LAUNCHES) against the plain version on the kernel forward's
    alpha and nll, at the warp route's ring edges; rows past ilen or with
    ilen > T are zero; two calls give the same bits."""
    from tpu_asr_torch.ops.ctc_loss import BWD_ROUTE_LAUNCHES, bwd_route
    _need_card()
    g = np.random.default_rng(b * t + u)
    logits = torch.from_numpy(g.standard_normal((b, t, 150)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(g.integers(1, 150, (b, u))).cuda()
    z = _interleave_blanks(labels, 0)
    ln = torch.tensor(llens, dtype=torch.int32, device="cuda")
    skip, valid = lattice_masks(z, ln)
    args = (lattice_emissions(logits, z).contiguous(), skip, valid,
            torch.tensor(ilens, dtype=torch.int32, device="cuda"), ln)
    nll, alpha = ctc_loss_fwd(*args)
    route = bwd_route(2 * u + 1)
    before = dict(BWD_ROUTE_LAUNCHES)
    got = ctc_loss_bwd(*args, alpha, nll)
    again = ctc_loss_bwd(*args, alpha, nll)
    want = ctc_loss_bwd_reference(*args, alpha, nll)
    torch.cuda.synchronize()
    assert BWD_ROUTE_LAUNCHES[route] == before[route] + 2
    _close(got, want, "grad_E", GRAD_TOL)
    assert torch.equal(got, again)
    for i, il in enumerate(ilens):
        top = il if il <= t else 0
        assert not got[i, top:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u,ilens,llens", [
    (4, 1, 3, [1, 1, 0, 1], [0, 1, 0, 3]),             # T = 1, S = 7
    (3, 20, 0, [20, 7, 0], [0, 0, 0]),                  # S = 1
    (5, 20, 5, [25, 20, 16, 17, 1], [5, 5, 2, 5, 0]),   # ilen past T
    (5, 40, 5, [40, 33, 32, 31, 0], [5, 5, 2, 5, 0]),   # rows at tile edges
    (3, 3000, 24, [3000, 2999, 1601], [24, 24, 10]),    # 1.2 MB of rows
    (4, 249, 32, [249, 200, 33, 32], [32, 31, 8, 5]),   # S = 65, 2 + 1
    (3, 50, 48, [50, 49, 20], [48, 40, 8]),             # S = 97, 3 + 1
    (5, 60, 63, [60, 59, 17, 16, 1], [63, 60, 8, 5, 0]),  # S = 127, 4
    (3, 30, 64, [30, 29, 1], [64, 30, 0]),              # S = 129, block
    (3, 300, 200, [300, 250, 150], [200, 200, 100]),    # S = 401, block
    (9, 48, 24, [48] * 9, [24] * 9),  # 3 tiles of rows; a block not full
])
def test_ctc_loss_fwd_routes_and_ring_edges(b, t, u, ilens, llens):
    """The forward on the route its S picks (counted in
    FWD_ROUTE_LAUNCHES) gives the plain version's nll and alpha bit for
    bit, at the warp route's ring edges, with rows frozen past ilen and
    length-0 rows keeping their t = 0 row; two calls give the same
    bits."""
    from tpu_asr_torch.ops.ctc_loss import FWD_ROUTE_LAUNCHES, fwd_route
    _need_card()
    g = np.random.default_rng(b * t + u)
    logits = torch.from_numpy(g.standard_normal((b, t, 150)).astype(
        np.float32)).cuda()
    labels = torch.from_numpy(g.integers(1, 150, (b, u))).cuda()
    z = _interleave_blanks(labels, 0)
    ln = torch.tensor(llens, dtype=torch.int32, device="cuda")
    skip, valid = lattice_masks(z, ln)
    args = (lattice_emissions(logits, z).contiguous(), skip, valid,
            torch.tensor(ilens, dtype=torch.int32, device="cuda"), ln)
    route = fwd_route(2 * u + 1)
    before = dict(FWD_ROUTE_LAUNCHES)
    got = ctc_loss_fwd(*args)
    again = ctc_loss_fwd(*args)
    want = ctc_loss_fwd_reference(*args)
    torch.cuda.synchronize()
    assert FWD_ROUTE_LAUNCHES[route] == before[route] + 2
    for name, g_, a, w in zip(("nll", "alpha"), got, again, want):
        assert torch.equal(g_, w), (name, (g_ - w).abs().max().item())
        assert torch.equal(g_, a), name
    alpha = got[1]
    for i, il in enumerate(ilens):
        last = min(max(il, 1), t) - 1
        assert torch.equal(alpha[i, last:], alpha[i, last].expand(
            t - last, -1))


SMEM_LIMIT = 232_448     # shared memory a block may have on an H100


@pytest.mark.gpu
def test_launch_plans_fit_a_block():
    """The launches the rebuilt kernels' sources work out stay within a
    block's shared memory and threads for any T: the prefix scan at K = 1,
    11, 130 and 300 (chain groups of 128), the forward's and backward's
    warp routes at every S they take, with P positions a lane covering
    S."""
    from tpu_asr_torch.ops import ctc_loss, ctc_prefix
    _need_card()
    for k in (1, 11, 130, 300):
        plan = ctc_prefix.launch_plan(k)
        assert plan["smem_bytes"] <= SMEM_LIMIT, (k, plan)
        assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
        chains = plan["threads"] - 32
        assert chains * plan["blocks_per_beam"] >= k
    for which in ("fwd", "bwd"):
        for s in range(1, ctc_loss.WARP_MAX_S + 1):
            plan = ctc_loss.warp_plan(s, which)
            assert plan["smem_bytes"] <= SMEM_LIMIT, (which, s, plan)
            assert 32 * plan["positions"] + 1 >= s
            assert plan["positions"] == (2 if s <= 65 else 3 if s <= 97
                                         else 4)
        with pytest.raises(RuntimeError):
            ctc_loss.warp_plan(ctc_loss.WARP_MAX_S + 1, which)


@pytest.mark.gpu
def test_prefix_scan_log1p_is_log1pf():
    """The prefix scan's logaddexp takes log1p of exp(-|a - b|), in
    [0, 1]; its branch-free log1p gives log1pf's bits at every float
    there."""
    from tpu_asr_torch.ops.ctc_prefix import log1p_mismatches
    _need_card()
    assert log1p_mismatches() == 0


@pytest.mark.gpu
def test_ctc_forward_log_is_logf():
    """The CTC forward's lae3 takes the log of a sum of three exps, in
    [1, 3] wherever its result is kept; its branch-free log gives logf's
    bits at every float there."""
    from tpu_asr_torch.ops.ctc_loss import log_mismatches
    _need_card()
    assert log_mismatches() == 0


@pytest.mark.gpu
def test_chain_probes_run():
    """The three chain probes (one warp each, no memory traffic) launch and
    give finite results."""
    from tpu_asr_torch.ops import ctc_loss, ctc_prefix
    _need_card()
    assert torch.isfinite(ctc_prefix.chain_probe(248)).all()
    for which in ("fwd", "bwd"):
        assert torch.isfinite(ctc_loss.chain_probe(248, 49,
                                                   which=which)).all()
        with pytest.raises(RuntimeError):        # two positions a lane only
            ctc_loss.chain_probe(248, 65, which=which)


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


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,u,top", [
    (32, 249, 512, 25, 1.0),     # the path's shape (raw alphas)
    (8, 60, 64, 100, 3.0),       # alphas up to 3, u_max past the fires
    (5, 1, 512, 4, 2.5),         # T = 1
    (6, 249, 512, 1, 1.0),       # u_max = 1
])
def test_cif_fire_kernel_matches_plain_version(b, t, d, u, top):
    """Same c rows, so the same weights bit for bit: only the order of the
    sum differs (atol 1e-5, rtol 1e-5). Row 1 is a zero-length row."""
    _need_card()
    rng = np.random.default_rng(b + t + d)
    hidden = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).cuda()
    alphas = torch.from_numpy(rng.uniform(0, top, (b, t)).astype(
        np.float32)).cuda()
    if b > 1:
        alphas[1] = 0.0
    before = cif_fire_fwd.launches
    got = cif_fire_fwd(hidden, alphas, u)
    want = cif_fire(hidden, alphas, u)
    torch.cuda.synchronize()
    assert cif_fire_fwd.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    if b > 1:
        assert not got[1].any()
    h = hidden.clone().requires_grad_(True)
    a = alphas.clone().requires_grad_(True)
    gh, ga = torch.autograd.grad(cif_fire_kernel(h, a, u).square().sum(),
                                 (h, a))
    wh, wa = torch.autograd.grad(cif_fire(h, a, u).square().sum(), (h, a))
    np.testing.assert_allclose(gh.cpu().numpy(), wh.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    # the alpha gradient is a reverse cumsum over frames: its rounding
    # error scales with its largest entry
    wa = wa.cpu().numpy()
    np.testing.assert_allclose(ga.cpu().numpy(), wa, rtol=1e-4,
                               atol=1e-5 * np.abs(wa).max())


def disordered_alphas(rng, b, t):
    """Alphas whose c - alpha is not monotone in its last ulp: each row's
    cumsum reaches 16, 32 or 64 exactly on halves, ten alphas of 1e-10
    leave c and c - alpha there, and the next alpha's c - alpha rounds to
    one ulp below in about a quarter of the rows: that frame weighs ~2e-6
    on the output before."""
    a = rng.uniform(0.0, 0.9, (b, t)).astype(np.float32)
    for r in range(b):
        k = 2 * (16, 32, 64)[r % 3]
        a[r, :k] = 0.5
        a[r, k:k + 10] = 1e-10
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,u,kind", [
    (32, 249, 512, 200, "disordered"),
    (3, 3000, 512, 400, "scaled"),    # T past one stage of c (2048 frames)
    (4, 2049, 96, 300, "scaled"),     # one frame past it; D not a slab
    (5, 70, 130, 60, "raw"),          # D not a multiple of 4: scalar loads
])
def test_cif_fire_kernel_at_disordered_and_long_inputs(b, t, d, u, kind):
    """cif_fire_fwd against the plain cif_fire (atol 1e-5, rtol 1e-5) where
    c - alpha is out of order in its last ulp, where T needs more than one
    shared-memory stage of c and c - alpha, and at D that takes scalar
    loads; two calls give the same bits."""
    _need_card()
    rng = np.random.default_rng(b + t + d)
    hidden = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).cuda()
    if kind == "disordered":
        a = disordered_alphas(rng, b, t)
    else:
        a = rng.uniform(0.0, 1.0, (b, t)).astype(np.float32)
        if kind == "scaled":
            a *= u / a.sum(1, keepdims=True)
    alphas = torch.from_numpy(a).cuda()
    got = cif_fire_fwd(hidden, alphas, u)
    again = cif_fire_fwd(hidden, alphas, u)
    want = cif_fire(hidden, alphas, u)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dtype", [
    (1, 64, torch.float32), (511, 512, torch.float32),
    (1000, 64, torch.float32), (8080, 512, torch.bfloat16),
    (1984, 512, torch.bfloat16), (7, 2048, torch.bfloat16),
])
def test_layer_norm_residual_kernel_matches_plain_version(rows, d, dtype):
    """float32 within 1e-5; bfloat16 within one bf16 ulp of the plain
    version at the output's scale (the float32 statistics differ in their
    last bits and may flip a rounding; see bf16_ulp_error); mean and rstd
    within 1e-5. Then the backward kernel and the autograd Function."""
    from tpu_asr_torch.ops.layernorm import (
        bf16_ulp_error, layer_norm_residual, layer_norm_residual_bwd,
        layer_norm_residual_bwd_reference, layer_norm_residual_fwd,
        layer_norm_residual_reference)
    _need_card()
    rng = np.random.default_rng(rows + d)
    r, h = (torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).cuda().to(dtype) for _ in range(2))
    g, b = (torch.from_numpy(rng.standard_normal(d).astype(
        np.float32)).cuda() for _ in range(2))
    before = layer_norm_residual_fwd.launches
    out, mean, rstd = layer_norm_residual_fwd(r, h, g, b)
    w_out, w_mean, w_rstd = layer_norm_residual_reference(r, h, g, b)
    torch.cuda.synchronize()
    assert layer_norm_residual_fwd.launches == before + 1
    assert out.dtype == dtype and mean.shape == (rows,)
    for got, want in ((mean, w_mean), (rstd, w_rstd)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.cpu().numpy(), w_out.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert bf16_ulp_error(out, w_out) <= 1.0
    with pytest.raises(ValueError):
        layer_norm_residual_fwd(r[:, :30], h[:, :30], g[:30], b[:30])

    # the backward kernel against the plain backward from the kernel's
    # statistics: dx as out above; dgamma, dbeta (float32 sums over the
    # rows) within 1e-5 of their largest magnitude
    dy = torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).cuda().to(dtype)
    before = layer_norm_residual_bwd.launches
    got = layer_norm_residual_bwd(r, h, g, mean, rstd, dy)
    want = layer_norm_residual_bwd_reference(r, h, g, mean, rstd, dy)
    torch.cuda.synchronize()
    assert layer_norm_residual_bwd.launches == before + 1
    _close_ln_grads(got, want, dtype)

    # the Function: the forward and backward kernels, the same dx for both
    # addends, and the plain backward's gradients
    xs = [x.clone().requires_grad_(True) for x in (r, h, g, b)]
    before = (layer_norm_residual_fwd.launches,
              layer_norm_residual_bwd.launches)
    grads = torch.autograd.grad(
        (layer_norm_residual(*xs).float() * dy.float()).sum(), xs)
    torch.cuda.synchronize()
    assert (layer_norm_residual_fwd.launches,
            layer_norm_residual_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert torch.equal(grads[0], grads[1])
    _close_ln_grads((grads[0], grads[2], grads[3]), want, dtype)


def _close_ln_grads(got, want, dtype):
    from tpu_asr_torch.ops.layernorm import bf16_ulp_error
    (dx, dg, db), (w_dx, w_dg, w_db) = got, want
    assert dx.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(dx.cpu().numpy(), w_dx.cpu().numpy(),
                                   **GRAD_TOL)
    else:
        assert bf16_ulp_error(dx, w_dx) <= 1.0
    for x, w in ((dg, w_dg), (db, w_db)):
        w = w.cpu().numpy()
        np.testing.assert_allclose(x.cpu().numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,tq,tk,h,dh,causal,dtype,kind", [
    (8, 248, 248, 8, 64, False, torch.bfloat16, "ragged"),   # encoder self
    (80, 101, 101, 8, 64, True, torch.bfloat16, "ragged"),   # decoder self
    (80, 101, 248, 8, 64, False, torch.bfloat16, "ragged"),  # decoder cross
    (3, 1, 600, 2, 32, False, torch.float32, "ragged"),      # Tq = 1, Tk > 512
    (3, 70, 70, 4, 128, True, torch.float32, "ragged"),
    (4, 33, 600, 2, 64, False, torch.float32, "ragged"),
    # the wgmma kernels: dh 32 (64-byte swizzle) and 128 (two panels),
    # Tq = 1, whole 64-key tiles of padding, q/k/v as strided views of one
    # [B, T, 3, H, dh] tensor
    (4, 70, 90, 2, 32, False, torch.bfloat16, "ragged"),
    (3, 70, 70, 4, 128, True, torch.bfloat16, "ragged"),
    (3, 1, 600, 2, 64, False, torch.bfloat16, "ragged"),
    (4, 101, 330, 2, 64, False, torch.bfloat16, "padded_tiles"),
    (4, 200, 200, 2, 64, True, torch.bfloat16, "packed"),
])
def test_flash_attention_kernel_matches_plain_version(b, tq, tk, h, dh,
                                                      causal, dtype, kind):
    """Ragged key lengths with a length-0 row (zeros, lse -1e30): float32
    within atol 1e-5 / rtol 1e-4, bfloat16 within 2e-2; lse within 1e-4.
    Then the backward kernels and the autograd Function. kind
    "padded_tiles": rows of 1 and 64 valid keys of 330, so whole key tiles
    are padding; "packed": q, k, v are views of one [B, T, 3, H, dh]
    tensor, which the wgmma kernels read where they lie."""
    from tpu_asr_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_delta,
        flash_attention_fwd, flash_attention_reference, tma_ready)
    _need_card()
    rng = np.random.default_rng(b + tq + tk)
    if kind == "packed":
        qkv = torch.from_numpy(rng.standard_normal((b, tq, 3, h, dh)).astype(
            np.float32)).cuda().to(dtype)
        q, k, v = qkv.unbind(2)
        assert all(tma_ready(x) for x in (q, k, v))
    else:
        q = torch.from_numpy(rng.standard_normal((b, tq, h, dh)).astype(
            np.float32)).cuda().to(dtype)
        k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, dh)).astype(
            np.float32)).cuda().to(dtype) for _ in range(2))
    if kind == "padded_tiles":
        lens = torch.tensor([tk, 1, 64, 0][:b]).cuda()
    else:
        lens = torch.from_numpy(rng.integers(1, tk + 1, b)).cuda()
        lens[0], lens[-1] = tk, 0
    valid = torch.arange(tk, device="cuda")[None, :] < lens[:, None]
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, valid, causal)
    w_out, w_lse = flash_attention_reference(q, k, v, valid, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    tol = (dict(atol=1e-5, rtol=1e-4) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               w_out.float().cpu().numpy(), **tol)
    _close(lse, w_lse, "lse", dict(atol=1e-4, rtol=1e-5))
    assert not out[-1].any() and (lse[-1] == -1e30).all()

    # the dq and dk/dv kernels against the plain backward, from the
    # forward kernel's out and lse: float32 within atol 1e-5 / rtol 1e-4,
    # bfloat16 within one bf16 ulp of the gradient's largest entry; a
    # length-0 row and a masked key get exactly 0
    dout = torch.from_numpy(rng.standard_normal((b, tq, h, dh)).astype(
        np.float32)).cuda().to(dtype)
    delta = flash_attention_delta(out, dout).contiguous()
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    got = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, valid, causal),
           *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, valid, causal))
    want = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid,
                                         causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _close_flash_grads(got, want, dtype)
    assert not got[0][-1].any()
    assert not got[1][~valid].any() and not got[2][~valid].any()

    # the Function: forward kernel, then both backward kernels, and the
    # plain backward's gradients
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    grads = torch.autograd.grad(
        (flash_attention(*xs, kv_valid=valid, causal=causal).float()
         * dout.float()).sum(), xs)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    _close_flash_grads(grads, want, dtype)


def _close_flash_grads(got, want, dtype):
    from tpu_asr_torch.ops.layernorm import bf16_ulp_error
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       err_msg=name, **GRAD_TOL)
        else:
            # one ulp of the largest |w|: ds and p are rounded to bf16 on
            # both sides, and a last-bit difference of the float32 scores
            # may flip such a rounding, moving a sum by an ulp of a term
            assert bf16_ulp_error(g, w, floor=1.0) <= 1.0, name


@pytest.mark.gpu
@pytest.mark.parametrize("b,tq,tk,h,dh,causal,kind", [
    (33, 238, 238, 8, 64, False, "ragged"),   # training's encoder self
    (4, 70, 90, 2, 32, False, "ragged"),      # dh 32: 64-byte swizzle
    (4, 90, 90, 2, 32, True, "ragged"),
    (3, 70, 70, 4, 128, True, "ragged"),      # dh 128: two panels of dq
    (3, 100, 190, 2, 128, False, "ragged"),
    (4, 101, 330, 2, 64, False, "padded_tiles"),
    (3, 1, 600, 2, 64, False, "ragged"),      # Tq = 1
    (3, 1, 700, 2, 128, False, "ragged"),
])
def test_flash_bwd_dq_wgmma_matches_plain_backward(b, tq, tk, h, dh, causal,
                                                   kind):
    """bf16 dq on the wgmma kernel (kernel_symbol names it) against the
    plain backward from the forward kernel's out and lse: within one bf16
    ulp of the gradient's largest entry; a length-0 row gets zeros; two
    calls give the same bits."""
    from tpu_asr_torch.ops.flash_attention import (
        flash_attention_bwd_dq, flash_attention_bwd_reference,
        flash_attention_delta, flash_attention_fwd, kernel_symbol)
    from tpu_asr_torch.ops.layernorm import bf16_ulp_error
    _need_card()
    assert kernel_symbol("dq", torch.bfloat16, dh) == \
        "flash_attention_bwd_dq_wgmma_kernel"
    rng = np.random.default_rng(b + tq + tk + dh)
    q, dout = (torch.from_numpy(rng.standard_normal((b, tq, h, dh)).astype(
        np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, tk, h, dh)).astype(
        np.float32)).cuda().to(torch.bfloat16) for _ in range(2))
    if kind == "padded_tiles":
        lens = torch.tensor([tk, 1, 64, 0][:b]).cuda()
    else:
        lens = torch.from_numpy(rng.integers(1, tk + 1, b)).cuda()
        lens[0], lens[-1] = tk, 0
    valid = torch.arange(tk, device="cuda")[None, :] < lens[:, None]
    out, lse = flash_attention_fwd(q, k, v, valid, causal)
    delta = flash_attention_delta(out, dout).contiguous()
    before = flash_attention_bwd_dq.launches
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, valid, causal)
    again = flash_attention_bwd_dq(q, k, v, dout, lse, delta, valid, causal)
    want = flash_attention_bwd_reference(q, k, v, out, dout, lse, valid,
                                         causal)[0]
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == before + 2
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert bf16_ulp_error(dq, want, floor=1.0) <= 1.0
    assert not dq[-1].any()
    assert torch.equal(dq.view(torch.int16), again.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dtype", [
    (0, 512, torch.bfloat16),      # no rows: dgamma, dbeta are zeros
    (1, 64, torch.float32), (1, 64, torch.bfloat16),
    (7854, 512, torch.bfloat16),   # training's encoder LN, [33, 238, 512]
    (8080, 512, torch.bfloat16), (8080, 512, torch.float32),
    (513, 96, torch.bfloat16),     # D / 32 = 3: one element a load
    (1000, 544, torch.bfloat16),   # D / 32 = 17: read twice, VEC 1
    (700, 1024, torch.bfloat16),   # read twice, 16-byte loads
    (7, 2048, torch.bfloat16), (33, 2048, torch.float32),
])
def test_layer_norm_residual_bwd_kernel(rows, d, dtype):
    """The backward kernel alone: one launch gives dx within one bf16 ulp
    (float32: atol 1e-5 / rtol 1e-4) and dgamma, dbeta within 1e-5 of
    their largest magnitude of the plain backward; two calls give the same
    bits; inputs that do not start on a 16-byte boundary are read too."""
    from tpu_asr_torch.ops.layernorm import (
        layer_norm_residual_bwd, layer_norm_residual_bwd_reference,
        layer_norm_residual_fwd)
    _need_card()
    rng = np.random.default_rng(rows + d)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
    r, h, dy = (rand(rows, d).to(dtype) for _ in range(3))
    g, b = 1 + 0.5 * rand(d), rand(d)
    _, mean, rstd = layer_norm_residual_fwd(r, h, g, b)
    before = layer_norm_residual_bwd.launches
    got = layer_norm_residual_bwd(r, h, g, mean, rstd, dy)
    again = layer_norm_residual_bwd(r, h, g, mean, rstd, dy)
    want = layer_norm_residual_bwd_reference(r, h, g, mean, rstd, dy)
    torch.cuda.synchronize()
    assert layer_norm_residual_bwd.launches == before + 2
    if rows == 0:
        assert not got[1].any() and not got[2].any()
    else:
        _close_ln_grads(got, want, dtype)
    for x, y in zip(got, again):
        assert torch.equal(x, y)

    # the same rows one element past a 16-byte boundary
    flat = torch.empty(rows * d + 1, dtype=dtype, device="cuda")
    shifted = flat[1:].view(rows, d)
    shifted.copy_(r)
    got = layer_norm_residual_bwd(shifted, h, g, mean, rstd, dy)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def _lm_fusion_decode(device, mode, use_pallas, lm_weight):
    """hybrid_dev (vocab 64, float32) with a seeded small LM, one wav
    batch with a length-0 row -> (n-best, launches of the path's kernels
    in the decode). attn_rescore takes beam 8 (4 x 8 x 24 = 768 decoder
    rows: the LN kernel runs), the others beam 4."""
    beam = 8 if mode == "attn_rescore" else 4
    import dataclasses

    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops import flash_attention as fa
    from tpu_asr_torch.ops import layernorm as ln
    from tpu_asr_torch.weights import init_random

    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=64,
                              use_pallas=use_pallas)
    lm_cfg = LMConfig(vocab_size=64, d_model=32, d_inner=64, num_heads=2,
                      num_layers=2, dropout=0.0)
    rec = Recognizer(cfg, init_random(Transformer(cfg), 0), mode=mode,
                     device=device, lm_cfg=lm_cfg,
                     lm=init_random(TransformerLM(lm_cfg), 1),
                     beam=BeamConfig(beam=beam, max_len=3 * beam,
                                     ctc_weight=0.3 if mode in (
                                         "joint", "attn_rescore") else 0.0,
                                     nbest=beam, lm_weight=lm_weight))
    rng = np.random.default_rng(0)
    lens = np.array([16000, 12000, 7000, 0], np.int32)
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / 16000.0
        wav[i, :n] = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) \
            + 0.05 * rng.standard_normal(n)
    wrappers = (ctc_prefix_scan, fa.flash_attention_fwd,
                ln.layer_norm_residual_fwd)
    before = [w.launches for w in wrappers]
    out = rec.decode_batch_nbest({"wav": wav, "wav_lengths": lens})
    return out, [w.launches - b for w, b in zip(wrappers, before)]


@pytest.fixture
def no_tf32():
    """float32 products in full float32 on the card (as chip_smoke.py
    runs), restored after the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.gpu
@pytest.mark.parametrize("mode,use_pallas,lm_weight", [
    ("joint", False, 0.3), ("beam", False, 0.5), ("ctc_beam", False, 0.1),
    ("attn_rescore", True, 0.3)])
def test_lm_fusion_on_the_card_equals_the_cpu(mode, use_pallas, lm_weight,
                                              no_tf32):
    """LM shallow fusion (joint, beam, ctc_beam) and LM rescoring
    (attn_rescore with use_pallas) decode to the CPU's tokens, scores
    within 1e-3; the card ran the path's kernels, the CPU none."""
    _need_card()
    got, card = _lm_fusion_decode("cuda", mode, use_pallas, lm_weight)
    want, cpu = _lm_fusion_decode("cpu", mode, use_pallas, lm_weight)
    for g, w in zip(got, want):
        for hg, hw in zip(g, w):
            assert hg["yseq"] == hw["yseq"]
            assert abs(hg["score"] - hw["score"]) <= 1e-3
    assert cpu == [0, 0, 0]
    if mode == "joint":
        assert card[0] > 0
    if mode == "attn_rescore":
        assert card[1] > 0 and card[2] > 0


@pytest.mark.gpu
def test_lm_steps_on_the_card_equal_teacher_forced(no_tf32):
    """The LM's cached step_at on the card against its own teacher-forced
    pass, atol 1e-5."""
    _need_card()
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.weights import init_random
    lm = init_random(TransformerLM(LMConfig(vocab_size=4233)), 0).cuda()
    ys = torch.from_numpy(np.random.default_rng(2).integers(
        0, 4233, (6, 9))).cuda()
    with torch.no_grad():
        full = lm(ys)
        cache = lm.init_cache(6, 9, device="cuda")
        for pos in range(9):
            at, cache = lm.step_at(ys[:, pos],
                                   torch.full((6,), pos, device="cuda"),
                                   cache)
            torch.testing.assert_close(at, full[:, pos], atol=1e-5,
                                       rtol=0)


@pytest.mark.gpu
def test_transducer_loss_on_the_card_equals_the_cpu(no_tf32):
    """The RNN-T loss (chunked, checkpointed joint and the lattice) at a
    training shape, forward and backward, on the card against the CPU:
    NLL rtol 1e-5 / atol 1e-4, gradients rtol 1e-4 / atol 1e-5."""
    _need_card()
    from tpu_asr_torch.ops.transducer import transducer_loss
    rng = np.random.default_rng(3)
    b, t, u1, h, v = 6, 60, 13, 64, 300
    f, g = (rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h), (b, u1, h)))
    w = (0.3 * rng.standard_normal((h, v))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u1 - 1))
    tl = np.array([60, 57, 31, 0, 12, 44])
    ul = np.array([12, 9, 5, 3, 0, 12])
    out = {}
    for dev in ("cuda", "cpu"):
        xs = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (f, g, w, bias)]
        nll = transducer_loss(*xs, *(torch.tensor(a, device=dev) for a in
                                     (labels, tl, ul)), reduction="none")
        out[dev] = [nll] + list(torch.autograd.grad(nll.sum(), xs))
    _close(out["cuda"][0].detach(), out["cpu"][0].detach(), "nll")
    for name, got, want in zip("fgwb", out["cuda"][1:], out["cpu"][1:]):
        _close(got, want, name, GRAD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("weight", [0.0, 4.0])
def test_pitch_on_the_card_equals_the_cpu_under_the_margin_rule(weight,
                                                                no_tf32):
    """Pitch of a ragged batch (tones, noise, a vibrato) on the card
    against the CPU under chip_smoke.py's compare_pitch (its stated
    tolerances), with per-frame picks and with the Viterbi track."""
    _need_card()
    import importlib.util
    import os
    from tpu_asr_torch.frontend import FrontendConfig
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(5)
    t = np.arange(16000) / 16000
    f0 = 200.0 + 20.0 * np.sin(2 * np.pi * 6.0 * t)
    wav = np.stack([np.sin(2 * np.pi * 220.0 * t), rng.standard_normal(16000),
                    np.sin(2 * np.pi * np.cumsum(f0) / 16000)]).astype(
        np.float32)
    lens = np.array([16000, 11000, 6000], np.int32)
    wav[np.arange(16000)[None, :] >= lens[:, None]] = 0.0
    cfg = FrontendConfig(add_pitch=True, pitch_smooth_weight=weight)
    card = chip_smoke.pitch_run(wav, lens, cfg, "cuda")
    cpu = chip_smoke.pitch_run(wav, lens, cfg, "cpu")
    out = chip_smoke.compare_pitch("card vs CPU", cpu, card,
                                   cpu["frame_lengths"], cfg)
    assert out["valid_frames"] == 98 + 67 + 36


@pytest.mark.gpu
def test_viterbi_alignment_on_the_card_equals_the_cpu():
    """ctc_viterbi_align's max-product recursion on the card gives the
    CPU's spans bit for bit (max and add are exact), ties included."""
    _need_card()
    from tpu_asr_torch.ops.ctc import ctc_viterbi_align
    rng = np.random.default_rng(6)
    for quantize in (False, True):
        x = rng.standard_normal((5, 120, 40)).astype(np.float32)
        if quantize:
            x = np.round(x * 2) / 4
        labels = torch.from_numpy(rng.integers(1, 40, (5, 20)))
        tl = torch.tensor([120, 97, 40, 0, 64])
        ul = torch.tensor([20, 14, 11, 3, 0])
        got = ctc_viterbi_align(torch.from_numpy(x).cuda(), labels.cuda(),
                                tl.cuda(), ul.cuda(), log_input=quantize)
        want = ctc_viterbi_align(torch.from_numpy(x), labels, tl, ul,
                                 log_input=quantize)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("branch,batch,kw", [
    ("joint one-pass", 4, dict(ctc_weight=0.3, ctc_two_pass=False)),
    ("joint two-pass", 4, dict(ctc_weight=0.3, ctc_two_pass=True)),
    ("beam", 4, dict()),
    ("LM-fused joint", 4, dict(ctc_weight=0.3, lm_weight=0.4)),
    ("beam over 512 rows (the fused LN kernel)", 128, dict(beam=4))])
def test_graphed_beam_equals_the_eager_static_beam(branch, batch, kw,
                                                   no_tf32):
    """The beam step replayed from its CUDA graph against the same static
    step run eagerly, on hybrid_dev in bf16 with use_pallas: tokens,
    lengths, scores and steps equal bit for bit, over a batch shape, a
    smaller one and the first again, then a larger one and the smallest
    again. Each shape is captured once (its first step runs eagerly), the
    smaller views the front of the larger's buffers, a larger shape
    regrows them and drops the graphs (captured anew when next used), and
    the kernels count one launch a step that ran."""
    _need_card()
    import dataclasses

    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import (BeamConfig, BeamGraphs,
                                           attention_beam_search)
    from tpu_asr_torch.models.lm import LMConfig, TransformerLM
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.ops import layernorm as ln
    from tpu_asr_torch.weights import cast_for_inference, init_random

    v = 64
    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=v,
                              use_pallas=True, dtype=torch.bfloat16)
    model = cast_for_inference(
        init_random(Transformer(cfg), 0).cuda().eval(), cfg.dtype)
    lm = None
    if "lm_weight" in kw:
        lm_cfg = LMConfig(vocab_size=v, d_model=32, d_inner=64, num_heads=2,
                          num_layers=2, dropout=0.0)
        lm = init_random(TransformerLM(lm_cfg), 1).cuda().eval()
    beam = BeamConfig(**dict(dict(beam=5, max_len=12), **kw))
    graphs = BeamGraphs()
    gen = torch.Generator().manual_seed(7)
    per_step = {"ctc_prefix_scan": 0, "layer_norm_residual_fwd": 0}
    if beam.ctc_weight > 0:
        per_step["ctc_prefix_scan"] = 2 if beam.ctc_two_pass else 1
    if batch * beam.beam >= 512:
        per_step["layer_norm_residual_fwd"] = 3 * cfg.num_dec_layers
    counters = {"ctc_prefix_scan": ctc_prefix_scan,
                "layer_norm_residual_fwd": ln.layer_norm_residual_fwd}
    # (T', captures after it, whether its first step ran eagerly): a
    # shape, a smaller one viewing the front of its buffers, the first
    # again; then a larger one, which regrows the buffers and drops both
    # graphs, and the smallest again, captured anew in a new pool
    visits = ((30, 1, True), (20, 2, True), (30, 2, False), (40, 3, True),
              (20, 4, True))
    ptrs = []
    for t, captures, eager_first in visits:
        enc = torch.randn((batch, t, cfg.d_model), generator=gen).to(
            "cuda", cfg.dtype)
        lens = torch.randint(t // 2, t + 1, (batch,), generator=gen).cuda()
        logp = torch.log_softmax(
            3.0 * torch.randn((batch, t, v), generator=gen), -1).cuda()
        with torch.inference_mode():
            want = attention_beam_search(model.decoder, enc, lens, v - 2,
                                         v - 1, beam, ctc_logp=logp, lm=lm)
            before = {k: c.launches for k, c in counters.items()}
            got = attention_beam_search(model.decoder, enc, lens, v - 2,
                                        v - 1, beam, ctc_logp=logp, lm=lm,
                                        graphs=graphs)
            torch.cuda.synchronize()
        steps = got["steps"]
        assert steps == want["steps"] > 2, branch
        for k in ("tokens", "lengths", "scores"):
            assert torch.equal(got[k], want[k]), (branch, t, k)
        assert got["graph_steps"] == steps - eager_first
        assert graphs.captures == captures
        assert {k: c.launches - before[k] for k, c in counters.items()} == \
            {k: n * steps for k, n in per_step.items()}
        entry = next(e for e in graphs._shapes.values()
                     if e.search.cross_kv["k"].shape[2] == t)
        ptrs.append(entry.search.cross_kv["k"].data_ptr())
    assert ptrs[0] == ptrs[1] == ptrs[2] and ptrs[3] == ptrs[4]
    assert len(graphs._shapes) == 2


@pytest.mark.gpu
def test_graphed_whisper_beam_equals_the_eager_static_beam(no_tf32):
    """whisper_dev in bf16 with use_pallas (the encoder on the flash
    kernel): the Recognizer's graphed beam (the prompt and the step each a
    replayed CUDA graph) against the same static search run eagerly, on
    the frontend's windows of a wav batch: tokens, lengths, scores and
    steps equal bit for bit; two graphs captured for the shape, every
    step after the first replayed."""
    _need_card()
    import dataclasses

    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
    from tpu_asr_torch.decode.recognizer import Recognizer
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random

    preset = get_preset("whisper_dev")
    cfg = dataclasses.replace(preset.model, use_pallas=True,
                              dtype=torch.bfloat16)
    beam = BeamConfig(beam=5, max_len=12, maxlenratio=0.25)
    rec = Recognizer(cfg, init_random(build_model(cfg), 0), beam=beam,
                     mode="beam", frontend=preset.frontend, device="cuda")
    rng = np.random.default_rng(4)
    lens = np.array([16000, 11000, 6000, 0])
    wav = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = rng.standard_normal(n) * 0.1
    batch = {"wav": wav, "wav_lengths": lens}
    with torch.inference_mode():
        feats, flens = rec._features(batch)
        enc, el, _ = rec._encode(feats, flens)
        want = attention_beam_search(rec.model.decoder, enc, el, cfg.sos_id,
                                     cfg.eos_id, beam, prompt=cfg.prompt_ids)
        for visit in range(2):
            got = attention_beam_search(
                rec.model.decoder, enc, el, cfg.sos_id, cfg.eos_id, beam,
                graphs=rec.beam_graphs, prompt=cfg.prompt_ids)
            torch.cuda.synchronize()
            assert got["steps"] == want["steps"] > 2
            assert got["graph_steps"] == got["steps"] - (visit == 0)
            for k in ("tokens", "lengths", "scores"):
                assert torch.equal(got[k], want[k]), (visit, k)
    assert rec.graph_captures == 2
    served = rec.decode_batch_nbest(batch)
    assert [h[0]["yseq"] for h in served[:3]] == [
        [t for t in want["tokens"][i, 0, :want["lengths"][i, 0]].tolist()
         if t != cfg.eos_id] for i in range(3)]


@pytest.mark.gpu
def test_whisper_large_v3_cached_decode_matches_the_reference(no_tf32):
    """Whisper large-v3 at its published widths, on the benchmark's seeded
    weights and wavs of its serving traffic (the shortest, a median and
    the longest of the pool): the port in bf16 (its frontend, the
    encoder on the flash kernel, the prompt's positions and then cached
    step_at, two beams an utterance against its one cross K/V row)
    against the plain reference's full forward in float32 (TF32 off), on
    log-probabilities at every position. WHISPER_LOGP_BOUND is the
    largest gap that bf16 may leave; the reference computed with float8
    operands misses it."""
    _need_card()
    from benchmark import harness, traffic
    from tpu_asr_torch.frontend import wav_to_features
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import cast_for_inference

    cell = harness.Cell("whisper_lv3_serve_beam5_c64")
    drv, ref = cell.driver, cell.reference
    seed, dev = 2 ** 31 + 5, torch.device("cuda")
    cfg = drv.program_config(cell.config["model"])
    fe = drv.frontend_config(cell.config["frontend"])
    weights = drv.serve.weights_for(cell, seed, dev)
    with dev:
        model = build_model(cfg)
    model.load_state_dict(weights, strict=True)
    model = cast_for_inference(model.eval(), cfg.dtype)
    requests = traffic.make_requests(cell.traffic, seed, dev)
    order = np.argsort(requests.samples)
    picks = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]
    lens = torch.tensor([len(requests.wavs[i]) for i in picks])
    wav = torch.zeros((3, int(lens.max())))
    for r, i in enumerate(picks):
        wav[r, :lens[r]] = torch.from_numpy(requests.wavs[i])
    beams, u = 2, 16
    g = torch.Generator().manual_seed(seed)
    body = torch.randint(0, cfg.eot, (3 * beams, u - 4), generator=g)
    ys = torch.cat([torch.tensor(cfg.sot_sequence).expand(3 * beams, -1),
                    body], 1).to(dev)
    dec = model.decoder
    with torch.inference_mode():
        feats, flens = wav_to_features(wav.to(dev), lens.to(dev), fe)
        enc, elens = model.encode(feats, flens)
        cross = {k: torch.empty(dec.cross_kv_shape(3, enc.shape[1]),
                                dtype=cfg.dtype, device=dev)
                 for k in ("k", "v")}
        dec.write_cross_kv(enc, cross)
        cache = dec.init_cache(3 * beams, u, dev)
        got = []
        for i in range(u):
            pos = torch.tensor([i], device=dev)
            logits, cache = dec.step_at(ys[:, i], pos, cache, cross, elens,
                                        beams=beams)
            got.append(torch.log_softmax(logits.float(), -1))
        got = torch.stack(got, 1)
        off = ref.Dropout(0.0, torch.float32, False)
        gaps = {}
        for kind in ("f32", "fp8"):
            m = ref.Model(cell.config["model"], weights, ref.Precision(kind),
                          off)
            want = []
            for r, i in enumerate(picks):
                x, _ = ref.log_mel(torch.from_numpy(requests.wavs[i]).to(dev),
                                   cell.config["frontend"])
                xa = m.encode(x[None])
                want.append(torch.log_softmax(m.decode(
                    ys[beams * r: beams * r + beams], m.cross_kv(xa)), -1))
            want = torch.cat(want)
            if kind == "f32":
                base = want
                gaps["bf16"] = float((got - want).abs().max())
            else:
                gaps["fp8"] = float((want - base).abs().max())
    print(f"\nlarge-v3 log-prob gaps against float32: {gaps}")
    assert gaps["bf16"] <= WHISPER_LOGP_BOUND < gaps["fp8"], gaps


# the largest log-probability gap that bf16 may leave at large-v3's
# widths (the test above): bf16 read 0.078 and float8 operands 0.587 on
# the card (H100, seed 2**31 + 5), so the bound sits between them with
# more than twice the room on either side
WHISPER_LOGP_BOUND = 0.2
