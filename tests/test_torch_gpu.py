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
