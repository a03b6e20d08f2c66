"""Port CIF ops (tpu_asr_torch.ops.cif, ops.cif_fire) vs tpu_asr.ops.cif
and the Pallas kernel's interpret mode on the CPU, from the same seeded
numpy inputs.

Tolerances: atol 1e-5, rtol 1e-5 (float32 on both sides; cumsum and the
product sum in another order). Against the sequential oracles, which
accumulate frame by frame in another order than the cumsum, rtol 1e-4 as
the reference's own test (tests/unit/test_cif.py) holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops import cif as jcif
from tpu_asr.ops.pallas.cif import cif_fire_pallas
from tpu_asr.parity.torch_twin_cif import sequential_fire
from tpu_asr_torch.ops import cif as tcif
from tpu_asr_torch.ops.cif_fire import (CifFire, cif_fire_fwd,
                                        cif_fire_kernel)

TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-3      # fire_count's inputs stay this far from a rounding edge


def _case(name, seed=0):
    """(alphas [B, T], valid [B, T], u_max): the ragged cases the kernel
    must handle."""
    rng = np.random.default_rng(seed)
    if name == "sigmoid":                   # raw assigner-like alphas
        a = rng.uniform(0.0, 0.9, (3, 40))
        lens, u_max = [40, 31, 17], 30
    elif name == "above_one":               # a frame feeds several outputs
        a = rng.uniform(0.0, 3.0, (2, 12))
        lens, u_max = [12, 9], 30
    elif name == "zero_rows":               # the loader's dummy rows
        a = rng.uniform(0.0, 0.9, (3, 20))
        lens, u_max = [20, 0, 0], 12
    elif name == "beyond_fires":            # u_max past the last fire
        a = rng.uniform(0.0, 0.3, (2, 16))
        lens, u_max = [16, 10], 25
    elif name == "t1":
        a = rng.uniform(0.2, 2.5, (3, 1))
        lens, u_max = [1, 1, 0], 4
    elif name == "u1":
        a = rng.uniform(0.0, 0.9, (2, 20))
        lens, u_max = [20, 5], 1
    elif name == "scaled":                  # scale_alphas to U fires
        a = rng.uniform(0.0, 0.9, (3, 40))
        a *= np.array([[9.0], [5.0], [1.0]]) / a.sum(1, keepdims=True)
        lens, u_max = [40, 40, 40], 10
    elif name == "disordered":              # c - alpha out of order
        a = rng.uniform(0.0, 0.9, (12, 150))
        for r in range(a.shape[0]):
            # the cumsum reaches 16, 32 or 64 exactly on halves; alphas of
            # 1e-10 leave c and c - alpha there; the next alpha's c - alpha
            # rounds one ulp below it in about a quarter of the rows
            k = 2 * (16, 32, 64)[r % 3]
            a[r, :k] = 0.5
            a[r, k:k + 10] = 1e-10
        lens, u_max = [150] * 12, 130
    else:
        raise KeyError(name)
    valid = np.arange(a.shape[1])[None, :] < np.asarray(lens)[:, None]
    return (np.where(valid, a, 0.0).astype(np.float32), valid, u_max)


CASES = ["sigmoid", "above_one", "zero_rows", "beyond_fires", "t1", "u1"]


def _hidden(b, t, d, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, d)).astype(np.float32)


@pytest.mark.parametrize("name", CASES)
def test_cif_weights_match(name):
    a, _, u_max = _case(name)
    want = np.asarray(jcif.cif_weights(jnp.asarray(a), u_max))
    got = tcif.cif_weights(torch.from_numpy(a), u_max).numpy()
    assert got.shape == want.shape == (a.shape[0], a.shape[1], u_max)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", CASES)
def test_cif_fire_matches(name):
    a, _, u_max = _case(name)
    h = _hidden(a.shape[0], a.shape[1], 16)
    want = np.asarray(jcif.cif_fire(jnp.asarray(h), jnp.asarray(a), u_max))
    got = tcif.cif_fire(torch.from_numpy(h), torch.from_numpy(a),
                        u_max).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "zero_rows":
        assert not got[1:].any()
    if name == "beyond_fires":              # outputs past the fires are 0
        n = int(np.ceil(a.sum(1).max()))
        assert not got[:, n:].any()


def test_plain_matches_pallas_interpret():
    """cif_fire_pallas in interpret mode (the TPU kernel's own body)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 40, 16)).astype(np.float32)
    a = rng.uniform(0.0, 0.9, (2, 40)).astype(np.float32)
    want = np.asarray(cif_fire_pallas(jnp.asarray(h), jnp.asarray(a), 12,
                                      True))
    got = tcif.cif_fire(torch.from_numpy(h), torch.from_numpy(a), 12).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_matches_sequential_oracles():
    """The sequential accumulate-and-fire loops: tpu_asr's lax.scan and
    the parity package's torch loop; complete fires, then the partial
    tail in slot n."""
    rng = np.random.default_rng(4)
    t, d = 40, 8
    h = rng.standard_normal((t, d)).astype(np.float32)
    a = rng.uniform(0.0, 0.9, (t,)).astype(np.float32)
    fired, n, _, tail = jcif.cif_scan_reference(jnp.asarray(h),
                                                jnp.asarray(a))
    n = int(n)
    assert n == int(np.floor(a.sum())) and n + 1 < t
    got = tcif.cif_fire(torch.from_numpy(h)[None], torch.from_numpy(a)[None],
                        t)[0].numpy()
    np.testing.assert_allclose(got[:n], np.asarray(fired)[:n], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[n], np.asarray(tail), rtol=1e-3,
                               atol=1e-4)
    twin = sequential_fire(torch.from_numpy(h)[None],
                           torch.from_numpy(a)[None], t)[0].numpy()
    np.testing.assert_allclose(got[:n + 1], twin[:n + 1], rtol=1e-4,
                               atol=1e-4)
    assert not got[n + 1:].any()


@pytest.mark.parametrize("name", ["sigmoid", "above_one", "zero_rows"])
def test_scale_alphas_matches(name):
    a, valid, _ = _case(name)
    u = np.array([7, 3, 0][:a.shape[0]], np.int32)
    want = np.asarray(jcif.scale_alphas(jnp.asarray(a), jnp.asarray(valid),
                                        jnp.asarray(u)))
    got = tcif.scale_alphas(torch.from_numpy(a), torch.from_numpy(valid),
                            torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(1), np.where(a.sum(1) > 0, u, 0),
                               rtol=1e-5)


@pytest.mark.parametrize("with_row_valid", [False, True])
def test_quantity_loss_matches(with_row_valid):
    a, valid, _ = _case("zero_rows")
    u = np.array([9, 4, 1], np.int32)
    row_valid = np.array([True, True, False])
    rv = (jnp.asarray(row_valid), torch.from_numpy(row_valid)) \
        if with_row_valid else (None, None)
    want = float(jcif.quantity_loss(jnp.asarray(a), jnp.asarray(valid),
                                    jnp.asarray(u), row_valid=rv[0]))
    got = float(tcif.quantity_loss(torch.from_numpy(a),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(u), row_valid=rv[1]))
    np.testing.assert_allclose(got, want, **TOL)
    per = np.abs(a.sum(1) - u)
    expect = per[:2].mean() if with_row_valid else per.mean()
    np.testing.assert_allclose(got, expect, rtol=1e-5)


@pytest.mark.parametrize("name", ["sigmoid", "above_one", "beyond_fires",
                                  "t1", "u1"])
def test_fire_count_matches(name):
    """floor(sum a) and the 0.5 tail: inputs whose sums sit within MARGIN
    of an integer or of an integer + 0.5 are pushed off it first, so a
    one-ulp difference in the summation order cannot flip a fire."""
    a, valid, _ = _case(name)
    total = a.sum(1, dtype=np.float64)
    frac = np.mod(total, 0.5)
    near = np.minimum(frac, 0.5 - frac) < MARGIN
    a[near, 0] += np.float32(2 * MARGIN)
    frac = np.mod(a.sum(1, dtype=np.float64), 0.5)
    assert (np.minimum(frac, 0.5 - frac) >= MARGIN / 2).all()
    a = np.where(valid, a, 0.0).astype(np.float32)
    want = np.asarray(jcif.fire_count(jnp.asarray(a), jnp.asarray(valid)))
    got = tcif.fire_count(torch.from_numpy(a), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _kernel_frames(alphas, u_max):
    """The frames csrc/cif_fire.cu lets weigh on each output (may_weigh),
    in its float32 arithmetic: frame t for output u iff c_prev[t] < c[t]
    and floor(c_prev[t]) <= u <= ceil(c[t]) - 1, with c = cumsum(alphas)
    and c_prev = c - alphas, each frame's own. -> bool [B, T, u_max]."""
    c = torch.cumsum(alphas, dim=-1)
    c_prev = c - alphas
    u = torch.arange(u_max, dtype=torch.float32)
    return ((c_prev < c)[..., None]
            & (torch.floor(c_prev)[..., None] <= u)
            & (u <= torch.ceil(c)[..., None] - 1.0))


def _searched_frames(alphas, u_max):
    """A rule that binary-searches c_prev as if it were sorted: output u
    runs from the last frame whose c_prev <= u to the last whose c_prev <
    u + 1. Right for sorted c_prev, wrong for its last-ulp disorder."""
    c_prev = torch.cumsum(alphas, dim=-1) - alphas
    b, t = alphas.shape
    u = torch.arange(u_max, dtype=torch.float32).expand(b, u_max)
    first = torch.searchsorted(c_prev, u.contiguous(), right=True) - 1
    last = torch.searchsorted(c_prev, (u + 1.0).contiguous()) - 1
    frame = torch.arange(t)[None, :, None]
    return (frame >= first[:, None, :]) & (frame <= last[:, None, :])


@pytest.mark.parametrize("name", ["sigmoid", "scaled", "above_one",
                                  "beyond_fires", "zero_rows", "t1", "u1",
                                  "disordered"])
def test_kernel_frame_rule_keeps_every_weight(name):
    """Every non-zero of cif_weights lies among the frames the CIF fire
    kernel's per-frame rule lets weigh on its output, so the kernel, which
    sums only over those frames, loses no weight. On the disordered alphas
    (c - alpha out of order in its last ulp) a rule that binary-searches
    c_prev loses some: this case separates the two."""
    a, _, u_max = _case(name)
    alphas = torch.from_numpy(a)
    nonzero = tcif.cif_weights(alphas, u_max) != 0
    assert nonzero.any() or name == "zero_rows"
    assert not (nonzero & ~_kernel_frames(alphas, u_max)).any()
    if name == "disordered":
        assert (nonzero & ~_searched_frames(alphas, u_max)).any()


def test_fire_count_tail_rounding():
    valid = torch.ones((2, 4), dtype=torch.bool)
    a = torch.tensor([[1.0, 1.0, 0.3, 0.0], [1.0, 1.0, 0.6, 0.0]])
    assert tcif.fire_count(a, valid).tolist() == [2, 3]


def _grads_against_pallas(fire, name):
    """d/d(hidden, alphas) of sum(fired**2) through `fire` against jax.grad
    of cif_fire_pallas (interpret mode), whose backward is the XLA
    reference formulation. The alpha gradient is a reverse cumsum over
    frames (each entry sums every later frame's term), so its rounding
    error scales with its largest entry: atol 1e-5 of that."""
    a, _, u_max = _case(name, seed=5)
    h = _hidden(a.shape[0], a.shape[1], 8, seed=6)
    gh, ga = jax.grad(
        lambda x, y: jnp.sum(cif_fire_pallas(x, y, u_max, True) ** 2),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(a))
    th = torch.from_numpy(h).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True)
    (fire(th, ta, u_max) ** 2).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(ga)).max())


@pytest.mark.parametrize("name", ["sigmoid", "above_one", "zero_rows"])
def test_autograd_function_grads_match_pallas(name):
    """The port's CifFire (the kernel's forward on the card, the plain
    backward recomputed)."""
    _grads_against_pallas(CifFire.apply, name)


@pytest.mark.parametrize("name", ["sigmoid", "above_one", "zero_rows"])
def test_dispatcher_grads_on_cpu_match_pallas(name):
    """cif_fire_kernel on CPU tensors: the plain version, native autograd."""
    _grads_against_pallas(cif_fire_kernel, name)


def test_dispatcher_on_cpu_runs_the_plain_version():
    """CPU tensors run the plain version (no launch counted); a device
    that has no kernel raises instead of falling back."""
    a, _, u_max = _case("sigmoid")
    h = torch.from_numpy(_hidden(a.shape[0], a.shape[1], 16))
    before = cif_fire_fwd.launches
    got = cif_fire_kernel(h, torch.from_numpy(a), u_max)
    assert cif_fire_fwd.launches == before
    assert torch.equal(got, tcif.cif_fire(h, torch.from_numpy(a), u_max))
    with pytest.raises(ValueError):
        cif_fire_fwd(h.to("meta"), torch.from_numpy(a).to("meta"), u_max)


def test_full_fp32_matmul_restores_the_setting():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with tcif.full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
