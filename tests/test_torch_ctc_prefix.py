"""Port CTC prefix scorer (plain scan on the CPU) vs
tpu_asr.decode.ctc_prefix.CTCPrefixScorer(use_pallas=False).

The CUDA kernel is held against the plain version on the card by
chip_smoke.py and tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode.ctc_prefix import CTCPrefixScorer as JaxScorer
from tpu_asr_torch.decode.ctc_prefix import CTCPrefixScorer
from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                          ctc_prefix_scan_reference)

# entries at NEG_INF (-1e30) differ between implementations by float ulps
# of 1e30; clip both, as the reference's own kernel tests do
CLIP = -1e31
TOL = dict(rtol=1e-5, atol=1e-4)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.clip(np.asarray(got), CLIP, None),
                               np.clip(np.asarray(want), CLIP, None),
                               err_msg=what, **TOL)


def _inputs(rng, b, w, t, v, k):
    n = b * w
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((b, t, v)).astype(np.float32)), -1))
    lens = rng.integers(1, t + 1, (b,)).astype(np.int32)
    lens_flat = np.repeat(lens, w)
    cands = rng.integers(1, v, (n, k)).astype(np.int32)
    y_last = rng.integers(1, v, (n,)).astype(np.int32)
    cands[:, 0] = y_last           # repeated symbol: exercises the phi mask
    return logp, lens_flat, cands, y_last


def _scorers(logp, lens, w, eos=None):
    js = JaxScorer(jnp.asarray(logp), jnp.asarray(lens), blank=0, eos=eos,
                   use_pallas=False, beams=w)
    ts = CTCPrefixScorer(torch.from_numpy(logp), torch.from_numpy(lens),
                         blank=0, eos=eos, beams=w)
    return js, ts


@pytest.mark.parametrize("n,t,k", [(4, 15, 5), (13, 9, 21), (3, 7, 11),
                                   (2, 5, 130)])
@pytest.mark.parametrize("return_r", [True, False])
def test_score_matches_jax(n, t, k, return_r):
    rng = np.random.default_rng(n * 100 + t)
    v = 140 if k > 100 else 40
    logp, lens, cands, y_last = _inputs(rng, n, 1, t, v, k)
    js, ts = _scorers(logp, lens, 1)
    for first in (True, False):
        jpsi, jr = js.score(jnp.asarray(cands), jnp.asarray(y_last),
                            jnp.full((n,), first), js.init_state(),
                            return_r=return_r)
        tpsi, tr = ts.score(torch.from_numpy(cands).long(),
                            torch.from_numpy(y_last).long(),
                            torch.full((n,), first), ts.init_state(),
                            return_r=return_r)
        _close(tpsi, jpsi, f"psi first={first}")
        if return_r:
            assert tuple(tr.shape) == (n, k, t, 2)
            _close(tr, jr, f"r first={first}")
        else:
            assert tr is None and jr is None


def test_beams_fold_into_candidates():
    """W beams per utterance share one [B, T, V] logp (N = B*W)."""
    rng = np.random.default_rng(7)
    b, w, t, v, k = 3, 4, 11, 30, 6
    logp, lens, cands, y_last = _inputs(rng, b, w, t, v, k)
    js, ts = _scorers(logp, lens, w, eos=v - 1)
    cands[:, -1] = v - 1                                   # eos candidate
    jst, tst = js.init_state(), ts.init_state()
    _close(tst[0], jst[0], "init r")
    jpsi, jr = js.score(jnp.asarray(cands), jnp.asarray(y_last),
                        jnp.full((b * w,), False), jst)
    tpsi, tr = ts.score(torch.from_numpy(cands).long(),
                        torch.from_numpy(y_last).long(),
                        torch.full((b * w,), False), tst)
    _close(tpsi, jpsi, "psi")
    _close(tr, jr, "r")


@pytest.mark.parametrize("b", [1, 2])
def test_scan_inputs_are_contiguous(monkeypatch, b):
    """The scorer hands the kernel contiguous inputs for any batch, one
    utterance with several beams included (the card's wrapper refuses a
    strided x_cand; the CPU's plain version would not notice)."""
    from tpu_asr_torch.decode import ctc_prefix as scorer_module
    rng = np.random.default_rng(3)
    w, t, v, k = 4, 9, 20, 5
    logp, lens, cands, y_last = _inputs(rng, b, w, t, v, k)
    _, ts = _scorers(logp, lens, w)
    seen = []

    def scan(*args, **kw):
        seen.append([a.is_contiguous() for a in args])
        return ctc_prefix_scan(*args, **kw)
    monkeypatch.setattr(scorer_module, "ctc_prefix_scan", scan)
    ts.score(torch.from_numpy(cands).long(), torch.from_numpy(y_last).long(),
             torch.full((b * w,), False), ts.init_state())
    assert seen and all(all(c) for c in seen)


def test_multi_step_advance_and_eos():
    """Walk a 3-token prefix with advance(); states and the eos score (the
    complete-prefix probability) stay equal to the reference."""
    rng = np.random.default_rng(3)
    b, t, v = 2, 12, 8
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((b, t, v)).astype(np.float32)), -1))
    lens = np.array([12, 9], np.int32)
    js, ts = _scorers(logp, lens, 1, eos=v - 1)
    jst, tst = js.init_state(), ts.init_state()
    y_last = np.full((b,), v - 2, np.int32)
    for i, c in enumerate([3, 3, 5]):
        tok = np.full((b,), c, np.int32)
        first = np.full((b,), i == 0)
        jst = js.advance(jnp.asarray(tok), jnp.asarray(y_last),
                         jnp.asarray(first), jst)
        tst = ts.advance(torch.from_numpy(tok).long(),
                         torch.from_numpy(y_last).long(),
                         torch.from_numpy(first), tst)
        _close(tst[0], jst[0], f"r after token {i}")
        _close(tst[1], jst[1], f"psi after token {i}")
        y_last = tok
        eos = np.full((b, 1), v - 1, np.int32)
        jpsi, _ = js.score(jnp.asarray(eos), jnp.asarray(y_last),
                           jnp.zeros((b,), bool), jst, return_r=False)
        tpsi, _ = ts.score(torch.from_numpy(eos).long(),
                           torch.from_numpy(y_last).long(),
                           torch.zeros((b,), dtype=torch.bool), tst,
                           return_r=False)
        _close(tpsi, jpsi, f"eos after token {i}")


def test_cpu_wrapper_runs_plain_version_without_counting():
    rng = np.random.default_rng(0)
    n, t, k = 3, 6, 4
    x = torch.from_numpy(rng.standard_normal((n, t, k)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    init = torch.full((n, k), -1e30)
    lens = torch.tensor([6, 3, 0], dtype=torch.int32)
    before = ctc_prefix_scan.launches
    got = ctc_prefix_scan(x, x, xb, x[:, 0].contiguous(), init, init, lens)
    want = ctc_prefix_scan_reference(x, x, xb, x[:, 0].contiguous(), init,
                                     init, lens)
    assert ctc_prefix_scan.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # frozen carries past each length; history entry 0 = the inits
    assert torch.equal(got[1][1, 3:], got[1][1, 2:3].expand(3, k))
    assert torch.equal(got[1][:, 0], x[:, 0])
    assert torch.equal(got[0][2], init[2])
