"""Port CTC prefix beam search (decode/ctc_beam.py) and attention
rescoring (decode/rescore.py) vs tpu_asr.decode.ctc_beam and
tpu_asr.decode.rescore on the CPU: the same logits (and, for rescoring,
the same decoder params and encoder output) give equal tokens and
lengths, and scores within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.decode.ctc_beam import \
    ctc_prefix_beam_search as jax_ctc_prefix_beam_search
from tpu_asr.decode.rescore import attention_rescore as jax_attention_rescore
from tpu_asr.models.decoder import Decoder as JaxDecoder
from tpu_asr_torch.decode.ctc_beam import (beam_advance, beam_finalize,
                                           beam_init, ctc_prefix_beam_search)
from tpu_asr_torch.decode.rescore import attention_rescore
from torch_port_util import VOCAB, flax_params, jax_cfg, torch_model

ATOL = 1e-4


def _logits(b, t, v, scale, seed):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, t, v))).astype(np.float32)


def _assert_same(want, got):
    w_toks, w_lens, w_scores = (np.asarray(x) for x in want)
    g_toks, g_lens, g_scores = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_toks, w_toks)
    np.testing.assert_array_equal(g_lens, w_lens)
    np.testing.assert_allclose(np.maximum(g_scores, -1e31),
                               np.maximum(w_scores, -1e31), atol=ATOL)


@pytest.mark.parametrize("v,beam,topk,max_len,scale", [
    (6, 4, 3, 6, 2.0),        # few tokens: many duplicate merges; the cap
    (6, 4, 8, 40, 4.0),       # topk > V - 1, peaked frames, no cap
    (32, 5, 8, 12, 1.0),      # flat frames: many live prefixes
    (32, 3, 2, 3, 3.0),       # a tight cap
])
def test_prefix_beam_search_matches_jax(v, beam, topk, max_len, scale):
    """Ragged lengths with a length-0 row (its n-best: the empty prefix
    at 0, the rest dead at NEG_INF)."""
    logits = _logits(4, 30, v, scale, v + beam + max_len)
    lens = np.array([30, 17, 0, 5], np.int32)
    want = jax_ctc_prefix_beam_search(jnp.asarray(logits), jnp.asarray(lens),
                                      beam=beam, topk=topk, max_len=max_len)
    got = ctc_prefix_beam_search(torch.from_numpy(logits),
                                 torch.from_numpy(lens), beam=beam,
                                 topk=topk, max_len=max_len)
    _assert_same(want, got)
    toks, got_lens, scores = got
    assert toks.dtype == got_lens.dtype == torch.int32
    assert got_lens[2, 0] == 0 and scores[2, 0] == 0.0
    assert (scores[2, 1:] <= -1e29).all()
    assert int(got_lens.max()) <= max_len


def test_chunked_advance_equals_full_search():
    """Frame-synchronous: advancing chunk by chunk gives the full search."""
    logits = torch.from_numpy(_logits(3, 24, 7, 2.0, 1))
    lens = torch.tensor([24, 13, 6])
    logp = torch.log_softmax(logits, -1)
    valid = torch.arange(24)[None, :] < lens[:, None]
    state = beam_init(3, 4, 10)
    for s in range(0, 24, 5):
        state = beam_advance(state, logp[:, s:s + 5], valid[:, s:s + 5],
                             topk=4)
    chunked = beam_finalize(state)
    full = ctc_prefix_beam_search(logits, lens, beam=4, topk=4, max_len=10)
    for a, b in zip(chunked, full):
        assert torch.equal(a, b)


def test_lm_fusion_is_not_ported():
    logits = torch.zeros(1, 3, 5)
    with pytest.raises(NotImplementedError):
        ctc_prefix_beam_search(logits, torch.tensor([3]), lm_weight=0.5)
    with pytest.raises(NotImplementedError):
        attention_rescore(None, torch.zeros(1, 3, 4), torch.tensor([3]),
                          logits, 3, 4, lm_weight=0.5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_rescore_matches_jax(use_pallas):
    """One teacher-forced decoder pass over the CTC n-best of random
    encoder states: ragged lengths, a length-0 row, max_len below T'."""
    rng = np.random.default_rng(3)
    b, t = 3, 14
    enc = rng.standard_normal((b, t, 64)).astype(np.float32)
    lens = np.array([14, 9, 0], np.int32)
    enc[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    logits = _logits(b, t, VOCAB, 2.0, 4)
    kw = dict(beam=4, max_len=6, ctc_weight=0.3)
    dp = {"params": flax_params()["params"]["decoder"]}
    want = jax_attention_rescore(
        JaxDecoder(jax_cfg(use_pallas=use_pallas)), dp, jnp.asarray(enc),
        jnp.asarray(lens), jnp.asarray(logits), VOCAB - 2, VOCAB - 1, **kw)
    decoder = torch_model(use_pallas=use_pallas).decoder
    with torch.no_grad():
        got = attention_rescore(decoder, torch.from_numpy(enc),
                                torch.from_numpy(lens),
                                torch.from_numpy(logits), VOCAB - 2,
                                VOCAB - 1, **kw)
    _assert_same((want["tokens"], want["lengths"], want["scores"]),
                 (got["tokens"], got["lengths"], got["scores"]))
    for key in ("att_scores", "ctc_scores"):
        np.testing.assert_allclose(
            np.maximum(got[key].numpy(), -1e31),
            np.maximum(np.asarray(want[key]), -1e31), atol=ATOL,
            err_msg=key)
    assert (got["scores"][2, 1:] <= -1e29).all()    # dead slots stay dead
