"""CTC prefix beam search, frame-synchronous and batched (port of
tpu_asr/decode/ctc_beam.py, without LM fusion).

Per frame and beam (Hannun et al. 2014):

  stay    (same prefix):  pb' = (pb + pnb) + lp[blank]     (+ in log space)
                          pnb' = pnb + lp[last]          (repeat collapses)
  extend  (prefix + c):   pnb' = (c == last ? pb : pb + pnb) + lp[c]

over a fixed beam W and the top K non-blank tokens of each frame. The
candidates that materialize the same prefix (a stay of beam i and an
extend of beam j) are merged exactly: a [B, N, N] prefix-equality matrix
over the N = W (K + 1) candidates logsumexps each group into its first
member and masks the others, then the top W survive (ties to the
smallest index, as lax.top_k). Frames past a row's length are no-ops.

The reference's lax.scan over frames is a Python loop here; it stops
after the longest row's last frame, since the frames after it are
no-ops for every row. LM shallow fusion (`lm_weight > 0`) is not ported
yet and raises NotImplementedError.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.ops.topk import exact_top_k

NEG_INF = -1e30


def _no_lm(lm_weight: float):
    if lm_weight > 0.0:
        raise NotImplementedError("LM shallow fusion is not ported yet")


def _logaddexp(a, b):
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=NEG_INF / 2)
    out = m_safe + torch.log1p(torch.exp(torch.minimum(a, b) - m_safe))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _merge_lse(eq, x):
    """Row-wise logsumexp of x over each equality group: [B,N,N]x[B,N]."""
    vals = torch.where(eq, x[:, None, :], NEG_INF)      # [B, N(out), N(in)]
    m = vals.amax(dim=-1)
    m_safe = m.clamp(min=NEG_INF / 2)
    s = torch.exp(vals - m_safe[..., None]).sum(dim=-1)
    return torch.where(m <= NEG_INF / 2, NEG_INF,
                       m_safe + torch.log(s.clamp(min=1e-37)))


def beam_init(b: int, beam: int, max_len: int, pad_id: int = -1,
              device=None):
    """Fresh search state (prefixes [B, W, L], lens [B, W], pb, pnb, last):
    only beam 0 is live (the empty prefix, pb = 0)."""
    w = beam
    prefixes = torch.full((b, w, max_len), pad_id, dtype=torch.int32,
                          device=device)
    lens = torch.zeros((b, w), dtype=torch.int32, device=device)
    pb = torch.where(torch.arange(w, device=device) == 0, 0.0, NEG_INF)
    pb = pb[None, :].expand(b, w).contiguous()
    pnb = torch.full((b, w), NEG_INF, device=device)
    last = torch.full((b, w), -1, dtype=torch.int32, device=device)
    return prefixes, lens, pb, pnb, last


def beam_advance(state, logp, frame_valid, topk: int = 8, blank: int = 0):
    """Advance the search over logp [B, Tc, V] (log-softmaxed float32) with
    frame_valid [B, Tc]; chunk-at-a-time advances compose to the
    full-utterance search."""
    prefixes, lens, pb, pnb, last = state
    b, w, max_len = prefixes.shape
    v = logp.shape[-1]
    k = min(topk, v - 1)
    n = w * (k + 1)                       # stay + K extends per beam
    dev = logp.device
    ar_w = torch.arange(w, device=dev)
    parent = torch.cat([ar_w, ar_w.repeat_interleave(k)])          # [N]
    pos = torch.arange(max_len, device=dev)[None, None, :]
    idx = torch.arange(n, device=dev)[None, :]
    no_app = torch.full((b, w), -1, dtype=torch.int32, device=dev)
    no_pb = torch.full((b, w * k), NEG_INF, device=dev)

    for t in range(logp.shape[1]):
        lp = logp[:, t]                                           # [B, V]
        total = _logaddexp(pb, pnb)                               # [B, W]

        # stay candidates (one per beam): same prefix
        stay_pb = total + lp[:, blank, None]
        lp_last = torch.gather(lp, 1, last.clamp(min=0).long())   # [B, W]
        stay_pnb = torch.where(last >= 0, pnb + lp_last, NEG_INF)

        # extend candidates: top-K non-blank tokens of the frame
        lp_nb = lp.clone()
        lp_nb[:, blank] = NEG_INF
        top_lp, top_c = exact_top_k(lp_nb, k)                     # [B, K]
        c = top_c.to(torch.int32)[:, None, :].expand(b, w, k)
        same = c == last[..., None]
        ext_pnb = torch.where(same, pb[..., None],
                              total[..., None]) + top_lp[:, None, :]
        ext_pnb = torch.where((lens < max_len)[..., None], ext_pnb, NEG_INF)

        # the candidate pool [B, N]: the first W are stays, then extends
        app = torch.cat([no_app, c.reshape(b, w * k)], dim=1)
        cand_pb = torch.cat([stay_pb, no_pb], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, w * k)], dim=1)
        par_len = lens[:, parent]                                 # [B, N]
        is_ext = app >= 0
        cand_pref = torch.where(
            is_ext[..., None] & (pos == par_len[..., None]),
            app[..., None], prefixes[:, parent])                  # [B, N, L]
        cand_len = par_len + is_ext.to(torch.int32)
        cand_last = torch.where(is_ext, app, last[:, parent])

        # exact duplicate merge: logsumexp equal prefixes into the first
        eq = (cand_len[:, :, None] == cand_len[:, None, :]) & (
            cand_pref[:, :, None] == cand_pref[:, None, :]).all(dim=-1)
        is_first = eq.to(torch.uint8).argmax(dim=-1) == idx
        cand_pb = torch.where(is_first, _merge_lse(eq, cand_pb), NEG_INF)
        cand_pnb = torch.where(is_first, _merge_lse(eq, cand_pnb), NEG_INF)

        _, top_idx = exact_top_k(_logaddexp(cand_pb, cand_pnb), w)  # [B, W]
        keep = frame_valid[:, t, None]        # frames past the length: no-op

        def pick(x, old):
            if x.ndim == 3:
                new = torch.gather(x, 1, top_idx[..., None].expand(
                    b, w, x.shape[2]))
                return torch.where(keep[..., None], new, old)
            return torch.where(keep, torch.gather(x, 1, top_idx), old)

        prefixes, lens, pb, pnb, last = (
            pick(cand_pref, prefixes), pick(cand_len, lens),
            pick(cand_pb, pb), pick(cand_pnb, pnb), pick(cand_last, last))
    return prefixes, lens, pb, pnb, last


def beam_finalize(state):
    """-> (tokens [B, W, L], lengths [B, W], scores [B, W]) sorted
    best-first by log P(prefix); equal scores keep their beam order (the
    reference's stable argsort)."""
    prefixes, lens, pb, pnb = state[:4]
    scores = _logaddexp(pb, pnb)
    order = torch.argsort(-scores, dim=-1, stable=True)
    prefixes = torch.gather(prefixes, 1, order[..., None].expand(
        prefixes.shape))
    return prefixes, torch.gather(lens, 1, order), torch.gather(scores, 1,
                                                                order)


def ctc_prefix_beam_search(ctc_logits: torch.Tensor,
                           enc_lengths: torch.Tensor, beam: int = 5,
                           topk: int = 8, max_len: int = 200, blank: int = 0,
                           pad_id: int = -1, lm_weight: float = 0.0):
    """ctc_logits [B, T, V], enc_lengths [B] -> (tokens [B, beam, max_len]
    pad_id-padded int32, lengths [B, beam] int32, scores [B, beam] log
    P(prefix) float32), sorted best-first."""
    _no_lm(lm_weight)
    b, t, _ = ctc_logits.shape
    logp = torch.log_softmax(ctc_logits.float(), dim=-1)
    frame_valid = (torch.arange(t, device=logp.device)[None, :]
                   < enc_lengths[:, None])                        # [B, T]
    state = beam_init(b, beam, max_len, pad_id, device=logp.device)
    # frames after the longest row's last one are no-ops for every row
    t_run = min(t, int(enc_lengths.max())) if b else 0
    state = beam_advance(state, logp[:, :t_run], frame_valid[:, :t_run],
                         topk=topk, blank=blank)
    return beam_finalize(state)
