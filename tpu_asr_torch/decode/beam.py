"""Batched attention beam search with optional joint CTC/attention scoring
and LM shallow fusion (port of tpu_asr/decode/beam.py).

Static shapes as in the reference: fixed beam width W, fixed max_len,
explicit KV caches reordered by index_select at each step, eos-forced
continuation for finished hypotheses, and joint scoring through the
CTCPrefixScorer:  S = (1-l) * logP_att + l * logP_ctc, accumulated
incrementally (psi differences). With an external LM (models/lm.py) and
lm_weight b > 0, S += b * logP_lm: the LM advances once a step on the
same tokens through its cached `step`, and its caches are reordered
with the decoder's. In the joint search the candidates stay the
attention top-k (espnet's pre-beam); the LM only reweights them.

The reference's lax.while_loop becomes a Python loop. Its early exit
(stop once every hypothesis is finished) reads `finished.all()` on the
host, which synchronises with the device once per step; capturing the
step in a CUDA graph to remove that and the launch overhead is later
work. Under a profiler that read is the span beam.sync, and the rest of
a step the span beam.step (utils.tracing).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_asr_torch.decode.ctc_prefix import CTCPrefixScorer
from tpu_asr_torch.ops.topk import exact_top_k
from tpu_asr_torch.utils.tracing import span

NEG_INF = -1e30
# auto threshold for BeamConfig.ctc_two_pass=None (the reference's value:
# auto never picks two-pass at realistic beams).
CTC_TWO_PASS_BEAM = 10_000


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam: int = 5
    max_len: int = 64
    ctc_weight: float = 0.0          # joint scoring weight (0 = pure attn)
    ctc_cand: int = 0                # CTC-scored candidates/beam (0 = 2*beam)
    length_penalty: float = 0.0      # added per emitted token to final score
    nbest: int = 1
    # maxlenratio > 0 caps each utterance at floor(maxlenratio * enc_len)
    # real tokens, then forces an unscored eos; minlenratio > 0 bans eos
    # until floor(minlenratio * enc_len) tokens were emitted.
    maxlenratio: float = 0.0
    minlenratio: float = 0.0
    lm_weight: float = 0.0           # LM shallow fusion (0 = none)
    # One-pass scores all K candidates with their r histories and gathers
    # the winners; two-pass scores without histories and re-advances only
    # the W winners (a second scan). None = auto.
    ctc_two_pass: bool | None = None


def attention_beam_search(decoder, enc_out: torch.Tensor,
                          enc_lengths: torch.Tensor, sos_id: int, eos_id: int,
                          cfg: BeamConfig = BeamConfig(),
                          ctc_logp: torch.Tensor | None = None, lm=None):
    """Run beam search over a batch of utterances.

    decoder: tpu_asr_torch.models.decoder.Decoder; enc_out [B, T, D];
    ctc_logp [B, T, V] (log-softmaxed) required when cfg.ctc_weight > 0;
    lm: a models.lm.TransformerLM, fused when cfg.lm_weight > 0 (without
    one, the search runs as with lm_weight 0, as the reference's does).

    Returns dict(tokens [B, W, max_len] eos-padded, scores [B, W],
    lengths [B, W]) sorted best-first, and steps (decode steps taken).
    """
    b, t, _ = enc_out.shape
    w = cfg.beam
    n = b * w
    dev = enc_out.device
    use_ctc = cfg.ctc_weight > 0.0
    lam = cfg.ctc_weight

    cross_kv = {key: x.repeat_interleave(w, dim=1)
                for key, x in decoder.precompute_cross_kv(enc_out).items()}
    enc_lengths_flat = enc_lengths.repeat_interleave(w)
    cache = decoder.init_cache(n, cfg.max_len, device=dev)
    use_lm = cfg.lm_weight > 0.0 and lm is not None
    lm_cache = lm.init_cache(n, cfg.max_len, device=dev) if use_lm else None

    scorer = ctc_state = None
    if use_ctc:
        if ctc_logp is None:
            raise ValueError("joint scoring needs ctc log-probs")
        scorer = CTCPrefixScorer(ctc_logp, enc_lengths_flat, blank=0,
                                 eos=eos_id, beams=w)
        ctc_state = scorer.init_state()
    k_cand = cfg.ctc_cand or 2 * w
    if ctc_logp is not None:
        k_cand = min(k_cand, ctc_logp.shape[-1])
    k_tot = k_cand + 1
    two_pass = (cfg.ctc_two_pass if cfg.ctc_two_pass is not None
                else w >= CTC_TWO_PASS_BEAM)

    if cfg.maxlenratio > 0:
        utt_maxlen = torch.clamp(
            torch.floor(cfg.maxlenratio * enc_lengths).to(torch.int32),
            1, cfg.max_len)
    else:
        utt_maxlen = torch.full((b,), cfg.max_len, dtype=torch.int32,
                                device=dev)
    utt_minlen = (torch.floor(cfg.minlenratio * enc_lengths).to(torch.int32)
                  if cfg.minlenratio > 0
                  else torch.zeros((b,), dtype=torch.int32, device=dev))

    batch_base = (torch.arange(b, device=dev) * w)[:, None]     # [B, 1]
    y_prev = torch.full((n,), sos_id, dtype=torch.long, device=dev)
    scores = torch.where(torch.arange(w, device=dev)[None, :] == 0, 0.0,
                         NEG_INF).repeat(b, 1)
    finished = torch.zeros((b, w), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, w), dtype=torch.int32, device=dev)
    tokens = torch.full((b, w, cfg.max_len), eos_id, dtype=torch.long,
                        device=dev)

    pos = 0
    # Early exit: once every hypothesis is finished, further steps are
    # output-neutral (eos continues at zero cost), so stopping is exact.
    # bool() here is the per-step host sync noted in the module docstring,
    # in its own span (beam.sync) beside the step's (beam.step).
    while pos < cfg.max_len:
        with span("beam.sync"):
            done = bool(finished.all())
        if done:
            break
        with span("beam.step"):
            logits, cache = decoder.step(y_prev, pos, cache, cross_kv,
                                         enc_lengths_flat)
            att_logp = torch.log_softmax(logits.float(), dim=-1)
            if use_lm:
                lm_logits, lm_cache = lm.step(y_prev, pos, lm_cache)
                lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)
            must_end = pos >= utt_maxlen[:, None]                   # [B, 1]
            ban_eos = pos < utt_minlen[:, None]                     # [B, 1]
            ended = finished | must_end                             # [B, W]

            if use_ctc:
                cand_logp, cand_ids = exact_top_k(att_logp, k_cand)  # [N, K]
                cand_ids = torch.cat([cand_ids, torch.full(
                    (n, 1), eos_id, dtype=cand_ids.dtype, device=dev)],
                    dim=1)
                cand_logp = torch.cat([cand_logp, att_logp[:, eos_id, None]],
                                      dim=1)
                is_first = torch.full((n,), pos == 0, device=dev)
                psi, new_r = scorer.score(cand_ids, y_prev, is_first,
                                          ctc_state, return_r=not two_pass)
                old_r, old_psi = ctc_state
                step_score = ((1.0 - lam) * cand_logp
                              + lam * (psi - old_psi[:, None]))     # [N, K+1]
                if use_lm:
                    step_score = step_score + cfg.lm_weight * torch.gather(
                        lm_logp, 1, cand_ids)
                ban = ((cand_ids == eos_id)
                       & ban_eos.expand(b, w).reshape(n, 1))
                step_score = torch.where(ban, NEG_INF, step_score)
                # finished (or maxlen-forced) beams: only the eos slot
                # continues, at zero cost
                eos_slot = torch.arange(k_tot, device=dev)[None, :] == k_cand
                step_score = torch.where(
                    ended.expand(b, w).reshape(n, 1),
                    torch.where(eos_slot, 0.0, NEG_INF), step_score)
                cand = (scores.reshape(n, 1) + step_score).reshape(
                    b, w * k_tot)
                top_scores, top_idx = exact_top_k(cand, w)          # [B, W]
                beam_idx = top_idx // k_tot
                slot_idx = top_idx % k_tot
                flat_beam = (batch_base + beam_idx).reshape(n)
                flat_slot = slot_idx.reshape(n)
                tok = cand_ids[flat_beam, flat_slot].reshape(b, w)
                psi_sel = psi[flat_beam, flat_slot]
                old_r_g = old_r[flat_beam]
                old_psi_g = old_psi[flat_beam]
                if two_pass:
                    r_next, _ = scorer.advance(
                        tok.reshape(n), y_prev[flat_beam], is_first,
                        (old_r_g, old_psi_g))
                else:
                    r_next = new_r[flat_beam, flat_slot]         # [N, T, 2]
                # finished/eos beams keep their old prefix state
                was_finished_g = torch.gather(finished, 1,
                                              beam_idx).reshape(n)
                keep_old = was_finished_g | (tok.reshape(n) == eos_id)
                r_next = torch.where(keep_old[:, None, None], old_r_g, r_next)
                psi_next = torch.where(keep_old, old_psi_g, psi_sel)
                ctc_state = (r_next, psi_next)
            else:
                fused = (att_logp + cfg.lm_weight * lm_logp if use_lm
                         else att_logp)
                logp = fused.reshape(b, w, -1)
                v = logp.shape[-1]
                is_eos_col = (torch.arange(v, device=dev)[None, None, :]
                              == eos_id)
                logp = torch.where(is_eos_col & ban_eos[..., None], NEG_INF,
                                   logp)
                eos_forced = torch.where(is_eos_col, 0.0, NEG_INF)
                logp = torch.where(ended[..., None], eos_forced, logp)
                cand = (scores[..., None] + logp).reshape(b, w * v)
                top_scores, top_idx = exact_top_k(cand, w)
                beam_idx = top_idx // v
                tok = top_idx % v
                flat_beam = (batch_base + beam_idx).reshape(n)

            # reorder all per-beam state
            cache = {key: x.index_select(1, flat_beam)
                     for key, x in cache.items()}
            if use_lm:
                lm_cache = {key: x.index_select(1, flat_beam)
                            for key, x in lm_cache.items()}
            tokens = tokens.reshape(n, -1)[flat_beam].reshape(b, w, -1)
            finished_g = torch.gather(finished, 1, beam_idx)
            lengths_g = torch.gather(lengths, 1, beam_idx)

            now_eos = tok == eos_id
            tokens[:, :, pos] = torch.where(finished_g, eos_id, tok)
            lengths = torch.where(finished_g, lengths_g,
                                  torch.where(now_eos, pos, pos + 1)
                                  ).to(torch.int32)
            finished = finished_g | now_eos
            scores = top_scores
            y_prev = tok.reshape(n)
            pos += 1

    # Unfinished hyps at max_len keep their accumulated score; optional
    # per-token length reward.
    final = scores + cfg.length_penalty * lengths.float()
    order = torch.argsort(-final, dim=1, stable=True)
    return {
        "tokens": torch.gather(tokens, 1, order[..., None].expand_as(tokens)),
        "scores": torch.gather(final, 1, order),
        "lengths": torch.gather(lengths, 1, order),
        "steps": pos,
    }
