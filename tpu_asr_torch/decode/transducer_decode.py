"""Transducer decoding: greedy, ALSD beam search (with LM shallow fusion)
and CTC n-best rescoring (port of tpu_asr/decode/transducer_decode.py).

Greedy: every row carries its own (frame t, label count u, emitted this
frame) state and the whole batch advances together: argmax the joint at
(t, u); a label extends the history and runs the predictor's cached step
(per-row positions), blank (or the per-frame cap) consumes the frame.
The reference's `lax.while_loop` is a Python loop here, which checks on
the host every GREEDY_SYNC_EVERY steps whether a row still has frames: a
step after every row has run out is a no-op. The loop body is
`greedy_init` / `greedy_advance` over an explicit state dict, so a
streaming recognizer can run the same search chunk by chunk.

Beam (ALSD): every live hypothesis has taken the same number of
alignment steps (t + u); one iteration expands the [B, W] front by one
step (blank -> t+1, or one of the top-K labels -> u+1), keeps the top W
of the W (K + 1) candidates per utterance, and merges (logsumexp) the
hypotheses with the same labels and frame pointer (done ones: the same
labels). Per-beam state is reordered with index_select. The loop checks
the host every step, since a step after all are done could move the
order of the dead (-1e30) slots.

Rescore: the aux-CTC prefix-beam n-best, scored by one teacher-forced
predictor pass and the exact transducer marginal (ops/transducer.py);
final score = -NLL + ctc_weight * CTC score.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.decode.ctc_beam import ctc_prefix_beam_search
from tpu_asr_torch.ops.topk import exact_top_k
from tpu_asr_torch.ops.transducer import transducer_loss

NEG_INF = -1e30
GREEDY_SYNC_EVERY = 8     # greedy steps between host checks of the loop


def _valid_frames(feat_lengths, enc_lengths):
    return torch.where(feat_lengths > 0, enc_lengths, 0).clamp(min=0)


def greedy_init(model, batch: int, max_tokens: int, device=None) -> dict:
    """Fresh search state: empty history (sos consumed at position 0)."""
    sos = model.cfg.vocab_size - 2
    cache = model.predictor_init_cache(batch, max_tokens + 1, device=device)
    zeros = torch.zeros(batch, dtype=torch.long, device=device)
    g, cache = model.predictor_step(zeros + sos, zeros, cache)
    return dict(
        u=zeros,
        tokens=torch.full((batch, max_tokens), -1, dtype=torch.int32,
                          device=device),
        times=torch.full((batch, max_tokens), -1, dtype=torch.int32,
                         device=device),
        confs=torch.zeros((batch, max_tokens), device=device),
        g=g, cache=cache)


def greedy_advance(model, f, n_valid, state: dict,
                   max_symbols_per_frame: int = 4,
                   frame_offset: int = 0) -> tuple[dict, int]:
    """Consume frames f[:, :n_valid] (per row) -> (the advanced state,
    loop steps taken).

    f: [B, Tc, d_joint] encoder-side joint features; n_valid [B] valid
    frames of each row within f. Each call starts at local frame 0, and
    frame_offset (the chunk's global start) keeps `times`, the encoder
    frame of each emitted token, global. The predictor runs for every row
    at each step; rows that did not emit keep their g."""
    b, t_max, _ = f.shape
    max_tokens = state["tokens"].shape[1]
    sos = model.cfg.vocab_size - 2
    dev = f.device
    rows = torch.arange(b, device=dev)
    n_valid = n_valid.clamp(max=t_max)
    t = torch.zeros(b, dtype=torch.long, device=dev)
    emitted = torch.zeros_like(t)
    u, tokens, times, confs, g, cache = (
        state[k] for k in ("u", "tokens", "times", "confs", "g", "cache"))
    steps = 0
    while t_max and (steps % GREEDY_SYNC_EVERY
                     or bool((t < n_valid).any())):
        steps += 1
        logits = model.joint_step(f[rows, t.clamp(max=t_max - 1)], g)
        k = logits.argmax(dim=-1)
        active = t < n_valid
        emit = active & (k != 0) & (u < max_tokens) & \
            (emitted < max_symbols_per_frame)
        u_clip = u.clamp(0, max_tokens - 1)
        tokens[rows, u_clip] = torch.where(emit, k.to(torch.int32),
                                           tokens[rows, u_clip])
        times[rows, u_clip] = torch.where(
            emit, (t + frame_offset).to(torch.int32), times[rows, u_clip])
        # confidence: the softmax probability of the emitted token
        k_lp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                            k[:, None])[:, 0]
        confs[rows, u_clip] = torch.where(emit, torch.exp(k_lp),
                                          confs[rows, u_clip])
        g_new, cache = model.predictor_step(
            torch.where(emit, k, sos), (u + 1).clamp(max=max_tokens), cache)
        g = torch.where(emit[:, None], g_new, g)
        # blank (or the cap) consumes the frame; a label stays on it
        advance = active & ~emit
        t = torch.where(advance, t + 1, t)
        u = torch.where(emit, u + 1, u)
        emitted = torch.where(emit, emitted + 1,
                              torch.where(advance, 0, emitted))
    return dict(u=u, tokens=tokens, times=times, confs=confs, g=g,
                cache=cache), steps


def transducer_greedy_decode(model, feats, feat_lengths,
                             max_tokens: int = 200,
                             max_symbols_per_frame: int = 4):
    """Batched offline greedy decode -> (tokens [B, max_tokens] int32
    (-1 padded), lengths [B], times [B, max_tokens] (the encoder frame of
    each token, -1 padded), confs [B, max_tokens], loop steps)."""
    enc_out, enc_lengths = model.encode(feats, feat_lengths)
    f = model.enc_features(enc_out)
    state = greedy_init(model, f.shape[0], max_tokens, device=f.device)
    state, steps = greedy_advance(model, f,
                                  _valid_frames(feat_lengths, enc_lengths),
                                  state, max_symbols_per_frame)
    return (state["tokens"], state["u"].to(torch.int32), state["times"],
            state["confs"], steps)


def transducer_beam_search(model, feats, feat_lengths, beam: int = 5,
                           max_tokens: int = 200, label_cand: int = 0,
                           length_penalty: float = 0.0, lm=None,
                           lm_weight: float = 0.0) -> dict:
    """Alignment-length-synchronous beam search (module docstring).

    lm: a models.lm.TransformerLM, fused when lm_weight > 0 (espnet
    convention): label extensions score += lm_weight * log P_lm(token |
    history) before the top-K, blank carries no LM term, and the LM
    advances by its per-row `step_at` on emitting rows only.
    -> dict(tokens [B, W, max_tokens] int32 (-1 padded), lengths [B, W],
    scores [B, W], steps) sorted best-first (a stable sort); beam 1
    equals greedy when the greedy per-frame cap does not bind."""
    enc_out, enc_lengths = model.encode(feats, feat_lengths)
    f = model.enc_features(enc_out)
    b, t_max, _ = f.shape
    dev = f.device
    w = beam
    n = b * w
    v = model.cfg.vocab_size
    sos = v - 2
    k = label_cand or min(w, v - 1)
    t_len = _valid_frames(feat_lengths, enc_lengths).repeat_interleave(w)
    b_rows = torch.arange(b, device=dev).repeat_interleave(w)
    rows = torch.arange(n, device=dev)
    base = torch.arange(b, device=dev)[:, None] * w
    zeros = torch.zeros(n, dtype=torch.long, device=dev)

    cache = model.predictor_init_cache(n, max_tokens + 1, device=dev)
    g, cache = model.predictor_step(zeros + sos, zeros, cache)
    use_lm = lm is not None and lm_weight > 0.0
    if use_lm:
        lm_cache = lm.init_cache(n, max_tokens + 1, device=dev)
        lm_logits, lm_cache = lm.step_at(zeros + sos, zeros, lm_cache)
        lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)

    t, u = zeros, zeros
    done = t_len == 0
    scores = torch.where(torch.arange(w, device=dev) == 0, 0.0, NEG_INF)
    scores = scores[None, :].expand(b, w).contiguous()
    tokens = torch.full((n, max_tokens), -1, dtype=torch.int32, device=dev)
    steps = 0
    while bool((~done).any()):
        steps += 1
        logp = torch.log_softmax(model.joint_step(
            f[b_rows, t.clamp(max=t_max - 1)], g), dim=-1)
        blank_lp = logp[:, 0]
        label_lp = logp.clone()
        label_lp[:, 0] = NEG_INF
        label_lp[:, v - 2:] = NEG_INF       # sos/eos are not outputs
        if use_lm:
            label_lp = label_lp + lm_weight * lm_logp
        cand_lp, cand_ids = exact_top_k(label_lp, k)              # [N, K]
        # candidate slot 0 = blank/hold, 1..K = label extensions
        step_score = torch.cat(
            [torch.where(done, 0.0, blank_lp)[:, None],
             torch.where((done | (u >= max_tokens))[:, None], NEG_INF,
                         cand_lp)], dim=1)                        # [N, K+1]
        cand = scores.reshape(n)[:, None] + step_score
        top_scores, top_idx = exact_top_k(cand.reshape(b, w * (k + 1)), w)
        src = (base + top_idx // (k + 1)).reshape(n)    # source beam rows
        slot = (top_idx % (k + 1)).reshape(n)

        # reorder the per-beam state to the winners' source beams
        t, u, done, tokens, g = (x[src] for x in (t, u, done, tokens, g))
        cache = {key: x.index_select(1, src) for key, x in cache.items()}
        emit = (slot > 0) & ~done
        tok = torch.gather(cand_ids[src], 1, (slot - 1).clamp(min=0)[:, None]
                           )[:, 0]
        u_clip = u.clamp(0, max_tokens - 1)
        tokens[rows, u_clip] = torch.where(emit, tok.to(torch.int32),
                                           tokens[rows, u_clip])
        y = torch.where(emit, tok, sos)
        pos = (u + 1).clamp(max=max_tokens)
        g_new, cache = model.predictor_step(y, pos, cache)
        g = torch.where(emit[:, None], g_new, g)
        if use_lm:
            lm_cache = {key: x.index_select(1, src)
                        for key, x in lm_cache.items()}
            lm_logits, lm_cache = lm.step_at(y, pos, lm_cache)
            lm_logp = torch.where(emit[:, None], torch.log_softmax(
                lm_logits.float(), dim=-1), lm_logp[src])

        t = torch.where((slot == 0) & ~done, t + 1, t)
        u = torch.where(emit, u + 1, u)
        done = done | (t >= t_len)

        # (y, t) recombination: the same labels and frame pointer (done:
        # the same labels) have the same future; merge the posterior mass
        # into the first such slot, the others drop to NEG_INF
        tok_b = tokens.reshape(b, w, max_tokens)
        t_key = torch.where(done, -1, t).reshape(b, w)
        u_b = u.reshape(b, w)
        same = ((tok_b[:, :, None, :] == tok_b[:, None, :, :]).all(-1)
                & (t_key[:, :, None] == t_key[:, None, :])
                & (u_b[:, :, None] == u_b[:, None, :]))           # [B,W,W]
        first = same.to(torch.uint8).argmax(dim=2) == torch.arange(
            w, device=dev)[None, :]
        merged = torch.logsumexp(
            torch.where(same, top_scores[:, None, :], NEG_INF), dim=2)
        scores = torch.where(first, merged, NEG_INF)

    lengths = u.reshape(b, w).to(torch.int32)
    scores = scores + length_penalty * lengths.float()
    order = torch.argsort(-scores, dim=1, stable=True)
    tokens = tokens.reshape(b, w, max_tokens)
    return {"tokens": torch.gather(tokens, 1, order[..., None].expand(
                tokens.shape)),
            "scores": torch.gather(scores, 1, order),
            "lengths": torch.gather(lengths, 1, order), "steps": steps}


def transducer_rescore(model, feats, feat_lengths, beam: int = 10,
                       max_len: int = 64, ctc_weight: float = 0.5,
                       ctc_topk: int = 8) -> dict:
    """Two-pass decode: the aux-CTC prefix-beam n-best (decode/ctc_beam.py)
    rescored by the exact transducer marginal log P(y | x) from one
    teacher-forced predictor pass and the lattice. final = -NLL +
    ctc_weight * CTC score; slots whose CTC score is dead stay NEG_INF.
    Needs the aux CTC head. -> dict(tokens [B, W, L] (-1 padded), scores,
    lengths, rnnt_scores, ctc_scores [B, W]) sorted best-first."""
    enc_out, enc_lengths = model.encode(feats, feat_lengths)
    enc_lengths = _valid_frames(feat_lengths, enc_lengths)
    ctc_logits = model.ctc_logits(enc_out)
    b = enc_out.shape[0]
    w = beam
    l = min(max_len, ctc_logits.shape[1])
    toks, lens, ctc_scores = ctc_prefix_beam_search(
        ctc_logits, enc_lengths, beam=w, topk=ctc_topk, max_len=l)

    n = b * w
    safe = toks.reshape(n, l).clamp(min=0).long()
    sos = torch.full((n, 1), model.cfg.vocab_size - 2, dtype=torch.long,
                     device=safe.device)
    g = model.predict_sequence(torch.cat([sos, safe], dim=1))   # [N, L+1]
    f = model.enc_features(enc_out).repeat_interleave(w, dim=0)
    w_out, b_out = model.joint_out()
    nll = transducer_loss(f, g, w_out, b_out, safe,
                          enc_lengths.repeat_interleave(w), lens.reshape(n),
                          blank=0, reduction="none")
    rnnt_score = (-nll).reshape(b, w)
    final = rnnt_score + ctc_weight * ctc_scores
    final = torch.where(ctc_scores <= NEG_INF / 2, NEG_INF, final)
    order = torch.argsort(-final, dim=1, stable=True)

    def take(x):
        if x.ndim == 3:
            return torch.gather(x, 1, order[..., None].expand(x.shape))
        return torch.gather(x, 1, order)

    return {"tokens": take(toks), "scores": take(final),
            "lengths": take(lens), "rnnt_scores": take(rnnt_score),
            "ctc_scores": take(ctc_scores)}
