"""CIF inference: fire from the assigner's alphas with tail rounding, then
an autoregressive greedy or beam decode over the fired embeddings (port
of tpu_asr/decode/cif_decode.py).

CIF emits exactly n_fire tokens per utterance. The reference's
lax.while_loop becomes a Python loop to min(max(n_fire) + 1, max_len):
max(n_fire) comes to the host once per batch, so the steps themselves do
not synchronise with the device. Positions at or after a row's n_fire,
and after an emitted eos, are masked in the output.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.ops.cif import fire_count, scale_alphas
from tpu_asr_torch.ops.topk import exact_top_k
from tpu_asr_torch.utils.padding import make_valid_mask

NEG_INF = -1e30


def _encode_and_fire(model, feats, feat_lengths, max_len: int,
                     scale_fire: bool = True):
    """-> (fired [B, max_len, D] float32, n_fire [B] int32).

    scale_fire=True renormalizes the alphas to the rounded fire count
    before firing (the boundary geometry of training, where alphas always
    sum to U+1); False fires on the raw sigmoid alphas (the reference's
    inference), so the tail fire is the unnormalized residual."""
    enc_out, _, alphas, valid = model.encode(feats, feat_lengths)
    n_fire = torch.clamp(
        fire_count(alphas, valid, model.cfg.cif_tail_threshold), max=max_len)
    if scale_fire:
        alphas = scale_alphas(alphas, valid, n_fire)
    return model.fire(enc_out, alphas, max_len), n_fire


def _mask_output(toks, n_fire, eos: int, pad_id: int):
    """Keep positions < n_fire and before the first eos -> (tokens
    pad_id-padded, lengths)."""
    valid_pos = make_valid_mask(n_fire, toks.shape[1])
    after_eos = torch.cumsum((toks == eos).to(torch.int32), dim=1) > 0
    keep = valid_pos & ~after_eos
    return torch.where(keep, toks, pad_id), keep.sum(dim=1)


def cif_greedy_decode(model, feats, feat_lengths, max_len: int = 64,
                      pad_id: int = -1, scale_fire: bool = True):
    """-> (tokens [B, max_len] pad_id-padded, lengths [B], steps taken)."""
    fired, n_fire = _encode_and_fire(model, feats, feat_lengths, max_len,
                                     scale_fire)
    b = feats.shape[0]
    dev = fired.device
    dec = model.decoder
    cache = dec.init_cache(b, max_len, device=dev)
    eos = model.eos_id
    y_prev = torch.full((b,), model.sos_id, dtype=torch.long, device=dev)
    # eos-initialized: what the eos-forced tail steps would have written
    toks = torch.full((b, max_len), eos, dtype=torch.long, device=dev)
    steps = min(int(n_fire.max()) + 1, max_len)
    for pos in range(steps):
        logits, cache = dec.step(y_prev, fired[:, pos], pos, cache)
        y_prev = torch.argmax(logits, dim=-1)
        toks[:, pos] = y_prev
    tokens, lengths = _mask_output(toks, n_fire, eos, pad_id)
    return tokens, lengths, steps


def cif_beam_decode(model, feats, feat_lengths, beam: int = 5,
                    max_len: int = 64, pad_id: int = -1,
                    scale_fire: bool = True):
    """Beam search at fixed length: beams score the sum of log-probs over
    positions < n_fire (later positions are eos at no cost), top-W kept
    per step. -> (best tokens [B, max_len] pad_id-padded, lengths [B],
    steps taken)."""
    fired, n_fire = _encode_and_fire(model, feats, feat_lengths, max_len,
                                     scale_fire)
    b, w = feats.shape[0], beam
    n = b * w
    dev = fired.device
    dec = model.decoder
    fired_flat = fired.repeat_interleave(w, dim=0)           # [B*W, U, D]
    n_fire_flat = n_fire.repeat_interleave(w)
    cache = dec.init_cache(n, max_len, device=dev)
    eos = model.eos_id
    v = model.cfg.vocab_size
    eos_forced = torch.where(torch.arange(v, device=dev) == eos, 0.0,
                             NEG_INF)[None, :]
    batch_base = (torch.arange(b, device=dev) * w)[:, None]   # [B, 1]
    y_prev = torch.full((n,), model.sos_id, dtype=torch.long, device=dev)
    scores = torch.where(torch.arange(w, device=dev)[None, :] == 0, 0.0,
                         NEG_INF).repeat(b, 1)
    tokens = torch.full((b, w, max_len), eos, dtype=torch.long, device=dev)
    steps = min(int(n_fire.max()) + 1, max_len)
    for pos in range(steps):
        logits, cache = dec.step(y_prev, fired_flat[:, pos], pos, cache)
        logp = torch.log_softmax(logits.float(), dim=-1)
        done = (pos >= n_fire_flat)[:, None]
        logp = torch.where(done, eos_forced, logp)
        cand = (scores.reshape(n, 1) + logp).reshape(b, w * v)
        scores, top_idx = exact_top_k(cand, w)
        flat_beam = (batch_base + top_idx // v).reshape(n)
        tok = top_idx % v
        cache = {key: x.index_select(1, flat_beam) for key, x in cache.items()}
        tokens = tokens.reshape(n, -1)[flat_beam].reshape(b, w, -1)
        tokens[:, :, pos] = tok
        y_prev = tok.reshape(n)
    best = torch.argmax(scores, dim=1)
    toks = tokens[torch.arange(b, device=dev), best]
    tokens, lengths = _mask_output(toks, n_fire, eos, pad_id)
    return tokens, lengths, steps
