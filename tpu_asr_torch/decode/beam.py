"""Batched attention beam search with optional joint CTC/attention scoring
and LM shallow fusion (port of tpu_asr/decode/beam.py).

Static shapes as in the reference: fixed beam width W, fixed max_len,
explicit KV caches reordered by index_select at each step, eos-forced
continuation for finished hypotheses, and joint scoring through the
CTCPrefixScorer:  S = (1-l) * logP_att + l * logP_ctc, accumulated
incrementally (psi differences). With an external LM (models/lm.py) and
lm_weight b > 0, S += b * logP_lm: the LM advances once a step on the
same tokens through its cached `step_at`, and its caches are reordered
with the decoder's. In the joint search the candidates stay the
attention top-k (espnet's pre-beam); the LM only reweights them.

The reference's lax.while_loop becomes a Python loop over one step of
static shape (BeamSearch.step): the position is a device tensor, the
decoder and the LM attend over all max_len cache rows under a position
mask (Decoder.step_at, TransformerLM.step_at), and every piece of state
is updated in place in buffers that keep their storage from step to
step. So on the card the whole step is captured once per shape in a CUDA
graph (BeamGraphs, which the Recognizer owns) and replayed for every
step; on the CPU, and for callers that pass no BeamGraphs, the same step
runs eagerly. The early exit (stop once every hypothesis is finished)
reads a flag the step writes, on the host once a step: under a profiler
that read is the span beam.sync, and the rest of a step (on the card,
the replay) the span beam.step (utils.tracing).

A forced prompt (Whisper's language and task ids after its start token)
is fed to the decoder after sos and before the first scored step, in
the span beam.prompt: its positions fill the first rows of the
self-attention caches, the scored steps' decoder positions follow them,
and the hypotheses, their lengths and the length ratios count the
scored tokens alone. On the card the prompt is a CUDA graph of its own.
"""

from __future__ import annotations

import dataclasses
import math

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


class BeamSearch:
    """One search's state, in buffers that keep their storage from step
    to step, and its static-shape step.

    `alloc(name, shape, dtype)` gives the large buffers (the
    cross-attention K/V, the self-attention caches of the decoder and the
    LM, the CTC log-probs): BeamGraphs hands out views of storage it
    shares between shapes; without it they are allocated here. `load`
    writes a batch's inputs into the buffers and resets the state, then
    `write_prompt` feeds a forced prompt (`prompt`: the ids after sos),
    each `step` advances the search by one position in place, reading no
    Python value that changes from step to step, and `result` sorts the
    hypotheses out."""

    def __init__(self, decoder, lm, cfg: BeamConfig, b: int, t: int,
                 sos_id: int, eos_id: int, ctc_vocab: int | None, device,
                 alloc=None, prompt: tuple = ()):
        if alloc is None:
            def alloc(name, shape, dtype):
                return torch.empty(shape, dtype=dtype, device=device)
        if prompt and lm is not None:
            raise ValueError("LM fusion takes no forced prompt")
        w = cfg.beam
        n = b * w
        self.decoder, self.lm, self.cfg = decoder, lm, cfg
        self.b, self.w, self.n = b, w, n
        self.sos, self.eos = sos_id, eos_id
        self.prompt = tuple(prompt)
        self.device = torch.device(device)

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        def caches(owner, prefix, shape):
            return {key: alloc(f"{prefix}_{key}", shape, owner.cfg.dtype)
                    for key in ("k", "v")}
        # cross K/V: one row an utterance, which each step reads for all
        # of its beams
        self.cross_kv = caches(decoder, "cross",
                               decoder.cross_kv_shape(b, t))
        self.cache = caches(decoder, "cache", decoder.cache_shape(
            n, cfg.max_len + len(self.prompt)))
        self.lm_cache = (caches(lm, "lm", lm.cache_shape(n, cfg.max_len))
                         if lm else None)
        self.enc_lengths = empty((n,), torch.int32)
        self.scorer = None
        if cfg.ctc_weight > 0.0:
            self.ctc_logp = alloc("ctc_logp", (b, t, ctc_vocab),
                                  torch.float32)
            self.scorer = CTCPrefixScorer(self.ctc_logp, self.enc_lengths,
                                          blank=0, eos=eos_id, beams=w)
            self.ctc_r = empty((n, t, 2), torch.float32)
            self.ctc_psi = empty((n,), torch.float32)
        k_cand = cfg.ctc_cand or 2 * w
        self.k_cand = min(k_cand, ctc_vocab) if ctc_vocab else k_cand
        self.two_pass = (cfg.ctc_two_pass if cfg.ctc_two_pass is not None
                         else w >= CTC_TWO_PASS_BEAM)
        self.utt_maxlen = empty((b,), torch.int32)
        self.utt_minlen = empty((b,), torch.int32)
        self.batch_base = (torch.arange(b, device=device) * w)[:, None]
        # the state: pos counts the scored steps, dec_pos is the
        # decoder's position (pos itself without a prompt)
        self.pos = empty((1,), torch.long)
        self.dec_pos = empty((1,), torch.long) if self.prompt else self.pos
        self.y_prev = empty((n,), torch.long)
        self.scores = empty((b, w), torch.float32)
        self.finished = empty((b, w), torch.bool)
        self.lengths = empty((b, w), torch.int32)
        self.tokens = empty((b, w, cfg.max_len), torch.long)
        self.done = empty((), torch.bool)     # the early exit's flag

    def load(self, enc_out, enc_lengths, ctc_logp=None):
        """A batch's inputs into the buffers, then the state reset."""
        cfg, w = self.cfg, self.w
        self.decoder.write_cross_kv(enc_out, self.cross_kv)
        self.enc_lengths.copy_(enc_lengths.repeat_interleave(w))
        if self.scorer is not None:
            if ctc_logp.data_ptr() != self.ctc_logp.data_ptr():
                self.ctc_logp.copy_(ctc_logp)
            self.scorer.refresh()
        if cfg.maxlenratio > 0:
            self.utt_maxlen.copy_(torch.clamp(
                torch.floor(cfg.maxlenratio * enc_lengths).to(torch.int32),
                1, cfg.max_len))
        else:
            self.utt_maxlen.fill_(cfg.max_len)
        if cfg.minlenratio > 0:
            self.utt_minlen.copy_(torch.floor(
                cfg.minlenratio * enc_lengths).to(torch.int32))
        else:
            self.utt_minlen.zero_()
        self.reset()

    def reset(self):
        """The state of an empty search: position 0, sos, beam 0 alone
        alive, no hypothesis finished, eos-padded tokens, empty caches
        and the empty prefix's CTC state."""
        self.pos.zero_()
        self.dec_pos.zero_()
        self.y_prev.fill_(self.sos)
        self.scores.fill_(NEG_INF)
        self.scores[:, 0] = 0.0
        self.finished.zero_()
        self.lengths.zero_()
        self.tokens.fill_(self.eos)
        for cache in (self.cache, self.lm_cache or {}):
            for x in cache.values():
                x.zero_()
        if self.scorer is not None:
            r, psi = self.scorer.init_state()
            self.ctc_r.copy_(r)
            self.ctc_psi.copy_(psi)
        self.done.zero_()

    def write_prompt(self):
        """Feed sos and the prompt but its last id to the decoder, each
        at its position, into the self-attention caches of every row; the
        last id is the first scored step's input, at the position after
        them. Static shapes, in place: captured like a step."""
        fed = (self.sos,) + self.prompt[:-1]
        for i, tok in enumerate(fed):
            self.y_prev.fill_(tok)
            self.dec_pos.fill_(i)
            self.decoder.step_at(self.y_prev, self.dec_pos, self.cache,
                                 self.cross_kv, self.enc_lengths,
                                 beams=self.w)
        self.y_prev.fill_(self.prompt[-1])
        self.dec_pos.fill_(len(fed))

    def step(self):
        """Advance every hypothesis by one token, in place."""
        cfg, lam, eos_id = self.cfg, self.cfg.ctc_weight, self.eos
        b, w, n, dev = self.b, self.w, self.n, self.device
        pos, y_prev, finished = self.pos, self.y_prev, self.finished
        logits, _ = self.decoder.step_at(y_prev, self.dec_pos, self.cache,
                                         self.cross_kv, self.enc_lengths,
                                         beams=w)
        att_logp = torch.log_softmax(logits.float(), dim=-1)
        if self.lm is not None:
            lm_logits, _ = self.lm.step_at(y_prev, pos.expand(n),
                                           self.lm_cache)
            lm_logp = torch.log_softmax(lm_logits.float(), dim=-1)
        must_end = pos >= self.utt_maxlen[:, None]                  # [B, 1]
        ban_eos = pos < self.utt_minlen[:, None]                    # [B, 1]
        ended = finished | must_end                                 # [B, W]

        if self.scorer is not None:
            k_cand, scorer = self.k_cand, self.scorer
            k_tot = k_cand + 1
            cand_logp, cand_ids = exact_top_k(att_logp, k_cand)      # [N, K]
            cand_ids = torch.cat([cand_ids, torch.full(
                (n, 1), eos_id, dtype=cand_ids.dtype, device=dev)], dim=1)
            cand_logp = torch.cat([cand_logp, att_logp[:, eos_id, None]],
                                  dim=1)
            is_first = (pos == 0).expand(n)
            old_r, old_psi = self.ctc_r, self.ctc_psi
            psi, new_r = scorer.score(cand_ids, y_prev, is_first,
                                      (old_r, old_psi),
                                      return_r=not self.two_pass)
            step_score = ((1.0 - lam) * cand_logp
                          + lam * (psi - old_psi[:, None]))         # [N, K+1]
            if self.lm is not None:
                step_score = step_score + cfg.lm_weight * torch.gather(
                    lm_logp, 1, cand_ids)
            ban = (cand_ids == eos_id) & ban_eos.expand(b, w).reshape(n, 1)
            step_score = torch.where(ban, NEG_INF, step_score)
            # finished (or maxlen-forced) beams: only the eos slot
            # continues, at zero cost
            eos_slot = torch.arange(k_tot, device=dev)[None, :] == k_cand
            step_score = torch.where(
                ended.expand(b, w).reshape(n, 1),
                torch.where(eos_slot, 0.0, NEG_INF), step_score)
            cand = (self.scores.reshape(n, 1) + step_score).reshape(
                b, w * k_tot)
            top_scores, top_idx = exact_top_k(cand, w)              # [B, W]
            beam_idx = top_idx // k_tot
            slot_idx = top_idx % k_tot
            flat_beam = (self.batch_base + beam_idx).reshape(n)
            flat_slot = slot_idx.reshape(n)
            tok = cand_ids[flat_beam, flat_slot].reshape(b, w)
            psi_sel = psi[flat_beam, flat_slot]
            old_r_g = old_r[flat_beam]
            old_psi_g = old_psi[flat_beam]
            if self.two_pass:
                r_next, _ = scorer.advance(
                    tok.reshape(n), y_prev[flat_beam], is_first,
                    (old_r_g, old_psi_g))
            else:
                r_next = new_r[flat_beam, flat_slot]             # [N, T, 2]
            # finished/eos beams keep their old prefix state
            was_finished_g = torch.gather(finished, 1, beam_idx).reshape(n)
            keep_old = was_finished_g | (tok.reshape(n) == eos_id)
            self.ctc_r.copy_(torch.where(keep_old[:, None, None], old_r_g,
                                         r_next))
            self.ctc_psi.copy_(torch.where(keep_old, old_psi_g, psi_sel))
        else:
            fused = (att_logp + cfg.lm_weight * lm_logp
                     if self.lm is not None else att_logp)
            logp = fused.reshape(b, w, -1)
            v = logp.shape[-1]
            is_eos_col = torch.arange(v, device=dev)[None, None, :] == eos_id
            logp = torch.where(is_eos_col & ban_eos[..., None], NEG_INF,
                               logp)
            eos_forced = torch.where(is_eos_col, 0.0, NEG_INF)
            logp = torch.where(ended[..., None], eos_forced, logp)
            cand = (self.scores[..., None] + logp).reshape(b, w * v)
            top_scores, top_idx = exact_top_k(cand, w)
            beam_idx = top_idx // v
            tok = top_idx % v
            flat_beam = (self.batch_base + beam_idx).reshape(n)

        # reorder all per-beam state, each back into its own buffer
        for cache in (self.cache, self.lm_cache or {}):
            for x in cache.values():
                x.copy_(x.index_select(1, flat_beam))
        self.tokens.copy_(self.tokens.view(n, -1).index_select(
            0, flat_beam).view(b, w, -1))
        finished_g = torch.gather(finished, 1, beam_idx)
        lengths_g = torch.gather(self.lengths, 1, beam_idx)

        now_eos = tok == eos_id
        self.tokens.index_copy_(
            2, pos, torch.where(finished_g, eos_id, tok)[..., None])
        self.lengths.copy_(torch.where(
            finished_g, lengths_g, torch.where(now_eos, pos, pos + 1)))
        finished.copy_(finished_g | now_eos)
        self.scores.copy_(top_scores)
        y_prev.copy_(tok.reshape(n))
        pos.add_(1)
        if self.dec_pos is not pos:
            self.dec_pos.add_(1)
        # the early exit: once every hypothesis is finished, further
        # steps are output-neutral (eos continues at zero cost)
        self.done.copy_(finished.all())

    def result(self, steps: int) -> dict:
        """The hypotheses sorted best-first, in new tensors. Unfinished
        hyps at max_len keep their accumulated score; optional per-token
        length reward."""
        final = self.scores + self.cfg.length_penalty * self.lengths.float()
        order = torch.argsort(-final, dim=1, stable=True)
        tokens = self.tokens
        return {
            "tokens": torch.gather(tokens, 1,
                                   order[..., None].expand_as(tokens)),
            "scores": torch.gather(final, 1, order),
            "lengths": torch.gather(self.lengths, 1, order),
            "steps": steps,
        }


def _step_kernels():
    """(module, name) of each kernel wrapper a beam step can launch: each
    counts its launches in `.launches` of its module's name, which a
    replay of the captured step adds to."""
    from tpu_asr_torch.ops import ctc_prefix, flash_attention, layernorm
    return ((ctc_prefix, "ctc_prefix_scan"),
            (layernorm, "layer_norm_residual_fwd"),
            (flash_attention, "flash_attention_fwd"))


@dataclasses.dataclass(eq=False)
class _Captured:
    search: BeamSearch
    # torch.cuda.CUDAGraph of each captured method ("step", and
    # "write_prompt" where there is a prompt), and its kernel launches
    graphs: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)


class BeamGraphs:
    """CUDA graphs of the beam step (and of the forced prompt), one per
    step shape: captured the first time a shape is searched, then
    replayed for every step.

    A shape is a BeamSearch's (batch, encoder frames, CTC vocabulary,
    BeamConfig, sos/eos and prompt, decoder and LM). Every shape's large
    buffers view the front of one storage per buffer, sized for the
    largest shape seen: a larger one regrows that storage and drops the
    graphs, which are captured again on their next use. The graphs share
    one memory pool. Both are safe because one thread searches at a time
    (a Recognizer decodes one batch after another). `captures` counts
    the captures."""

    def __init__(self):
        self._storage: dict[str, torch.Tensor] = {}
        self._shapes: dict[tuple, _Captured] = {}
        self._pool = None
        self.captures = 0

    def buffer(self, name: str, shape: tuple, dtype, device):
        """The view of `name`'s storage as a `shape` tensor."""
        numel = math.prod(shape)
        flat = self._storage.get(name)
        if flat is None or flat.numel() < numel or flat.dtype != dtype \
                or flat.device != torch.device(device):
            if self._shapes:
                # the graphs read the old storage: let them finish, then
                # drop them and it before the new one is allocated; their
                # pool goes with the last of them, so the next capture
                # takes a new one
                torch.cuda.synchronize(device)
                self._shapes.clear()
                self._pool = None
            self._storage.pop(name, None)
            del flat
            flat = self._storage[name] = torch.empty(numel, dtype=dtype,
                                                     device=device)
        return flat[:numel].view(shape)

    def ctc_logp_buffer(self, shape: tuple, device):
        """Where the CTC log-probs [B, T, V] of the next search of that
        shape go: writing them here spares the search's copy."""
        return self.buffer("ctc_logp", shape, torch.float32, device)

    def search(self, decoder, lm, cfg, b, t, sos_id, eos_id, ctc_vocab,
               device, prompt: tuple = ()) -> _Captured:
        key = (b, t, ctc_vocab, cfg, sos_id, eos_id, tuple(prompt),
               id(decoder), id(lm))
        entry = self._shapes.get(key)
        if entry is None:
            search = BeamSearch(
                decoder, lm, cfg, b, t, sos_id, eos_id, ctc_vocab, device,
                alloc=lambda name, shape, dt: self.buffer(name, shape, dt,
                                                          device),
                prompt=prompt)
            entry = self._shapes[key] = _Captured(search)
        return entry

    def step(self, entry: _Captured, what: str = "step") -> bool:
        """One call of entry's search's method `what` ("step" or
        "write_prompt"): a replay of its graph (True), or, the first
        time, the method run eagerly on a side stream (which also builds
        and loads what it launches) and then captured (False). The kernel
        counters count the launches of every call the device runs and
        none of the capture's."""
        graph = entry.graphs.get(what)
        if graph is not None:
            graph.replay()
            for (module, name), k in entry.launches[what].items():
                getattr(module, name).launches += k
            return True
        search = entry.search
        run = getattr(search, what)
        main = torch.cuda.current_stream(search.device)
        side = torch.cuda.Stream(search.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            run()
        main.wait_stream(side)
        kernels = _step_kernels()
        before = [getattr(m, name).launches for m, name in kernels]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread-local: a server's other threads may call into CUDA
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            run()
        launches = entry.launches[what] = {}
        for (module, name), n in zip(kernels, before):
            fn = getattr(module, name)
            if fn.launches != n:
                launches[module, name] = fn.launches - n
                fn.launches = n
        entry.graphs[what] = graph
        self.captures += 1
        return False


def attention_beam_search(decoder, enc_out: torch.Tensor,
                          enc_lengths: torch.Tensor, sos_id: int, eos_id: int,
                          cfg: BeamConfig = BeamConfig(),
                          ctc_logp: torch.Tensor | None = None, lm=None,
                          graphs: BeamGraphs | None = None,
                          prompt: tuple = ()):
    """Run beam search over a batch of utterances.

    decoder: tpu_asr_torch.models.decoder.Decoder; enc_out [B, T, D];
    ctc_logp [B, T, V] (log-softmaxed) required when cfg.ctc_weight > 0;
    lm: a models.lm.TransformerLM, fused when cfg.lm_weight > 0 (without
    one, the search runs as with lm_weight 0, as the reference's does);
    graphs: a BeamGraphs on the card, to replay the step as a CUDA graph
    (None: the same step runs eagerly); prompt: ids forced after sos
    before the first scored step (BeamSearch.write_prompt).

    Returns dict(tokens [B, W, max_len] eos-padded, scores [B, W],
    lengths [B, W]) sorted best-first, steps (decode steps taken) and
    graph_steps (those replayed from a graph).
    """
    b, t, _ = enc_out.shape
    dev = enc_out.device
    if cfg.ctc_weight > 0.0 and ctc_logp is None:
        raise ValueError("joint scoring needs ctc log-probs")
    if not (cfg.lm_weight > 0.0 and lm is not None):
        lm = None
    ctc_vocab = ctc_logp.shape[-1] if ctc_logp is not None else None
    if graphs is None:
        search = BeamSearch(decoder, lm, cfg, b, t, sos_id, eos_id,
                            ctc_vocab, dev, prompt=prompt)

        def run(what="step"):
            getattr(search, what)()
            return False
    else:
        entry = graphs.search(decoder, lm, cfg, b, t, sos_id, eos_id,
                              ctc_vocab, dev, prompt=prompt)
        search = entry.search

        def run(what="step"):
            return graphs.step(entry, what)
    search.load(enc_out, enc_lengths, ctc_logp)
    if prompt:
        with span("beam.prompt"):
            run("write_prompt")

    steps = graph_steps = 0
    # bool() here is the one host sync a step, in its own span
    # (beam.sync) beside the step's (beam.step)
    while steps < cfg.max_len:
        with span("beam.sync"):
            done = bool(search.done)
        if done:
            break
        with span("beam.step"):
            graph_steps += run()
        steps += 1
    out = search.result(steps)
    out["graph_steps"] = graph_steps
    return out
