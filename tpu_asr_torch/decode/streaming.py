"""Streaming recognition over the chunk-masked encoder (port of
tpu_asr/decode/streaming.py).

Features arrive a push at a time and tokens come back as soon as the
audio that decides them is in:

- StreamingCTCRecognizer: greedy CTC; `push` returns the newly final
  tokens, with each token's emission frame and max posterior;
- StreamingCTCBeamRecognizer: the CTC prefix beam (decode/ctc_beam.py
  `beam_advance`, LM fusion riding its state); `push` returns the
  current 1-best, which later audio may revise;
- StreamingCIFRecognizer: integrate-and-fire on the unscaled alphas, a
  decoder step a fire, tail rounding at the end;
- StreamingTransducerRecognizer: the greedy transducer search
  (decode/transducer_decode.py `greedy_advance`) a chunk at a time.

A streamed hypothesis equals the offline decode of the same chunk-masked
model because the conv2d front-end is VALID (encoder frame j reads input
frames 4j .. 4j+6 only), the chunk mask keeps a frame from attending past
its chunk's end (masked terms are exp(-1e30) = 0), and the searches are
frame-synchronous. The encoder's frames are equal up to rounding, not
bitwise: a GEMM over a chunk's C rows and one over all T' rows may round
differently in torch (oneDNN and cuBLAS alike). So frames are held to a
stated tolerance and tokens to equality.

For a chunked model (enc_chunk_size > 0) the default is incremental:
`Encoder.encode_chunk` on per-layer KV caches, O(C * t_max) a chunk.
`incremental=False` (CTC greedy and CIF) re-runs the full encoder over
every frame received at each push: the only path of a full-context model,
and the oracle the incremental path is tested against. Feed features
that were normalized without looking ahead (global CMVN): per-utterance
CMVN reads the whole utterance.

Each recognizer runs on `device` (None: the CUDA card, RuntimeError
without one; "cpu" when asked) under torch.inference_mode, since grad mode
is per thread and the server pushes from its handler threads. Device
results come to the host once a chunk (CTC greedy; the CIF rows and
alphas) or once a push (the beam's 1-best, the transducer's tokens, the
CIF decoder's tokens).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_asr_torch.decode.ctc_beam import (beam_advance, beam_finalize,
                                           beam_init)
from tpu_asr_torch.decode.recognizer import _to_host
from tpu_asr_torch.decode.transducer_decode import greedy_advance, greedy_init
from tpu_asr_torch.models.cif import ASSIGNER_LOOKAHEAD
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.weights import cast_for_inference


def make_streaming_recognizer(cfg, model, beam: int = 1, **kw):
    """The streaming recognizer of cfg.model_type: the transducer's, the
    CIF one, or for ctc/hybrid the CTC prefix beam (beam > 1) or greedy
    CTC; kw go to its constructor (max_frames, device, ...)."""
    if cfg.model_type == "transducer":
        return StreamingTransducerRecognizer(cfg, model, **kw)
    if cfg.model_type == "cif":
        return StreamingCIFRecognizer(cfg, model, **kw)
    if beam > 1:
        return StreamingCTCBeamRecognizer(cfg, model, beam=beam, **kw)
    return StreamingCTCRecognizer(cfg, model, **kw)


@dataclasses.dataclass(eq=False)
class _Stream:
    """What the four recognizers share: the model on its device, the
    feature buffer, and the chunk encoder's caches and windows."""
    cfg: ModelConfig
    model: torch.nn.Module
    max_frames: int = 2000

    def _start(self, device, chunked: bool):
        if self.cfg.input_layer != "conv2d":
            raise ValueError("streaming needs the conv2d front-end (the "
                             "LFR+linear input layer is offline)")
        chunk = self.cfg.enc_chunk_size
        if chunked and chunk <= 0:
            raise ValueError("chunk-by-chunk streaming needs a chunk-masked "
                             "encoder (enc_chunk_size > 0)")
        self.device = resolve_device(device)
        self.model = cast_for_inference(self.model.to(self.device).eval(),
                                        self.cfg.dtype)
        self._win = self.cfg.conv_input_window(chunk) if chunked else 0
        self._buf = np.zeros((self.max_frames + self._win, self.cfg.d_input),
                             np.float32)
        self._n = 0                   # received feature frames
        self._finished = False
        if chunked:
            t_max = -(-self._enc_len(self.max_frames) // chunk) * chunk
            self._t_max = t_max
            self._caches = self.model.encoder.init_cache(1, t_max,
                                                         self.device)
            self._chunks_done = 0

    def _enc_len(self, n: int) -> int:
        return max(int(self.cfg.subsampled_length(n)), 0)

    def _final_chunked(self, n: int) -> int:
        """Encoder frames that no later frame can change, n received."""
        chunk = self.cfg.enc_chunk_size
        return (self._enc_len(n) // chunk) * chunk if chunk > 0 else 0

    def _append(self, frames) -> None:
        if self._finished:
            raise RuntimeError("push() after finish()")
        frames = np.asarray(frames, np.float32).reshape(-1, self.cfg.d_input)
        t = frames.shape[0]
        if self._n + t > self.max_frames:
            raise ValueError(f"the stream exceeds max_frames "
                             f"{self.max_frames}")
        self._buf[self._n:self._n + t] = frames
        self._n += t

    def _encode_chunk(self, k: int, el: int) -> torch.Tensor:
        """Encoder frames of chunk k ([1, C, d_model]); the caches advance."""
        start = self.cfg.conv_total_stride * k * self.cfg.enc_chunk_size
        window = torch.from_numpy(self._buf[None, start:start + self._win])
        out, self._caches = self.model.encoder.encode_chunk(
            window.to(self.device), k, self._caches, valid_upto=el)
        return out

    def _received(self) -> tuple[torch.Tensor, torch.Tensor]:
        """All frames received so far, [1, n, D] and [1], on the device."""
        feats = torch.from_numpy(self._buf[None, :self._n]).to(self.device)
        return feats, torch.tensor([self._n], device=self.device)


def _max_posterior(logits: torch.Tensor) -> torch.Tensor:
    """max softmax of each row, exp(max - logsumexp), in float32."""
    lf = logits.float()
    return torch.exp(lf.max(dim=-1).values - torch.logsumexp(lf, dim=-1))


@dataclasses.dataclass(eq=False)
class StreamingCTCRecognizer(_Stream):
    """Incremental greedy CTC for ctc/hybrid models.

        rec = StreamingCTCRecognizer(cfg, model, max_frames=2000)
        for chunk in feature_chunks:          # [t_i, D] each, any sizes
            new = rec.push(chunk)             # newly final token ids
        hyp = rec.finish()                    # the whole hypothesis

    `hypothesis_times` are the tokens' emission encoder frames and
    `hypothesis_confidence` the max frame posterior there, rounded to 4
    places, as the offline greedy_ctc gives them."""
    blank: int = 0
    incremental: bool | None = None   # None: True for a chunked model
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.cfg.model_type not in ("ctc", "hybrid"):
            raise ValueError(f"streaming CTC needs a CTC head (model_type="
                             f"{self.cfg.model_type})")
        if self.incremental is None:
            self.incremental = self.cfg.enc_chunk_size > 0
        self._start(self.device, self.incremental)
        self._emitted_enc = 0        # encoder frames already emitted
        self._prev_id = self.blank   # the CTC collapse across pushes
        self._tokens: list[int] = []
        self._times: list[int] = []
        self._confs: list[float] = []

    def _ids(self, enc_out) -> tuple[torch.Tensor, torch.Tensor]:
        logits = self.model.ctc_logits(enc_out)[0]
        return logits.argmax(dim=-1), _max_posterior(logits)

    def _new_ids(self, upto: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (argmax ids, max posteriors) of encoder frames
        [_emitted_enc, upto), on the host."""
        if not self.incremental:
            enc_out, _ = self.model.encode(*self._received())
            ids, probs = self._ids(enc_out)
            return _to_host(ids[self._emitted_enc:upto],
                            probs[self._emitted_enc:upto])
        chunk = self.cfg.enc_chunk_size
        el = self._enc_len(self._n)
        got, got_p = [], []
        while self._chunks_done * chunk < upto:
            k = self._chunks_done
            ids, probs = self._ids(self._encode_chunk(k, el))
            take = min(chunk, upto - k * chunk)
            gi, gp = _to_host(ids[:take], probs[:take])   # once a chunk
            got.append(gi)
            got_p.append(gp)
            self._chunks_done += 1
        if not got:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        return np.concatenate(got), np.concatenate(got_p)

    def _emit(self, upto: int) -> list[int]:
        if upto <= self._emitted_enc:
            return []
        ids, probs = self._new_ids(upto)
        out = []
        base = self._emitted_enc
        for j, i in enumerate(ids):
            i = int(i)
            if i != self.blank and i != self._prev_id:
                out.append(i)
                self._times.append(base + j)
                self._confs.append(round(float(probs[j]), 4))
            self._prev_id = i
        self._emitted_enc = upto
        self._tokens.extend(out)
        return out

    @torch.inference_mode()
    def push(self, frames) -> list[int]:
        """Append [t, D] feature frames; return the newly final tokens."""
        self._append(frames)
        return self._emit(self._final_chunked(self._n))

    @torch.inference_mode()
    def finish(self) -> list[int]:
        """Decode the tail (the last partial chunk) and return the whole
        hypothesis; no push may follow."""
        if not self._finished:
            self._emit(self._enc_len(self._n))
            self._finished = True
        return list(self._tokens)

    @property
    def hypothesis(self) -> list[int]:
        return list(self._tokens)

    @property
    def hypothesis_times(self) -> list[int]:
        """Each token's emission encoder frame."""
        return list(self._times)

    @property
    def hypothesis_confidence(self) -> list[float]:
        """Each token's max frame posterior at its emission frame."""
        return list(self._confs)


@dataclasses.dataclass(eq=False)
class StreamingCTCBeamRecognizer(_Stream):
    """Streaming CTC prefix beam search over the chunked encoder: the
    frame-synchronous search state (decode/ctc_beam.py) is the carry
    across chunks, so the final result equals the offline
    ctc_prefix_beam_search of the whole utterance. `push` returns the
    CURRENT 1-best, which later audio may revise.

    lm (a models.lm.TransformerLM over the model's vocabulary) with
    lm_weight > 0 fuses the LM: its scores, next-token log-probs and
    caches ride the same state (ctc_beam.LMFusion)."""
    beam: int = 5
    topk: int = 8
    max_tokens: int = 200
    blank: int = 0
    lm: torch.nn.Module | None = None
    lm_weight: float = 0.0
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.cfg.model_type not in ("ctc", "hybrid"):
            raise ValueError("the streaming beam needs a CTC head")
        self._start(self.device, chunked=True)
        lm = None
        if self.lm is not None and self.lm_weight > 0.0:
            if self.lm.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(f"LM vocab {self.lm.cfg.vocab_size} != "
                                 f"model vocab {self.cfg.vocab_size}")
            lm = cast_for_inference(self.lm.to(self.device).eval(),
                                    self.lm.cfg.dtype)
        self.lm = lm
        with torch.inference_mode():
            self._bstate = beam_init(1, self.beam, self.max_tokens,
                                     device=self.device, lm=lm,
                                     lm_weight=self.lm_weight,
                                     sos=self.cfg.vocab_size - 2)

    def _advance(self, upto: int):
        chunk = self.cfg.enc_chunk_size
        el = self._enc_len(self._n)
        while self._chunks_done * chunk < upto:
            k = self._chunks_done
            logp = torch.log_softmax(self.model.ctc_logits(
                self._encode_chunk(k, el)).float(), dim=-1)
            frames = k * chunk + torch.arange(chunk, device=self.device)
            self._bstate = beam_advance(self._bstate, logp,
                                        (frames < el)[None], topk=self.topk,
                                        blank=self.blank)
            self._chunks_done += 1

    def current_best(self) -> list[int]:
        toks, lens, _ = beam_finalize(self._bstate)
        row, n = _to_host(toks[0, 0], lens[0, :1])
        return [int(x) for x in row[:int(n[0])]]

    @torch.inference_mode()
    def push(self, frames) -> list[int]:
        """Append [t, D] frames; return the current 1-best (it may revise
        what an earlier push returned)."""
        self._append(frames)
        self._advance(self._final_chunked(self._n))
        return self.current_best()

    @torch.inference_mode()
    def finish(self) -> list[int]:
        if not self._finished:
            self._advance(self._enc_len(self._n))
            self._finished = True
        return self.current_best()


@dataclasses.dataclass(eq=False)
class StreamingCIFRecognizer(_Stream):
    """Incremental CIF: token-synchronous integrate-and-fire (Dong & Xu,
    arXiv:1905.11235, online mode). Alphas accumulate frame by frame on
    the host in float32; each time the integral crosses 1 the integrated
    embedding fires and the causal decoder emits one token. Firing uses
    the UNSCALED alphas (scaling needs the whole utterance), with tail
    rounding at the end (a residual >= cif_tail_threshold fires once
    more), so the result equals cif_greedy_decode with scale_fire=False.

    The assigner's SAME conv gives alpha_j a lookahead of
    ASSIGNER_LOOKAHEAD frames (models/cif.py), so after n frames the
    final alphas are those before (el(n) // C) * C - lookahead. The
    incremental path runs the assigner over a halo window of C + 2
    lookahead rows of the host mirror of the encoder rows (zeros past the
    stream's length, as the offline pass's padding), and keeps a host
    mirror of the alphas. The decoder steps of a push run back to back
    on the device, their tokens fetched once; eos and max_tokens end the
    decoding as in the reference's loop."""
    max_tokens: int = 200
    incremental: bool | None = None   # None: True for a chunked model
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.cfg.model_type != "cif":
            raise ValueError(f"StreamingCIFRecognizer needs model_type=cif "
                             f"(got {self.cfg.model_type})")
        if self.incremental is None:
            self.incremental = self.cfg.enc_chunk_size > 0
        self._start(self.device, self.incremental)
        self._la = ASSIGNER_LOOKAHEAD
        self._alpha_done = 0          # alpha frames already integrated
        self._accum = np.float32(0.0)  # the integrate-and-fire carry
        self._acc_vec = np.zeros(self.cfg.d_model, np.float32)
        with torch.inference_mode():
            self._cache = self.model.decoder.init_cache(1, self.max_tokens,
                                                        self.device)
        self._pos = 0
        self._prev = self.cfg.vocab_size - 2      # <sos>
        self._eos = self.cfg.vocab_size - 1
        self._saw_eos = False
        self._tokens: list[int] = []
        if self.incremental:
            # host mirrors (+C zero rows: the tail's halo reads past the
            # last chunk)
            chunk = self.cfg.enc_chunk_size
            self._enc_np = np.zeros((self._t_max + chunk, self.cfg.d_model),
                                    np.float32)
            self._alpha_np = np.zeros(self._t_max + chunk, np.float32)

    def _final_alpha_frames(self, n: int) -> int:
        return max(self._final_chunked(n) - self._la, 0)

    def _store_chunk_rows(self, k: int, el: int):
        chunk = self.cfg.enc_chunk_size
        lo = k * chunk
        (rows,) = _to_host(self._encode_chunk(k, el)[0])
        self._enc_np[lo:lo + chunk] = rows
        if el < lo + chunk:       # conv garbage past the stream's length
            self._enc_np[max(el, lo):lo + chunk] = 0.0

    def _alpha_pass(self, k: int):
        """Alphas of frames [kC - la, (k+1)C - la) from the halo rows
        [kC - 2 la, (k+1)C) of the mirror (zeros before the stream)."""
        chunk, la = self.cfg.enc_chunk_size, self._la
        width = chunk + 2 * la
        lo = k * chunk - 2 * la
        win = np.zeros((1, width, self.cfg.d_model), np.float32)
        s = max(lo, 0)
        win[0, s - lo:] = self._enc_np[s:lo + width]
        rows = torch.from_numpy(win).to(self.device)
        alphas, _ = self.model.assigner(
            rows.to(self.cfg.dtype), torch.tensor([width],
                                                  device=self.device))
        (al,) = _to_host(alphas[0])
        for i in range(la, chunk + la):
            if lo + i >= 0:
                self._alpha_np[lo + i] = al[i]

    def _extend_incremental(self, upto: int, el: int):
        """Make the mirrors cover alpha frames [0, upto)."""
        chunk = self.cfg.enc_chunk_size
        while (self._chunks_done + 1) * chunk <= el:
            self._store_chunk_rows(self._chunks_done, el)
            self._alpha_pass(self._chunks_done)
            self._chunks_done += 1
        if upto > max(self._chunks_done * chunk - 1, 0):   # finishing
            if self._chunks_done * chunk < el:             # partial chunk
                self._store_chunk_rows(self._chunks_done, el)
            self._alpha_pass(self._chunks_done)            # tail alphas

    def _decode(self, vecs: list[np.ndarray]) -> list[int]:
        """One decoder step per fired vector while no eos was emitted and
        pos < max_tokens; the steps run back to back on the device and
        their tokens come to the host once. -> the emitted tokens."""
        n = 0 if self._saw_eos else min(len(vecs),
                                        self.max_tokens - self._pos)
        if n <= 0:
            return []
        fired = torch.from_numpy(np.stack(vecs[:n])).to(self.device)
        prev = torch.tensor([self._prev], device=self.device)
        steps = []
        for i in range(n):
            logits, self._cache = self.model.decoder.step(
                prev, fired[i:i + 1], self._pos + i, self._cache)
            prev = logits.argmax(dim=-1)
            steps.append(prev)
        (toks,) = _to_host(torch.cat(steps))
        out = []
        for tok in toks:
            tok = int(tok)
            self._prev = tok
            self._pos += 1
            if tok == self._eos:
                self._saw_eos = True
                break
            out.append(tok)
        self._tokens.extend(out)
        return out

    def _integrate(self, upto: int) -> list[int]:
        """Accumulate and fire over alpha frames [_alpha_done, upto) on
        the host in float32, then decode the fired vectors. -> the newly
        emitted tokens."""
        if upto <= self._alpha_done:
            return []
        if self.incremental:
            self._extend_incremental(upto, self._enc_len(self._n))
            enc, alphas = self._enc_np, self._alpha_np
        else:
            enc_out, _, alphas, _ = self.model.encode(*self._received())
            enc, alphas = _to_host(enc_out[0].float(), alphas[0])
        one = np.float32(1.0)
        accum, acc_vec = self._accum, self._acc_vec
        fired = []
        for j in range(self._alpha_done, upto):
            a, h = alphas[j], enc[j]
            if accum + a >= one:
                a1 = one - accum          # the weight that completes it
                fired.append(acc_vec + a1 * h)
                accum = a - a1
                acc_vec = accum * h
            else:
                accum = accum + a
                acc_vec = acc_vec + a * h
        self._accum, self._acc_vec = accum, acc_vec
        self._alpha_done = upto
        return self._decode(fired)

    @torch.inference_mode()
    def push(self, frames) -> list[int]:
        """Append [t, D] feature frames; return the newly emitted tokens."""
        self._append(frames)
        return self._integrate(self._final_alpha_frames(self._n))

    @torch.inference_mode()
    def finish(self) -> list[int]:
        """Integrate the tail, round it, and return the whole hypothesis."""
        if not self._finished:
            self._integrate(self._enc_len(self._n))
            if self._accum >= self.cfg.cif_tail_threshold:
                self._decode([self._acc_vec])
            self._finished = True
        return list(self._tokens)

    @property
    def hypothesis(self) -> list[int]:
        return list(self._tokens)


@dataclasses.dataclass(eq=False)
class StreamingTransducerRecognizer(_Stream):
    """Streaming greedy RNN-T over the chunked encoder. The search state
    of decode/transducer_decode.py (label count, predictor caches, the
    last joint projection g, the token, time and confidence buffers) is
    the carry across chunks, so the streamed hypothesis equals the
    offline transducer_greedy_decode on the same model. Emissions are
    append-only: `push` returns the newly final tokens."""
    max_tokens: int = 200
    max_symbols_per_frame: int = 4
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.cfg.model_type != "transducer":
            raise ValueError(f"needs model_type=transducer (got "
                             f"{self.cfg.model_type})")
        self._start(self.device, chunked=True)
        with torch.inference_mode():
            self._tstate = greedy_init(self.model, 1, self.max_tokens,
                                       device=self.device)
        self._u = 0                   # tokens returned so far

    def _advance(self, upto: int) -> list[int]:
        chunk = self.cfg.enc_chunk_size
        el = self._enc_len(self._n)
        ran = False
        while self._chunks_done * chunk < upto:
            k = self._chunks_done
            f = self.model.enc_features(self._encode_chunk(k, el))
            n_local = torch.tensor([min(max(el - k * chunk, 0), chunk)],
                                   device=self.device)
            self._tstate, _ = greedy_advance(
                self.model, f, n_local, self._tstate,
                self.max_symbols_per_frame, frame_offset=k * chunk)
            self._chunks_done += 1
            ran = True
        if not ran:
            return []
        u, toks = _to_host(self._tstate["u"], self._tstate["tokens"][0])
        new = [int(x) for x in toks[self._u:int(u[0])]]
        self._u = int(u[0])
        return new

    @torch.inference_mode()
    def push(self, frames) -> list[int]:
        """Append [t, D] feature frames; return the newly final tokens."""
        self._append(frames)
        return self._advance(self._final_chunked(self._n))

    @torch.inference_mode()
    def finish(self) -> list[int]:
        """Decode the tail partial chunk; return the whole hypothesis."""
        if not self._finished:
            self._advance(self._enc_len(self._n))
            self._finished = True
        return self.hypothesis

    def _fetch(self, key: str) -> np.ndarray:
        u, row = _to_host(self._tstate["u"], self._tstate[key][0])
        return row[:int(u[0])]

    @property
    def hypothesis(self) -> list[int]:
        return [int(x) for x in self._fetch("tokens")]

    @property
    def hypothesis_times(self) -> list[int]:
        """Each token's emission encoder frame (x the conv stride x 10 ms
        for seconds)."""
        return [int(x) for x in self._fetch("times")]

    @property
    def hypothesis_confidence(self) -> list[float]:
        """Each token's emission probability (softmax of the emitted
        token), rounded to 4 places."""
        return [round(float(x), 4) for x in self._fetch("confs")]
