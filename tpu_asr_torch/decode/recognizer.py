"""High-level batched recognizer: padded batches -> hypothesis tokens
(port of tpu_asr/decode/recognizer.py).

Modes: greedy_ctc and ctc_beam (CTC prefix beam search) for the models
with a CTC head (a transducer's aux head included), joint (CTC/attention
beam) and beam (the same loop with ctc_weight = 0) for those with an
attention decoder, attn_rescore (the CTC n-best rescored by one
teacher-forced decoder pass) for the hybrid model, cif_greedy and
cif_beam for the CIF model, transducer_greedy (with times and
confidences), transducer_beam (ALSD) and transducer_rescore (the aux-CTC
n-best ranked by the transducer marginal, beam.ctc_weight) for the
transducer. An external LM (models/lm.py) fuses into beam, joint,
ctc_beam and transducer_beam and rescores attn_rescore's n-best,
weighted by beam.lm_weight.

With a mesh (parallel.make_mesh, data axis only, as in the reference),
every rank is handed the same batches, decodes its rows of each at the
batch's padded shape, and the n-best lists are gathered in row order
(all_gather_object over the data axis, once per window of
decode_batches_nbest), so every rank returns the whole batch's n-best.
Every decode mode is per-utterance, so the rows decode as they would in
the whole batch. Bucket batch sizes must be multiples of the data axis
(make_buckets(batch_multiple=...)).

Under a profiler, a batch's phases are spans (utils.tracing):
recognizer.features, recognizer.encode (with the joint mode's CTC
log-softmax), the beam loop's beam.step and beam.sync (decode/beam.py),
and recognizer.fetch (the one copy to the host and the n-best lists).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
from tpu_asr_torch.decode.cif_decode import cif_beam_decode, cif_greedy_decode
from tpu_asr_torch.decode.ctc_beam import ctc_prefix_beam_search
from tpu_asr_torch.decode.greedy_ctc import ctc_greedy_decode
from tpu_asr_torch.decode.rescore import attention_rescore
from tpu_asr_torch.decode.transducer_decode import (transducer_beam_search,
                                                    transducer_greedy_decode,
                                                    transducer_rescore)
from tpu_asr_torch.frontend import (FrontendConfig, build_lfr_features,
                                    cmvn_stats_for, lfr_length,
                                    wav_to_features)
from tpu_asr_torch.models.cif import CifModel
from tpu_asr_torch.models.lm import LMConfig, TransformerLM
from tpu_asr_torch.models.transducer import TransducerModel
from tpu_asr_torch.models.transformer import Transformer
from tpu_asr_torch.parallel.mesh import shard_batch
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.utils.tracing import span
from tpu_asr_torch.weights import cast_for_inference

TRANSDUCER_MODES = ("transducer_greedy", "transducer_beam",
                    "transducer_rescore")
MODES = ("greedy_ctc", "ctc_beam", "beam", "joint", "attn_rescore",
         "cif_greedy", "cif_beam") + TRANSDUCER_MODES
LM_MODES = ("beam", "joint", "attn_rescore", "ctc_beam", "transducer_beam")
CTC_WEIGHT_MODES = ("joint", "attn_rescore", "transducer_rescore")


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy int32/float32 tensors to the host with ONE device->host
    transfer: floats travel as their int32 bit patterns in one buffer."""
    flat = [(x.float().view(torch.int32) if x.is_floating_point()
             else x.to(torch.int32)).reshape(-1) for x in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for x in tensors:
        part = host[at: at + x.numel()].reshape(tuple(x.shape))
        at += x.numel()
        out.append(part.view(np.float32) if x.is_floating_point() else part)
    return out


@dataclasses.dataclass(eq=False)
class Recognizer:
    """cfg + a tpu_asr_torch Transformer, CifModel or TransducerModel ->
    batched decode on `device`.

    device None means the CUDA card (RuntimeError when there is none);
    pass device="cpu" to run on the CPU. The model is moved to the device
    and its matmul weights are stored in the compute dtype. lm_cfg + lm
    (a TransformerLM) is the external LM, used when beam.lm_weight > 0
    (in LM_MODES, over the model's vocabulary); it is moved and cast
    likewise, to its own config's dtype."""
    cfg: object
    model: Transformer | CifModel | TransducerModel
    beam: BeamConfig = BeamConfig()
    mode: str = "beam"   # one of MODES
    frontend: FrontendConfig = FrontendConfig()
    device: str | torch.device | None = None
    # CIF fire-time alphas: True = scaled to the rounded fire count (the
    # boundary geometry of training); False = the reference's raw alphas
    cif_scale_fire: bool = True
    lm_cfg: LMConfig | None = None
    lm: TransformerLM | None = None
    mesh: object | None = None   # parallel.Mesh: data-parallel decode

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown decode mode {self.mode!r}")
        mt = self.cfg.model_type
        aux_ctc = mt == "transducer" and self.cfg.ctc_weight > 0.0
        if self.mode in ("greedy_ctc", "ctc_beam", "joint") and not (
                mt in ("ctc", "hybrid") or
                (aux_ctc and self.mode != "joint")):
            raise ValueError(f"mode {self.mode} needs a CTC head "
                             f"(model_type={mt})")
        if self.mode == "attn_rescore" and mt != "hybrid":
            raise ValueError(f"mode attn_rescore needs a CTC head and a "
                             f"decoder (model_type={mt})")
        if self.mode in ("beam", "joint") and mt not in ("transformer",
                                                         "hybrid"):
            raise ValueError(f"mode {self.mode} needs an attention decoder "
                             f"(model_type={mt})")
        if self.mode in ("cif_greedy", "cif_beam") and mt != "cif":
            raise ValueError(f"mode {self.mode} needs model_type=cif "
                             f"(model_type={mt})")
        if self.mode in TRANSDUCER_MODES and mt != "transducer":
            raise ValueError(f"mode {self.mode} needs model_type=transducer"
                             f" (model_type={mt})")
        if self.mode == "transducer_rescore" and not aux_ctc:
            raise ValueError("transducer_rescore needs the aux CTC head "
                             "(ctc_weight > 0)")
        if self.mesh is not None and self.mesh.n_model != 1:
            raise ValueError("data-parallel decode takes a mesh with a "
                             "data axis only (n_model 1)")
        if (self.lm_cfg is None) != (self.lm is None):
            raise ValueError("lm_cfg and lm go together")
        if self.lm is not None and self.beam.lm_weight > 0.0:
            if self.mode not in LM_MODES:
                raise ValueError(f"LM fusion is not supported in mode "
                                 f"{self.mode} (only {LM_MODES})")
            if self.lm_cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(f"LM vocab {self.lm_cfg.vocab_size} != "
                                 f"model vocab {self.cfg.vocab_size}")
        else:
            self.lm = None       # as the reference: no weight, no LM
        self.device = resolve_device(self.device)
        self.cmvn_stats = cmvn_stats_for(self.frontend, self.device)
        self.model = cast_for_inference(self.model.to(self.device).eval(),
                                        self.cfg.dtype)
        if self.lm is not None:
            self.lm = cast_for_inference(self.lm.to(self.device).eval(),
                                         self.lm_cfg.dtype)
        self.decode_steps = 0    # decoder/transducer steps, all batches

    # --- device work ---

    def _features(self, batch):
        """A wav or feats batch -> (feats, lengths) on the device, LFR
        stacked for a linear-input model (span recognizer.features)."""
        def tensor(key):
            return torch.as_tensor(batch[key], device=self.device)
        with span("recognizer.features"):
            if "wav" in batch:
                feats, lens = wav_to_features(
                    tensor("wav"), tensor("wav_lengths"), self.frontend,
                    cmvn_stats=self.cmvn_stats)
            else:
                feats, lens = tensor("feats").float(), tensor("feat_lengths")
            # the reference's own condition
            # (tpu_asr/decode/recognizer.py:106), kept on purpose;
            # train.loop.model_lfr also stacks (1, n > 1)
            if self.cfg.input_layer == "linear" and self.cfg.lfr_m > 1:
                feats = build_lfr_features(feats, self.cfg.lfr_m,
                                           self.cfg.lfr_n)
                lens = lfr_length(lens, self.cfg.lfr_n)
        return feats, lens

    def _encode(self, feats, flens, ctc_logp: bool = False):
        """-> (enc_out, enc_lengths, the CTC head's log-softmax or None),
        in span recognizer.encode."""
        with span("recognizer.encode"):
            enc_out, el = self.model.encode(feats, flens)
            logp = (torch.log_softmax(self.model.ctc_logits(enc_out).float(),
                                      dim=-1) if ctc_logp else None)
        return enc_out, el, logp

    def _greedy_ctc(self, feats, flens):
        enc_out, el, _ = self._encode(feats, flens)
        logits = self.model.ctc_logits(enc_out)
        toks, lens, times = ctc_greedy_decode(logits, el, return_times=True)
        # per-token confidence: max frame posterior at the emission frame,
        # exp(max(x) - logsumexp(x)) without materializing the softmax
        lf = logits.float()
        frame_conf = torch.exp(lf.max(dim=-1).values
                               - torch.logsumexp(lf, dim=-1))
        confs = torch.gather(frame_conf, 1, times.clamp(min=0))
        confs = torch.where(times >= 0, confs, 0.0)
        return toks, lens, times, confs

    def _beam(self, feats, flens):
        enc_out, el, ctc_logp = self._encode(feats, flens,
                                             ctc_logp=self.mode == "joint")
        out = attention_beam_search(
            self.model.decoder, enc_out, el, self.cfg.vocab_size - 2,
            self.cfg.vocab_size - 1, self.beam, ctc_logp=ctc_logp,
            lm=self.lm)
        self.decode_steps += out["steps"]
        return out["tokens"], out["lengths"], out["scores"]

    def _ctc_beam(self, feats, flens):
        enc_out, el, _ = self._encode(feats, flens)
        logits = self.model.ctc_logits(enc_out)
        return ctc_prefix_beam_search(
            logits, el, beam=self.beam.beam,
            max_len=min(self.beam.max_len, logits.shape[1]), lm=self.lm,
            lm_weight=self.beam.lm_weight, sos=self.cfg.vocab_size - 2)

    def _attn_rescore(self, feats, flens):
        enc_out, el, _ = self._encode(feats, flens)
        out = attention_rescore(
            self.model.decoder, enc_out, el, self.model.ctc_logits(enc_out),
            self.cfg.vocab_size - 2, self.cfg.vocab_size - 1,
            beam=self.beam.beam, max_len=self.beam.max_len,
            ctc_weight=self.beam.ctc_weight, lm=self.lm,
            lm_weight=self.beam.lm_weight)
        return out["tokens"], out["lengths"], out["scores"]

    def _transducer_greedy(self, feats, flens):
        *out, steps = transducer_greedy_decode(
            self.model, feats, flens, max_tokens=self.beam.max_len)
        self.decode_steps += steps
        return out

    def _transducer_beam(self, feats, flens):
        out = transducer_beam_search(
            self.model, feats, flens, beam=self.beam.beam,
            max_tokens=self.beam.max_len,
            length_penalty=self.beam.length_penalty, lm=self.lm,
            lm_weight=self.beam.lm_weight)
        self.decode_steps += out["steps"]
        return out["tokens"], out["lengths"], out["scores"]

    def _transducer_rescore(self, feats, flens):
        out = transducer_rescore(self.model, feats, flens,
                                 beam=self.beam.beam,
                                 max_len=self.beam.max_len,
                                 ctc_weight=self.beam.ctc_weight)
        return out["tokens"], out["lengths"], out["scores"]

    def _cif(self, feats, flens):
        if self.mode == "cif_beam":
            toks, lens, steps = cif_beam_decode(
                self.model, feats, flens, beam=self.beam.beam,
                max_len=self.beam.max_len, scale_fire=self.cif_scale_fire)
        else:
            toks, lens, steps = cif_greedy_decode(
                self.model, feats, flens, max_len=self.beam.max_len,
                scale_fire=self.cif_scale_fire)
        self.decode_steps += steps
        return toks, lens

    # --- public API ---

    def decode_batch(self, batch) -> list[list[int]]:
        """batch dict -> list of token-id hypotheses (1-best)."""
        return [h[0]["yseq"] for h in self.decode_batch_nbest(batch)]

    def decode_batch_nbest(self, batch) -> list[list[dict]]:
        """batch: {"wav" [B, S], "wav_lengths" [B]} or {"feats" [B, T, D],
        "feat_lengths" [B]} (numpy or tensors) -> per-utterance n-best
        [{'yseq': [ids], 'score': float[, 'times', 'confidence']}, ...].
        All outputs come to the host in one copy."""
        return self.decode_batches_nbest([batch], window=1)[0]

    def decode_batches_nbest(self, batches, window: int = 8
                             ) -> list[list[list[dict]]]:
        """Manifest decode: the device work of up to `window` batches,
        then their outputs to the host in ONE copy (`_to_host`). ->
        one decode_batch_nbest result per batch, in order; `batches` may
        be a generator, consumed as it goes."""
        out: list[list[list[dict]]] = []
        pending: list[tuple[str, tuple]] = []

        def flush():
            with span("recognizer.fetch"):
                fetched = _to_host(*(x for _, xs in pending for x in xs))
                done = []
                for kind, xs in pending:
                    done.append(self._finalize(kind, fetched[:len(xs)]))
                    fetched = fetched[len(xs):]
            if self.mesh is not None:     # every rank's rows, in order
                shards = self.mesh.data.all_gather_object(done)
                done = [[hyp for shard in shards for hyp in shard[i]]
                        for i in range(len(done))]
            out.extend(done)
            pending.clear()

        for batch in batches:
            pending.append(self._dispatch(batch))
            if len(pending) >= window:
                flush()
        if pending:
            flush()
        return out

    @torch.inference_mode()
    def _dispatch(self, batch) -> tuple[str, tuple]:
        """One batch's device work, not fetched: (kind, output tensors)
        for _finalize."""
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        feats, flens = self._features(batch)
        if self.mode == "greedy_ctc":
            return "greedy", self._greedy_ctc(feats, flens)
        if self.mode == "transducer_greedy":
            return "greedy", self._transducer_greedy(feats, flens)
        if isinstance(self.model, CifModel):   # no times or confidences
            return "cif", self._cif(feats, flens)
        run = {"ctc_beam": self._ctc_beam,
               "attn_rescore": self._attn_rescore,
               "transducer_beam": self._transducer_beam,
               "transducer_rescore": self._transducer_rescore}.get(
                   self.mode, self._beam)
        return "beam", run(feats, flens)

    def _finalize(self, kind: str, fetched) -> list[list[dict]]:
        """Host post-processing -> per-utterance n-best; eos and pads
        stripped (reference semantics)."""
        eos = self.cfg.vocab_size - 1

        def clean(row, length):
            return [int(t) for t in row[:length]
                    if int(t) >= 0 and int(t) != eos]

        if kind == "beam":
            toks, lens, scores = fetched                       # [B, W, L]
            nbest = min(self.beam.nbest, toks.shape[1]) or 1
            return [[{"yseq": clean(toks[i, w], lens[i, w]),
                      "score": float(scores[i, w])}
                     for w in range(nbest)]
                    for i in range(toks.shape[0])]
        toks, lens, times, confs = (fetched + [None, None] if kind == "cif"
                                    else fetched)
        out = []
        for i in range(toks.shape[0]):
            row = toks[i]
            keep = [j for j in range(int(lens[i]))
                    if int(row[j]) >= 0 and int(row[j]) != eos]
            hyp = {"yseq": [int(row[j]) for j in keep], "score": 0.0}
            if times is not None:
                hyp["times"] = [int(times[i][j]) for j in keep]
            if confs is not None:
                hyp["confidence"] = [round(float(confs[i][j]), 4)
                                     for j in keep]
            out.append([hyp])
        return out
