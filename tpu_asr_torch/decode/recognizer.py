"""High-level batched recognizer: padded batches -> hypothesis tokens
(port of tpu_asr/decode/recognizer.py).

Ported modes: greedy_ctc, joint (CTC/attention beam) and beam (the same
loop with ctc_weight = 0). The reference's other modes (ctc_beam,
attn_rescore, cif_*, transducer_*) and LM fusion are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
from tpu_asr_torch.decode.greedy_ctc import ctc_greedy_decode
from tpu_asr_torch.frontend import FrontendConfig, wav_to_features
from tpu_asr_torch.models.transformer import Transformer
from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.weights import cast_for_inference

PORTED_MODES = ("greedy_ctc", "beam", "joint")
REFERENCE_MODES = ("ctc_beam", "attn_rescore", "cif_greedy", "cif_beam",
                   "transducer_greedy", "transducer_beam",
                   "transducer_rescore")


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
    """cfg + a tpu_asr_torch Transformer -> batched decode on `device`.

    device None means the CUDA card (RuntimeError when there is none);
    pass device="cpu" to run on the CPU. The model is moved to the device
    and its matmul weights are stored in the compute dtype."""
    cfg: object
    model: Transformer
    beam: BeamConfig = BeamConfig()
    mode: str = "beam"   # greedy_ctc | beam | joint
    frontend: FrontendConfig = FrontendConfig()
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.mode in REFERENCE_MODES:
            raise NotImplementedError(
                f"decode mode {self.mode!r} is not ported yet; ported modes "
                f"are {PORTED_MODES}")
        if self.mode not in PORTED_MODES:
            raise ValueError(f"unknown decode mode {self.mode!r}")
        mt = self.cfg.model_type
        if self.mode in ("greedy_ctc", "joint") and mt not in ("ctc",
                                                               "hybrid"):
            raise ValueError(f"mode {self.mode} needs a CTC head "
                             f"(model_type={mt})")
        if self.mode in ("beam", "joint") and mt not in ("transformer",
                                                         "hybrid"):
            raise ValueError(f"mode {self.mode} needs an attention decoder "
                             f"(model_type={mt})")
        self.device = resolve_device(self.device)
        self.model = cast_for_inference(self.model.to(self.device).eval(),
                                        self.cfg.dtype)
        self.decode_steps = 0    # beam-search steps taken, all batches

    # --- device work ---

    def _features(self, batch):
        def tensor(key):
            return torch.as_tensor(batch[key], device=self.device)
        if "wav" in batch:
            return wav_to_features(tensor("wav"), tensor("wav_lengths"),
                                   self.frontend)
        return tensor("feats").float(), tensor("feat_lengths")

    def _greedy_ctc(self, feats, flens):
        enc_out, el = self.model.encode(feats, flens)
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
        enc_out, el = self.model.encode(feats, flens)
        ctc_logp = None
        if self.mode == "joint":
            ctc_logp = torch.log_softmax(
                self.model.ctc_logits(enc_out).float(), dim=-1)
        out = attention_beam_search(
            self.model.decoder, enc_out, el, self.cfg.vocab_size - 2,
            self.cfg.vocab_size - 1, self.beam, ctc_logp=ctc_logp)
        self.decode_steps += out["steps"]
        return out["tokens"], out["lengths"], out["scores"]

    # --- public API ---

    def decode_batch(self, batch) -> list[list[int]]:
        """batch dict -> list of token-id hypotheses (1-best)."""
        return [h[0]["yseq"] for h in self.decode_batch_nbest(batch)]

    @torch.inference_mode()
    def decode_batch_nbest(self, batch) -> list[list[dict]]:
        """batch: {"wav" [B, S], "wav_lengths" [B]} or {"feats" [B, T, D],
        "feat_lengths" [B]} (numpy or tensors) -> per-utterance n-best
        [{'yseq': [ids], 'score': float[, 'times', 'confidence']}, ...].
        All outputs come to the host in one copy."""
        feats, flens = self._features(batch)
        if self.mode == "greedy_ctc":
            return self._finalize("greedy", _to_host(
                *self._greedy_ctc(feats, flens)))
        return self._finalize("beam", _to_host(*self._beam(feats, flens)))

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
        toks, lens, times, confs = fetched
        out = []
        for i in range(toks.shape[0]):
            row, tr, cr = toks[i], times[i], confs[i]
            keep = [j for j in range(int(lens[i]))
                    if int(row[j]) >= 0 and int(row[j]) != eos]
            out.append([{"yseq": [int(row[j]) for j in keep], "score": 0.0,
                         "times": [int(tr[j]) for j in keep],
                         "confidence": [round(float(cr[j]), 4)
                                        for j in keep]}])
        return out
