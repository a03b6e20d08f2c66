"""Vectorized CTC prefix scorer for joint CTC/attention beam decoding
(port of tpu_asr/decode/ctc_prefix.py).

Log-space recursion, for prefix g (last symbol c_last) extended by c:
    phi[t]     = logaddexp(r_b[t](g), c != c_last ? r_nb[t](g) : -inf)
    r_nb[t](h) = logaddexp(r_nb[t-1](h), phi[t-1]) + x[t, c]
    r_b[t](h)  = logaddexp(r_nb[t-1](h), r_b[t-1](h)) + x[t, blank]
    psi        = logaddexp_t(phi[t-1] + x[t, c])   (prefix probability)
eos scores as logaddexp(r_nb[T-1](g), r_b[T-1](g)).

The time recursion is `ops.ctc_prefix.ctc_prefix_scan`: the CUDA kernel
on a card, its plain version on the CPU. The candidate log-probs are a
torch.gather from the float32 log-probs (the reference's one-hot einsum
is a TPU device for the same gather); eos handling stays outside the
kernel, as in the reference.
"""

from __future__ import annotations

import torch

from tpu_asr_torch.ops.ctc_prefix import NEG_INF, ctc_prefix_scan


class CTCPrefixScorer:
    """Batched prefix scorer over fixed CTC log-probs, for N = B*W prefix
    states (W beams per utterance)."""

    def __init__(self, ctc_logp: torch.Tensor, enc_lengths: torch.Tensor,
                 blank: int = 0, eos: int | None = None, beams: int = 1):
        """ctc_logp: [B, T, V] log-softmaxed CTC posteriors; enc_lengths:
        [N] per prefix state."""
        self.logp = ctc_logp.float()
        self.beams = beams
        self.lengths = enc_lengths.to(torch.int32).contiguous()
        self.blank = blank
        self.eos = eos
        b, t, v = ctc_logp.shape
        self.n, self.t, self.v = b * beams, t, v
        # [N, T], the same every step
        dev = ctc_logp.device
        self.x_blank = torch.empty((self.n, t), dtype=torch.float32,
                                   device=dev)
        self.active = torch.empty((self.n, t), dtype=torch.bool, device=dev)
        self.refresh()

    def refresh(self):
        """Recompute in place what the scorer derives from its log-probs
        and lengths: for a caller that rewrote those tensors with another
        batch of the same shape (the beam search's static buffers)."""
        self.x_blank.copy_(self.logp[:, :, self.blank].repeat_interleave(
            self.beams, dim=0))
        torch.lt(torch.arange(self.t, device=self.logp.device)[None, :],
                 self.lengths[:, None], out=self.active)

    def init_state(self):
        """State for the empty prefix: (r [N, T, 2], psi_prev [N]).

        r[..., 0] = r_nb (NEG_INF for the empty prefix), r[..., 1] = r_b =
        cumulative blank log-prob (frozen past the length)."""
        r_b = torch.cumsum(torch.where(self.active, self.x_blank, 0.0), dim=1)
        r_nb = torch.full_like(r_b, NEG_INF)
        return torch.stack([r_nb, r_b], dim=-1), r_b.new_zeros(self.n)

    def score(self, cands: torch.Tensor, y_last: torch.Tensor,
              is_first: torch.Tensor, state, return_r: bool = True):
        """Score K candidate extensions per beam.

        cands: [N, K] token ids; y_last: [N] last token of each prefix;
        is_first: [N] bool, True when the prefix is empty. Returns (psi
        [N, K], new_r [N, K, T, 2] or None when return_r=False). eos
        candidates get the complete-sequence probability of g itself.
        """
        r_prev, _ = state
        n, k = cands.shape
        t, w = self.t, self.beams
        b = n // w
        idx = cands.reshape(b, 1, w * k).expand(b, t, w * k)
        x_cand = torch.gather(self.logp, 2, idx)                # [B, T, W*K]
        # contiguous for the kernel: with one utterance (b = 1, as a
        # data-parallel rank may hold) the reshape is a strided view
        x_cand = x_cand.reshape(b, t, w, k).transpose(1, 2).reshape(
            n, t, k).contiguous()
        same = cands == y_last[:, None]                         # [N, K]
        r_nb_p, r_b_p = r_prev[..., 0], r_prev[..., 1]
        phi = torch.logaddexp(
            r_b_p[:, :, None],
            torch.where(same[:, None, :], NEG_INF, r_nb_p[:, :, None]))
        # t = 0 init: r_nb = x[0, c] only for the empty prefix
        r_nb0 = torch.where(is_first[:, None], x_cand[:, 0, :], NEG_INF)
        r_b0 = torch.full_like(r_nb0, NEG_INF)
        psi, nb_hist, b_hist = ctc_prefix_scan(
            x_cand, phi.contiguous(), self.x_blank, r_nb0.contiguous(), r_b0,
            r_nb0.clone(), self.lengths, return_hist=return_r)
        new_r = None
        if return_r:
            new_r = torch.stack([nb_hist.transpose(1, 2),
                                 b_hist.transpose(1, 2)], dim=-1)
        if self.eos is not None:
            # eos: P(g complete) at the last active frame
            last = torch.clamp(self.lengths.long() - 1, min=0)
            r_last = r_prev[torch.arange(n, device=last.device), last]
            g_complete = torch.logaddexp(r_last[:, 0], r_last[:, 1])
            psi = torch.where(cands == self.eos, g_complete[:, None], psi)
        return psi, new_r

    def advance(self, token: torch.Tensor, y_last: torch.Tensor,
                is_first: torch.Tensor, state):
        """Advance each beam's prefix state by ONE chosen token: (new_r
        [N, T, 2], psi [N])."""
        psi, new_r = self.score(token[:, None], y_last, is_first, state,
                                return_r=True)
        return new_r[:, 0], psi[:, 0]
