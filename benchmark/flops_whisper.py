"""Whisper's model FLOPs for decode_mfu.whisper, from the configuration's
shapes (benchmark/flops.py's conventions: matmuls and attention, two
operations a multiply-add, elementwise work left out).

Whisper's encoder runs the whole window whatever the speech's length:
the stem's two k3 convolutions over 2 audio_ctx and audio_ctx frames,
then the blocks over audio_ctx frames. Its decoder attends every frame of
the window, and a hypothesis of n tokens takes the decoder over the
prompt and the tokens (len(sot_sequence) + n positions, the last of which
predicts the end) and the logits at the n + 1 positions that predict a
token or the end.
"""

from __future__ import annotations

from benchmark.flops import attention_pairs


def encoder_flops(cfg: dict) -> float:
    """The stem and the encoder blocks over one window."""
    t, d, dff = cfg["audio_ctx"], cfg["d_model"], cfg["d_inner"]
    stem = 2 * (2 * t) * cfg["d_input"] * 3 * d + 2 * t * d * 3 * d
    layer = 8 * t * d * d + 4 * t * t * d + 4 * t * d * dff
    return stem + cfg["num_enc_layers"] * layer


def cross_kv_flops(cfg: dict) -> float:
    """Every decoder block's cross-attention K and V of one window."""
    t, d = cfg["audio_ctx"], cfg["d_model"]
    return cfg["num_dec_layers"] * 4 * t * d * d


def decoder_flops(tokens: int, cfg: dict) -> float:
    """One hypothesis of `tokens` tokens: the blocks over the prompt and
    the tokens (self-attention projections and causal pairs, the query
    and out projections of the cross-attention and its scores against
    the window, the MLP), ln, and the logits of tokens + 1 positions."""
    u = len(cfg["sot_sequence"]) + tokens
    t, d, dff = cfg["audio_ctx"], cfg["d_model"], cfg["d_inner"]
    layer = (8 * u * d * d + 4 * attention_pairs(u, u, True) * d
             + 4 * u * d * d + 4 * u * t * d + 4 * u * d * dff)
    return cfg["num_dec_layers"] * layer + 2 * (tokens + 1) * d * \
        cfg["vocab_size"]


def request_flops(tokens: int, beam: int, cfg: dict) -> float:
    """A request answered with `tokens` tokens: its window's encoder and
    cross K/V, and the decoder for each of the beam's hypotheses."""
    return encoder_flops(cfg) + cross_kv_flops(cfg) + \
        beam * decoder_flops(tokens, cfg)
