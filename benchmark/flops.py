"""The yardstick's arithmetic: published peaks of one NVIDIA H100 and the
operations and bytes that each measured layer needs, worked out from the
layer's own shapes (valid lengths only), not from what a kernel does.

Peaks are NVIDIA's data sheet for the SXM part at its 700 W limit (dense
rates): 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM. A roofline bound is the larger of operations / peak
and bytes / bandwidth: each input byte read once, each output byte
written once.

The attention, CTC and prefix-scan bounds are frozen copies of the
functions that `chip_smoke.py` uses for its kernel table (flash_bound_ms,
flash_bwd_bound_ms, ctc_bound_ms, prefix_scan_bound_ms), rewritten to
take lengths instead of tensors and to count queries over the valid
lengths too.
"""

from __future__ import annotations

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flop_rate: float) -> float:
    """Least time on one H100 for this many operations and bytes."""
    return max(flops / flop_rate, nbytes / HBM_BYTES_PER_S)


# ---- attention kernels (flash forward, dq, dk/dv) ----

def attention_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs that a mask lets through for one head."""
    if causal:
        n = min(tq, tk)
        return n * (n + 1) // 2 + max(tq - tk, 0) * tk
    return tq * tk


def flash_fwd_bound_s(tq: int, tk: int, heads: int, dh: int, causal: bool,
                      elem: int = 2, rate: float = BF16_FLOP_PER_S) -> float:
    """One utterance's attention forward: q, k, v read once, out written
    once (elem bytes each), lse written (float32); 4 dh operations per
    (query, key, head) pair (QK^T and PV)."""
    pairs = attention_pairs(tq, tk, causal) * heads
    nbytes = elem * heads * dh * (2 * tq + 2 * tk) + 4 * heads * tq
    return bound_s(4 * dh * pairs, nbytes, rate)


def flash_bwd_bound_s(tq: int, tk: int, heads: int, dh: int, causal: bool,
                      which: str, elem: int = 2,
                      rate: float = BF16_FLOP_PER_S) -> float:
    """One utterance's attention backward, dq (which="dq") or dk and dv
    ("dkv"): q, k, v, dO read once, lse and delta (float32) read once,
    dq or dk and dv written once. Operations per pair: s, dp and ds K
    (6 dh) for dq; s, dp, p^T dO and ds^T q (8 dh) for dk/dv."""
    pairs = attention_pairs(tq, tk, causal) * heads
    read = elem * heads * dh * (2 * tq + 2 * tk) + 8 * heads * tq
    written = elem * heads * dh * (tq if which == "dq" else 2 * tk)
    flops = (6 if which == "dq" else 8) * dh * pairs
    return bound_s(flops, read + written, rate)


# ---- CTC loss kernels (forward: alpha; backward: beta and the gradient) --

def ctc_bound_s(t: int, u: int, backward: bool) -> float:
    """One utterance of t frames and u labels (lattice S = 2u + 1), float32.
    Forward: the emissions [t, S] read once, alpha [t, S] written once;
    ~14 operations per lattice cell and step. Backward: emissions and
    alpha read once, the gradient [t, S] written once; ~17 operations per
    cell and step."""
    if t <= 0:
        return 0.0
    s = 2 * u + 1
    steps = max(t - 1, 0)
    if backward:
        nbytes = 3 * 4 * t * s + 8
        ops = 17 * (steps + 1) * s
    else:
        nbytes = 2 * 4 * t * s + 8
        ops = 14 * steps * s
    return bound_s(ops, nbytes, FP32_FLOP_PER_S)


# ---- CTC prefix scan (joint beam) ----

def prefix_scan_bound_s(t: int, k: int, hist: bool) -> float:
    """One beam's scan over t frames of k candidates, float32: x_cand and
    phi [t, k], x_blank [t] read once, the initial states and psi [k]
    once, the histories [2, t, k] written when kept; ~27 operations per
    (candidate, frame) step."""
    if t <= 0:
        return 0.0
    read = 4 * (2 * t * k + t + 3 * k + 1)
    write = 4 * (k + (2 * t * k if hist else 0))
    return bound_s(27 * max(t - 1, 0) * k, read + write, FP32_FLOP_PER_S)


# ---- model FLOPs (matmuls and attention; elementwise work left out) ----

def subsampled(t: int) -> int:
    """Encoder frames of t input frames: two 3x3 stride-2 VALID convs."""
    return max(((t - 1) // 2 - 1) // 2, 0)


def encoder_flops(t: int, cfg: dict) -> float:
    """Forward FLOPs of the conv2d front end, the encoder and the CTC head
    for one utterance of t valid input frames."""
    te = subsampled(t)
    if te <= 0:
        return 0.0
    d, dff, v = cfg["d_model"], cfg["d_inner"], cfg["vocab_size"]
    c1, c2 = cfg["conv_channels"]
    f1 = (cfg["d_input"] - 1) // 2
    f2 = (f1 - 1) // 2
    t1 = (t - 1) // 2
    flops = 2 * c1 * t1 * f1 * 9 + 2 * c2 * te * f2 * 9 * c1
    flops += 2 * te * f2 * c2 * d
    if cfg["encoder_type"] == "conformer":
        k = cfg["conv_kernel"]
        layer = (2 * 2 * 2 * te * d * dff          # two half FFNs
                 + 4 * 2 * te * d * d              # q, k, v, out
                 + 2 * (2 * te - 1) * d * d        # pos_proj of the table
                 + 3 * 2 * te * te * d             # content, position, PV
                 + 2 * te * d * 2 * d              # pointwise 1 (GLU)
                 + 2 * te * d * k                  # depthwise
                 + 2 * te * d * d)                 # pointwise 2
    else:
        layer = (4 * 2 * te * d * d + 2 * 2 * te * te * d
                 + 2 * 2 * te * d * dff)
    flops += cfg["num_enc_layers"] * layer
    return flops + 2 * te * d * v


def decoder_flops(t: int, u: int, cfg: dict) -> float:
    """Forward FLOPs of the decoder and its output projection for u
    decoder positions against the encoder frames of t input frames."""
    te = subsampled(t)
    if te <= 0 or u <= 0:
        return 0.0
    d, dff, v = cfg["d_model"], cfg["d_inner"], cfg["vocab_size"]
    layer = (4 * 2 * u * d * d + 2 * 2 * attention_pairs(u, u, True) * d
             + 2 * 2 * u * d * d + 2 * 2 * te * d * d + 2 * 2 * u * te * d
             + 2 * 2 * u * d * dff)
    return cfg["num_dec_layers"] * layer + 2 * u * d * v


def train_step_flops(lengths, cfg: dict) -> float:
    """Model FLOPs of one training step over (input frames, target
    tokens) pairs of the real rows: forward (decoder over tokens + 1
    positions) times 3 for the forward and the backward."""
    return 3.0 * sum(encoder_flops(t, cfg) + decoder_flops(t, u + 1, cfg)
                     for t, u in lengths)
