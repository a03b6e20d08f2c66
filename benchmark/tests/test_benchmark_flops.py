"""The yardstick's operation and byte counts against hand counts at a
small shape."""

import pytest

from benchmark import flops

B = flops.HBM_BYTES_PER_S
F16 = flops.BF16_FLOP_PER_S
F32 = flops.FP32_FLOP_PER_S


def test_attention_pairs():
    assert flops.attention_pairs(3, 3, causal=True) == 6
    assert flops.attention_pairs(3, 5, causal=False) == 15


def test_flash_bounds_by_hand():
    # tq = tk = 2, one head of 4: q, k, v, out 2 bytes x 4 x 2 rows each,
    # lse 4 bytes x 2; 4 pairs x 4 dh x 4 operations
    fwd = flops.flash_fwd_bound_s(2, 2, 1, 4, False)
    assert fwd == pytest.approx(max(64 / F16, (64 + 8) / B))
    # dq: reads q, k, v, dO (64 bytes) + lse, delta (16); writes dq (16)
    dq = flops.flash_bwd_bound_s(2, 2, 1, 4, False, "dq")
    assert dq == pytest.approx(max(6 * 4 * 4 / F16, (64 + 16 + 16) / B))
    dkv = flops.flash_bwd_bound_s(2, 2, 1, 4, False, "dkv")
    assert dkv == pytest.approx(max(8 * 4 * 4 / F16, (64 + 16 + 32) / B))
    # one utterance of 250 encoder frames, 8 heads of 64: its bytes bound
    big = flops.flash_fwd_bound_s(250, 250, 8, 64, False)
    assert big == pytest.approx((2 * 8 * 64 * 1000 + 4 * 8 * 250) / B)


def test_ctc_bounds_by_hand():
    # t = 3 frames, u = 1 label: S = 3
    fwd = flops.ctc_bound_s(3, 1, backward=False)
    assert fwd == pytest.approx(max(14 * 2 * 3 / F32, (2 * 4 * 9 + 8) / B))
    bwd = flops.ctc_bound_s(3, 1, backward=True)
    assert bwd == pytest.approx(max(17 * 3 * 3 / F32, (3 * 4 * 9 + 8) / B))
    assert flops.ctc_bound_s(0, 4, backward=True) == 0.0


def test_prefix_scan_bound_by_hand():
    got = flops.prefix_scan_bound_s(4, 2, hist=True)
    nbytes = 4 * (2 * 4 * 2 + 4 + 3 * 2 + 1) + 4 * (2 + 2 * 4 * 2)
    assert got == pytest.approx(max(27 * 3 * 2 / F32, nbytes / B))


CFG = {"d_model": 8, "d_inner": 16, "vocab_size": 10, "conv_channels": [2, 3],
       "d_input": 11, "num_enc_layers": 1, "num_dec_layers": 1,
       "encoder_type": "transformer", "conv_kernel": 3}


def test_model_flops_by_hand():
    t = 19                                  # conv1: 9 frames, conv2: 4
    assert flops.subsampled(t) == 4
    f1, f2 = 5, 2                           # (11 - 1) // 2, (5 - 1) // 2
    conv = 2 * 2 * 9 * f1 * 9 + 2 * 3 * 4 * f2 * 9 * 2
    out = 2 * 4 * f2 * 3 * 8
    layer = 4 * 2 * 4 * 64 + 2 * 2 * 16 * 8 + 2 * 2 * 4 * 8 * 16
    ctc = 2 * 4 * 8 * 10
    assert flops.encoder_flops(t, CFG) == conv + out + layer + ctc
    u = 3
    dec = (4 * 2 * 3 * 64 + 2 * 2 * 6 * 8 + 2 * 2 * 3 * 64 + 2 * 2 * 4 * 64
           + 2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 8 * 16) + 2 * 3 * 8 * 10
    assert flops.decoder_flops(t, u, CFG) == dec
    assert flops.train_step_flops([(t, 2)], CFG) == 3 * (conv + out + layer
                                                         + ctc + dec)


def test_conformer_counts_more_than_the_transformer():
    conf = dict(CFG, encoder_type="conformer")
    assert flops.encoder_flops(19, conf) > flops.encoder_flops(19, CFG)
    assert flops.encoder_flops(5, CFG) == 0.0
