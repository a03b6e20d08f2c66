"""Port frontend (tpu_asr_torch.frontend) vs tpu_asr.frontend on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr import frontend as jfe
from tpu_asr_torch import frontend as tfe
from torch_port_util import wav_batch

# a padded batch with a short row, a row shorter than one frame and a
# length-0 dummy row (the server's padding convention)
LENGTHS = [16000, 9000, 300, 0]


def _both(apply_cmvn, cmvn_mode="utterance"):
    b = wav_batch(LENGTHS, seed=3, n_samples=16000)
    jf, jl = jfe.wav_to_features(
        jnp.asarray(b["wav"]), jnp.asarray(b["wav_lengths"]),
        jfe.FrontendConfig(cmvn_mode=cmvn_mode), apply_cmvn=apply_cmvn)
    tf, tl = tfe.wav_to_features(
        torch.from_numpy(b["wav"]), torch.from_numpy(b["wav_lengths"]),
        tfe.FrontendConfig(cmvn_mode=cmvn_mode), apply_cmvn=apply_cmvn)
    return np.asarray(jf), np.asarray(jl), tf.numpy(), tl.numpy()


@pytest.mark.parametrize("apply_cmvn,mode", [(False, "utterance"),
                                             (True, "utterance"),
                                             (True, "none")])
def test_wav_to_features_matches_jax(apply_cmvn, mode):
    jf, jl, tf, tl = _both(apply_cmvn, mode)
    np.testing.assert_array_equal(jl, tl)
    assert tf.shape == jf.shape == (4, 98, 80)
    assert np.all(tf[2:] == 0.0)          # sub-frame and length-0 rows
    # float32 products summed in another order. A mel bin whose power is
    # ~1e-7 of the frame's (preemphasis + the narrow low-frequency
    # triangles) carries float32 cancellation error of ~1e-3 in its log on
    # BOTH sides (test_log_mel_near_float64 bounds the port's); every
    # other bin agrees to 1e-4.
    ref = _both(False)[0]
    strong = ref > -10.0                  # mel power above ~4.5e-5
    np.testing.assert_allclose(tf[strong], jf[strong], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tf, jf, atol=2e-3, rtol=1e-5)


def test_log_mel_near_float64():
    """The port's log-mel against the same formula in float64 numpy."""
    b = wav_batch(LENGTHS[:2], seed=3, n_samples=16000)
    cfg = tfe.FrontendConfig()
    cos_b, sin_b, mel = (c.astype(np.float64)
                         for c in tfe._frontend_constants(cfg))
    fr = tfe.frame_signal(torch.from_numpy(b["wav"]), cfg).double().numpy()
    fr = fr - fr.mean(-1, keepdims=True)
    fr = fr - 0.97 * np.concatenate([fr[..., :1], fr[..., :-1]], -1)
    power = (fr @ cos_b) ** 2 + (fr @ sin_b) ** 2
    want = np.log(np.maximum(power @ mel, 1e-10))
    got = tfe.log_mel_spectrogram(torch.from_numpy(b["wav"]), cfg).numpy()
    strong = want > -10.0
    np.testing.assert_allclose(got[strong], want[strong], atol=1e-4)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_constants_equal():
    jc, tc = jfe.FrontendConfig(), tfe.FrontendConfig()
    for a, b in zip(jfe._frontend_constants(jc), tfe._frontend_constants(tc)):
        np.testing.assert_array_equal(a, b)
    assert tc.num_frames(16000) == jc.num_frames(16000) == 98
    assert tc.num_frames(399) == 0


def test_frame_signal_matches_jax():
    wav = np.random.default_rng(0).standard_normal((2, 2000)).astype(
        np.float32)
    cfg = tfe.FrontendConfig()
    got = tfe.frame_signal(torch.from_numpy(wav), cfg).numpy()
    want = np.asarray(jfe.frame_signal(jnp.asarray(wav),
                                       jfe.FrontendConfig()))
    np.testing.assert_array_equal(got, want)
    assert tfe.frame_signal(torch.zeros(1, 100), cfg).shape == (1, 0, 400)


def test_unported_options_raise():
    wav, lens = torch.zeros(1, 4000), torch.tensor([4000])
    # pitch is ported (tests/test_torch_pitch.py): 3 dims pasted on
    feats, _ = tfe.wav_to_features(wav, lens,
                                   tfe.FrontendConfig(add_pitch=True))
    assert feats.shape == (1, 23, 83)
    # global CMVN is ported; without a stats file it refuses to run
    with pytest.raises(ValueError, match="cmvn_stats_path"):
        tfe.wav_to_features(wav, lens, dataclasses.replace(
            tfe.FrontendConfig(), cmvn_mode="global"))
    with pytest.raises(ValueError):
        tfe.wav_to_features(wav, lens, tfe.FrontendConfig(cmvn_mode="bad"))
