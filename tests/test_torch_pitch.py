"""Kaldi-style pitch (tpu_asr_torch.frontend _pitch_constants,
pitch_track, pitch_features, _viterbi_lags and the pitch branch of
wav_to_features) vs tpu_asr.frontend on the CPU, on the reference's own
test signals (pure tones, noise, a step change, a vibrato tone) and a
ragged padded batch with frame_lengths.

The bases are bitwise equal. The rest is held by chip_smoke.py's margin
rule (compare_pitch): the NCCF within PITCH_NCCF_ATOL (1e-4); the picked
lags equal except where the reference's own decision is within
PITCH_MARGIN (2e-4) of flipping (or, with Viterbi smoothing, a
predecessor within PITCH_VITERBI_MARGIN (1e-3) of the best); the
features within PITCH_FEAT_ATOL (1e-3) on every utterance whose lags
agree. With Viterbi smoothing the reference's _viterbi_lags over the
port's own band gives the port's lags bit for bit. The reference's NCCF
and lags are read from the first jnp.take_along_axis call of its
pitch_features, whose inputs they are.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr import frontend as jfe
from tpu_asr_torch import frontend as tfe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SR = 16000


class _SpyJnp:
    """jnp for tpu_asr.frontend that records the inputs of the first
    eager take_along_axis call: the NCCF and the picked lags."""

    def __init__(self):
        self.rec = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def take_along_axis(self, a, idx, axis):
        if not self.rec and not isinstance(a, jax.core.Tracer):
            self.rec.update(nccf=np.asarray(a),
                            lags=np.asarray(idx)[..., 0])
        return jnp.take_along_axis(a, idx, axis=axis)


def jax_pitch(wav, frame_lengths, weight, monkeypatch) -> dict:
    spy = _SpyJnp()
    cfg = jfe.FrontendConfig(add_pitch=True, pitch_smooth_weight=weight)
    with monkeypatch.context() as m:
        m.setattr(jfe, "jnp", spy)
        feats = jfe.pitch_features(jnp.asarray(wav),
                                   jnp.asarray(frame_lengths), cfg)
    return dict(spy.rec, feats=np.asarray(feats))


def jax_viterbi_lags(band, cfg):
    """tpu_asr's _viterbi_lags over a numpy band [B, T, L]."""
    min_lag, max_lag = tfe._pitch_constants(cfg)[:2]
    return np.asarray(jfe._viterbi_lags(jnp.asarray(band), min_lag, max_lag,
                                        cfg.pitch_smooth_weight))


def signals():
    """The reference's test signals and a ragged batch -> (wav [B, S],
    wav lengths [B])."""
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    f0 = 200.0 + 20.0 * np.sin(2 * np.pi * 6.0 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sigs = [np.sin(2 * np.pi * 110.0 * t), np.sin(2 * np.pi * 330.0 * t),
            rng.standard_normal(SR),
            np.concatenate([np.sin(2 * np.pi * 150 * t[:SR // 2]),
                            np.sin(2 * np.pi * 300 * t[:SR // 2])]),
            np.sin(phase) + 0.8 * np.sin(2 * phase)
            + 0.25 * rng.standard_normal(SR)]
    lens = [SR] * len(sigs)
    for n in (12000, 5200, 400, 0):       # ragged rows, one of no frames
        x = np.zeros(SR)
        tt = np.arange(n) / SR
        x[:n] = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 320) * tt)
                 + 0.1 * rng.standard_normal(n))
        sigs.append(x)
        lens.append(n)
    return np.stack(sigs).astype(np.float32), np.asarray(lens, np.int32)


def test_pitch_constants_bitwise():
    for kw in ({}, {"pitch_min_f0": 80.0, "pitch_max_f0": 500.0},
               {"sample_rate": 8000}):
        want = jfe._pitch_constants(jfe.FrontendConfig(add_pitch=True, **kw))
        got = tfe._pitch_constants(tfe.FrontendConfig(add_pitch=True, **kw))
        assert got[:2] == want[:2]
        for g, w in zip(got[2:], want[2:]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert tfe._pitch_constants(tfe.FrontendConfig())[:2] == (40, 267)


@pytest.mark.parametrize("weight", [0.0, 4.0])
def test_pitch_matches_reference_under_the_margin_rule(weight, monkeypatch):
    wav, lens = signals()
    cfg = tfe.FrontendConfig(add_pitch=True, pitch_smooth_weight=weight)
    got = chip_smoke.pitch_run(wav, lens, cfg, "cpu")
    ref = jax_pitch(wav, got["frame_lengths"], weight, monkeypatch)
    assert ref["nccf"].shape == got["nccf"].shape == (len(wav), 98, 269)
    out = chip_smoke.compare_pitch(f"weight {weight}", ref, got,
                                   got["frame_lengths"], cfg,
                                   viterbi_lags=jax_viterbi_lags)
    assert out["valid_frames"] == 595
    assert out.get("track_differs_frames", 0) == 0
    # the signals carry a pitch: a tone's POV is near 1
    assert (got["feats"][0, :, 0] > 0.9).mean() > 0.95


def test_viterbi_lags_match_on_a_lattice_with_ties():
    """_viterbi_lags alone on lattices with decoys and exact ties: the
    first (lowest) lag wins a tie, as jnp.argmax."""
    rng = np.random.default_rng(3)
    band = np.round(rng.standard_normal((3, 30, 50)), 1).astype(np.float32)
    band[1, :, 10] = band[1, :, 20] = 0.9           # a tie every frame
    got = tfe._viterbi_lags(torch.from_numpy(band), 40, 89, 4.0).numpy()
    want = np.asarray(jfe._viterbi_lags(jnp.asarray(band), 40, 89, 4.0))
    np.testing.assert_array_equal(got, want)


def test_margin_rule_fails_an_unexplained_flip_and_passes_a_near_one():
    wav, lens = signals()
    cfg = tfe.FrontendConfig(add_pitch=True)
    ref = chip_smoke.pitch_run(wav[:2], lens[:2], cfg, "cpu")
    margins = chip_smoke.pitch_margins(ref["nccf"], ref["lags"], cfg)
    got = {k: v.copy() for k, v in ref.items()}
    far = int(np.argmax(margins[0]))
    got["lags"][0, far] += 1
    with pytest.raises(AssertionError, match="margin rule"):
        chip_smoke.compare_pitch("planted", ref, got, ref["frame_lengths"],
                                 cfg)
    # the same flip where the reference's band sits on the threshold
    band = ref["nccf"][0, far, 40:268]
    ref["nccf"][0, far, 40 + int(np.argmin(band))] = \
        band.max() - 0.025 + chip_smoke.PITCH_MARGIN / 2
    got["nccf"] = ref["nccf"]
    out = chip_smoke.compare_pitch("near", ref, got, ref["frame_lengths"],
                                   cfg)
    assert out["flipped_frames"] == 1 and out["flipped_utts"] == 1
    got["feats"] = ref["feats"] + 2 * chip_smoke.PITCH_FEAT_ATOL
    got["lags"] = ref["lags"]
    with pytest.raises(AssertionError):
        chip_smoke.compare_pitch("features", ref, got, ref["frame_lengths"],
                                 cfg)


def test_wav_to_features_with_pitch_matches_reference():
    """D = 83 (fbank, then POV, log-pitch, delta), padding zeroed in every
    dim, per-utterance CMVN over the pasted feature; the fingerprint is
    the reference's, pitch part included."""
    wav, lens = signals()
    wav, lens = wav[5:7], lens[5:7]
    pc = tfe.FrontendConfig(add_pitch=True)
    jc = jfe.FrontendConfig(add_pitch=True)
    assert pc.feature_dim == 83
    for cmvn in ("utterance", "none"):
        got, gl = tfe.wav_to_features(
            torch.from_numpy(wav), torch.from_numpy(lens),
            dataclasses.replace(pc, cmvn_mode=cmvn))
        want, wl = jfe.wav_to_features(
            jnp.asarray(wav), jnp.asarray(lens),
            dataclasses.replace(jc, cmvn_mode=cmvn))
        assert got.shape == want.shape == (2, 98, 83)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        assert (got[1, int(gl[1]):] == 0).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-3)
    for w in (0.0, 4.0):
        assert tfe.feature_fingerprint(dataclasses.replace(
            pc, pitch_smooth_weight=w)) == jfe.feature_fingerprint(
                dataclasses.replace(jc, pitch_smooth_weight=w))


def test_pitch_cmvn_stats_load_in_either_package(tmp_path):
    """Stats written by the port's compute_cmvn for a --pitch frontend
    (83 dims, the pitch fingerprint) normalize alike in the port and in
    tpu_asr; a frontend without pitch refuses them in both."""
    from tpu_asr_torch import compute_cmvn
    from tpu_asr_torch.data import Utterance, save_manifest
    from tpu_asr_torch.train.checkpoints import Checkpointer
    wav, lens = signals()
    utts = []
    for i in (0, 4, 5):
        path = str(tmp_path / f"u{i}.npy")
        np.save(path, wav[i, :lens[i]])
        utts.append(Utterance(id=f"u{i}", wav=path, num_samples=int(lens[i]),
                              tokens=[3]))
    save_manifest(utts, str(tmp_path / "m.jsonl"))
    pc = tfe.FrontendConfig(add_pitch=True)
    Checkpointer(str(tmp_path / "ck")).save_frontend(pc)
    stats = str(tmp_path / "cmvn.npz")
    out = compute_cmvn.main(["--manifest", str(tmp_path / "m.jsonl"),
                             "--out", stats, "--frontend-json",
                             str(tmp_path / "ck"), "--device", "cpu"])
    assert out["mean"].shape == (83,)
    x = np.random.default_rng(0).standard_normal((1, 4, 83)).astype(
        np.float32)
    jg = dataclasses.replace(jfe.FrontendConfig(add_pitch=True),
                             cmvn_mode="global", cmvn_stats_path=stats)
    tg = dataclasses.replace(pc, cmvn_mode="global", cmvn_stats_path=stats)
    np.testing.assert_allclose(
        tfe.apply_global_cmvn(torch.from_numpy(x), tg).numpy(),
        np.asarray(jfe.apply_global_cmvn(jnp.asarray(x), jg)), rtol=1e-6)
    with pytest.raises(ValueError, match="different frontend"):
        tfe.apply_global_cmvn(torch.from_numpy(x[..., :80]),
                              dataclasses.replace(tg, add_pitch=False))
    with pytest.raises(ValueError, match="different frontend"):
        jfe.apply_global_cmvn(jnp.asarray(x[..., :80]),
                              dataclasses.replace(jg, add_pitch=False))


def test_margin_rule_fails_a_wrong_viterbi_step_on_a_near_row():
    """A Viterbi track one frame off on a row whose margins would explain
    a flip: the bitwise track check fails it all the same."""
    wav, lens = signals()
    cfg = tfe.FrontendConfig(add_pitch=True, pitch_smooth_weight=4.0)
    ref = chip_smoke.pitch_run(wav[:2], lens[:2], cfg, "cpu")
    margins = chip_smoke.pitch_margins(ref["nccf"], ref["lags"], cfg)
    row = int(np.argmin(margins.min(axis=-1)))
    assert margins[row].min() <= chip_smoke.PITCH_VITERBI_MARGIN
    got = {k: v.copy() for k, v in ref.items()}
    got["lags"][row, 10] += 1
    with pytest.raises(AssertionError, match="Viterbi track"):
        chip_smoke.compare_pitch("wrong step", ref, got, ref["frame_lengths"],
                                 cfg, viterbi_lags=jax_viterbi_lags)
