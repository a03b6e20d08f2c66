"""Port SpecAugment (tpu_asr_torch.augment) vs tpu_asr.augment.spec_augment:
given the draws jax.random makes for a key, the port's output is equal
(masks) and, with the time warp, equal up to float32 rounding of the
interpolation (atol 1e-6; both compute the same float32 expressions)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.augment import SpecAugmentConfig as JaxCfg
from tpu_asr.augment import spec_augment as jax_spec_augment
from tpu_asr_torch.augment import (SpecAugmentConfig, apply_spec_augment,
                                   draw_spec_augment, spec_augment)


def jax_draws(key, lens, num_bins, cfg):
    """The draws tpu_asr.augment.spec_augment makes for `key`, by the same
    key splits and formulas."""
    b = lens.shape[0]
    k_f, k_t, k_w0 = jax.random.split(key, 3)
    k_w, k_s = jax.random.split(k_f)
    f_w = jax.random.randint(k_w, (b, cfg.num_freq_masks), 0,
                             cfg.freq_mask_width + 1)
    f_s = (jax.random.uniform(k_s, (b, cfg.num_freq_masks))
           * jnp.maximum(num_bins - f_w, 1)).astype(jnp.int32)
    t_cap = jnp.minimum(
        jnp.full((b,), cfg.time_mask_width, jnp.int32),
        (lens.astype(jnp.float32) * cfg.time_mask_max_ratio).astype(
            jnp.int32))
    k_w, k_s = jax.random.split(k_t)
    t_w = jnp.minimum(jax.random.randint(k_w, (b, cfg.num_time_masks), 0,
                                         cfg.time_mask_width + 1),
                      t_cap[:, None])
    t_s = (jax.random.uniform(k_s, (b, cfg.num_time_masks))
           * jnp.maximum(lens[:, None] - t_w, 1)).astype(jnp.int32)
    out = dict(freq_widths=f_w, freq_starts=f_s, time_widths=t_w,
               time_starts=t_s)
    w = cfg.time_warp_window
    if w > 0:
        k_c, k_d = jax.random.split(k_w0)
        u = jax.random.uniform(k_c, (b,))
        out["w0"] = jnp.floor(w + u * jnp.maximum(
            lens.astype(jnp.float32) - 2 * w, 1.0))
        out["dist"] = jax.random.randint(k_d, (b,), -w, w + 1).astype(
            jnp.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("seed,warp", [(0, 0), (1, 0), (2, 5), (3, 8)])
def test_matches_reference_given_its_draws(seed, warp):
    rng = np.random.default_rng(seed)
    b, t, d = 4, 120, 80
    feats = rng.standard_normal((b, t, d)).astype(np.float32)
    lens = np.array([120, 97, 15, 0], np.int32)
    jcfg = JaxCfg(time_warp_window=warp)
    cfg = SpecAugmentConfig(time_warp_window=warp)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_spec_augment(key, jnp.asarray(feats),
                                       jnp.asarray(lens), jcfg))
    draws = jax_draws(key, jnp.asarray(lens), d, jcfg)
    got = apply_spec_augment(torch.from_numpy(feats), torch.from_numpy(lens),
                             draws, cfg).numpy()
    if warp:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got == 0.0).any()                          # something masked


def test_port_draws_follow_the_reference_rules():
    """The port's own draws: widths within their caps, masks inside the
    utterance (start <= max(len - width, 1)), warp centre in [W, L-W)."""
    cfg = SpecAugmentConfig(time_warp_window=5)
    lens = torch.tensor([300, 120, 30, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        dr = draw_spec_augment(gen, lens, 80, cfg)
        assert dr["freq_widths"].max() <= cfg.freq_mask_width
        assert (dr["freq_starts"] + dr["freq_widths"] <= 80).all()
        assert (dr["time_widths"] <= lens[:, None]).all()
        room = torch.clamp(lens[:, None] - dr["time_widths"], min=1)
        assert (dr["time_starts"] < room).all()
        assert ((dr["w0"] >= 5) & (dr["dist"].abs() <= 5)).all()


def test_seeded_generator_is_reproducible_and_keeps_padding():
    cfg = dataclasses.replace(SpecAugmentConfig(), time_warp_window=4)
    feats = torch.randn(3, 50, 16, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([50, 33, 0], dtype=torch.int32)
    feats[1, 33:] = 0.0
    a = spec_augment(torch.Generator().manual_seed(7), feats, lens, cfg)
    b = spec_augment(torch.Generator().manual_seed(7), feats, lens, cfg)
    assert torch.equal(a, b)
    assert not a[1, 33:].any()                         # padding stays 0
