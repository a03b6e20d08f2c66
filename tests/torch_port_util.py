"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

A tiny hybrid model at hybrid_dev widths (d64, h2, 2+2 layers, conv
(8, 16), vocab 32), or the CIF model at cif_dev widths (the same, with
ctc weight 0.5), is initialised by flax on the CPU; the same params are
loaded into the port with load_jax_params. Inputs come from numpy with a
seed and go to both packages as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

VOCAB = 32
CONV = (8, 16)


def jax_cfg(**kw):
    from tpu_asr.configs.presets import get_preset
    return dataclasses.replace(get_preset("hybrid_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


def torch_cfg(**kw):
    from tpu_asr_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset("hybrid_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


@functools.lru_cache(maxsize=2)
def flax_params(seed: int = 0):
    """Flax variables of tpu_asr.models.Transformer as numpy (host) arrays."""
    from tpu_asr.models import Transformer
    v = Transformer(jax_cfg()).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32))
    return jax.device_get(v)


def flat_flax_params(seed: int = 0) -> dict:
    """flax_params as one flat dict keyed by the "/"-joined paths."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v
    walk(flax_params(seed), "")
    return flat


def torch_model(seed: int = 0, **cfg_kw):
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import load_jax_params
    model = Transformer(torch_cfg(**cfg_kw))
    load_jax_params(model, flax_params(seed))
    return model


def wav_batch(lengths, seed: int = 0, n_samples: int | None = None):
    """Padded float32 waveforms [B, S] (speech-like: a tone plus noise)."""
    rng = np.random.default_rng(seed)
    s = n_samples or max(lengths)
    wav = np.zeros((len(lengths), s), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        wav[i, :n] = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                      + 0.05 * rng.standard_normal(n))
    return {"wav": wav, "wav_lengths": np.asarray(lengths, np.int32)}


# ---- the CIF model at cif_dev widths (d64, h2, 2+2 layers, ctc 0.5) ----

def cif_jax_cfg(**kw):
    from tpu_asr.configs.presets import get_preset
    return dataclasses.replace(get_preset("cif_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


def cif_torch_cfg(**kw):
    from tpu_asr_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset("cif_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


@functools.lru_cache(maxsize=2)
def cif_flax_params(seed: int = 0):
    """Flax variables of tpu_asr.models.CifModel as numpy (host) arrays."""
    from tpu_asr.models import CifModel
    v = CifModel(cif_jax_cfg()).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32))
    return jax.device_get(v)


def cif_torch_model(seed: int = 0, **cfg_kw):
    from tpu_asr_torch.models.cif import CifModel
    from tpu_asr_torch.weights import load_jax_params
    model = CifModel(cif_torch_cfg(**cfg_kw))
    load_jax_params(model, cif_flax_params(seed))
    return model
