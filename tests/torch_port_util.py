"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

A tiny hybrid model at hybrid_dev widths (d64, h2, 2+2 layers, conv
(8, 16), vocab 32), or the CIF model at cif_dev widths (the same, with
ctc weight 0.5), is initialised by flax on the CPU (the ASR models'
`init` under jax.jit: the same values as an eager init, one compile
instead of one an op); the same params are loaded into the port with
load_jax_params. Inputs come from numpy with a
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
    v = jax.jit(Transformer(jax_cfg()).init)(
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
    v = jax.jit(CifModel(cif_jax_cfg()).init)(
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


# ---- the external Transformer LM (d32, h2, 2 layers, dropout 0) ----

def lm_cfgs(vocab: int = VOCAB, **kw):
    """(tpu_asr LMConfig, tpu_asr_torch LMConfig) with equal fields."""
    from tpu_asr.models.lm import LMConfig as JaxLMConfig
    from tpu_asr_torch.models.lm import LMConfig
    fields = dict(vocab_size=vocab, d_model=32, d_inner=64, num_heads=2,
                  num_layers=2, dropout=0.0, **kw)
    return JaxLMConfig(**fields), LMConfig(**fields)


@functools.lru_cache(maxsize=4)
def lm_flax_params(vocab: int = VOCAB, seed: int = 3,
                   tie_embedding: bool = True):
    """Flax variables of tpu_asr.models.lm.TransformerLM as numpy."""
    from tpu_asr.models.lm import TransformerLM
    jcfg, _ = lm_cfgs(vocab, tie_embedding=tie_embedding)
    v = TransformerLM(jcfg).init(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 4), jnp.int32))
    return jax.device_get(v)


def lm_pair(vocab: int = VOCAB, seed: int = 3, tie_embedding: bool = True):
    """(jax LM module, its variables, port LM with the same weights)."""
    from tpu_asr.models.lm import TransformerLM as JaxLM
    from tpu_asr_torch.models.lm import TransformerLM
    from tpu_asr_torch.weights import load_jax_params
    jcfg, tcfg = lm_cfgs(vocab, tie_embedding=tie_embedding)
    v = lm_flax_params(vocab, seed, tie_embedding)
    lm = TransformerLM(tcfg)
    load_jax_params(lm, v)
    return JaxLM(jcfg), v, lm


# ---- the conformer at conformer_dev widths (d64, h2, 2+2 layers, conv
# kernel 7; the hybrid objective) ----

def conformer_jax_cfg(**kw):
    from tpu_asr.configs.presets import get_preset
    return dataclasses.replace(get_preset("conformer_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


def conformer_torch_cfg(**kw):
    from tpu_asr_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset("conformer_dev").model,
                               vocab_size=VOCAB, conv_channels=CONV, **kw)


@functools.lru_cache(maxsize=2)
def conformer_flax_params(seed: int = 0):
    """Flax variables of tpu_asr.models.Transformer with the conformer
    encoder, as numpy (host) arrays. The rel-pos biases u and v start at
    zero in flax; they are drawn here so that a mix-up of the two shows."""
    from tpu_asr.models import Transformer
    v = jax.jit(Transformer(conformer_jax_cfg()).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    rng = np.random.default_rng(seed + 100)
    enc = v["params"]["encoder"]
    for name, layer in enc.items():
        if name.startswith("layer_"):
            for b in ("u_bias", "v_bias"):
                shape = layer["slf_attn"][b].shape
                layer["slf_attn"][b] = (0.5 * rng.standard_normal(shape)
                                        ).astype(np.float32)
    return v


def conformer_torch_model(seed: int = 0, **cfg_kw):
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.weights import load_jax_params
    model = Transformer(conformer_torch_cfg(**cfg_kw))
    load_jax_params(model, conformer_flax_params(seed))
    return model


# ---- the transducer at transducer_dev / conformer_transducer_dev widths
# (d64, h2, 2 encoder layers, 1 predictor layer, d_joint 64, aux CTC 0.3)

def transducer_jax_cfg(preset: str = "transducer_dev", **kw):
    from tpu_asr.configs.presets import get_preset
    return dataclasses.replace(get_preset(preset).model, vocab_size=VOCAB,
                               conv_channels=CONV, **kw)


def transducer_torch_cfg(preset: str = "transducer_dev", **kw):
    from tpu_asr_torch.configs.presets import get_preset
    return dataclasses.replace(get_preset(preset).model, vocab_size=VOCAB,
                               conv_channels=CONV, **kw)


@functools.lru_cache(maxsize=8)
def transducer_flax_params(preset: str = "transducer_dev", seed: int = 0,
                           ctc_weight: float = 0.3):
    """Flax variables of tpu_asr.models.TransducerModel as numpy. The
    joint bias and a conformer's rel-pos biases start at zero in flax;
    they are drawn here so that a mix-up shows."""
    from tpu_asr.models import TransducerModel
    v = jax.jit(TransducerModel(transducer_jax_cfg(
        preset, ctc_weight=ctc_weight)).init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 80, 80)),
                               jnp.full((1,), 80, jnp.int32),
                               jnp.zeros((1, 4), jnp.int32),
                               jnp.full((1,), 4, jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    rng = np.random.default_rng(seed + 200)
    p = v["params"]
    p["joint_out_bias"] = (0.1 * rng.standard_normal(
        p["joint_out_bias"].shape)).astype(np.float32)
    for name, layer in p["encoder"].items():
        if name.startswith("layer_") and "u_bias" in layer["slf_attn"]:
            for b in ("u_bias", "v_bias"):
                layer["slf_attn"][b] = (0.5 * rng.standard_normal(
                    layer["slf_attn"][b].shape)).astype(np.float32)
    return v


def transducer_torch_model(preset: str = "transducer_dev", seed: int = 0,
                           ctc_weight: float = 0.3, **cfg_kw):
    from tpu_asr_torch.models.transducer import TransducerModel
    from tpu_asr_torch.weights import load_jax_params
    model = TransducerModel(transducer_torch_cfg(preset, ctc_weight=ctc_weight,
                                                 **cfg_kw))
    load_jax_params(model, transducer_flax_params(preset, seed, ctc_weight))
    return model
