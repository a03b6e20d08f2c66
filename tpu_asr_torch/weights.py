"""Weights for the port's modules: flax params carried across, or a
seeded random init.

`load_jax_params(model, params)` takes the flax variable tree of
tpu_asr.models.Transformer or CifModel as nested dicts of numpy arrays (what
`jax.device_get(variables)` returns), or an .npz file / flat dict whose
keys are the "/"-joined flax paths. The port's module names follow the
flax paths, so each key maps mechanically:

  layer_<i>              -> layers.<i>
  LayerNorm_0/scale|bias -> norm.weight|bias
  Dense kernel [in, out]             -> Linear.weight [out, in]
  DenseGeneral q/k/v kernel [D,H,dh] -> [H*dh, D]; bias [H, dh] -> [H*dh]
  out_proj kernel [H, dh, D]         -> [D, H*dh]
  Conv kernel HWIO (3,3,I,O)         -> OIHW
  assigner/conv kernel WIO (3,I,O)   -> Conv1d OIW
  embed/embedding [V, D]             -> embed.weight (tied output proj)

Any missing key, extra key or shape mismatch raises.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
from torch import nn

from tpu_asr_torch.models.modules import LayerNorm


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def flax_to_torch(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax leaf ("encoder/layer_0/slf_attn/q_proj/kernel") -> the
    port's state_dict key and the array in torch's layout."""
    parts = path.split("/")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    v = np.asarray(value, np.float32)
    if leaf == "kernel":
        if v.ndim == 4:                                  # Conv HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        elif owner == "conv" and v.ndim == 3:            # Conv WIO -> OIW
            v = v.transpose(2, 1, 0)
        elif owner == "out_proj" and v.ndim == 3:        # [H, dh, D]
            v = v.reshape(-1, v.shape[-1]).T
        elif v.ndim == 3:                                # [D, H, dh]
            v = v.reshape(v.shape[0], -1).T
        else:                                            # Dense [in, out]
            v = v.T
        leaf = "weight"
    elif leaf == "bias" and v.ndim == 2:                 # DenseGeneral [H, dh]
        v = v.reshape(-1)
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    key = "/".join(parts[:-1] + [leaf])
    key = re.sub(r"layer_(\d+)", r"layers/\1", key)
    key = key.replace("LayerNorm_0", "norm").replace("/", ".")
    return key, np.ascontiguousarray(v)


def load_jax_params(model: nn.Module, params) -> None:
    """Fill `model` (a tpu_asr_torch Transformer or CifModel) from flax
    params; see the module docstring for the accepted forms. Strict:
    raises KeyError on a missing or extra key and ValueError on a shape
    mismatch."""
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as z:
            params = {k: z[k] for k in z.files}
    flat = (_flatten(params) if any(isinstance(v, dict)
                                    for v in params.values())
            else {k: np.asarray(v) for k, v in params.items()})
    flat = {(k[len("params/"):] if k.startswith("params/") else k): v
            for k, v in flat.items()}
    converted = dict(flax_to_torch(k, v) for k, v in flat.items())
    state = model.state_dict()
    missing = sorted(set(state) - set(converted))
    extra = sorted(set(converted) - set(state))
    if missing or extra:
        raise KeyError(f"flax params do not match the model: missing "
                       f"{missing[:8]}, extra {extra[:8]}")
    with torch.no_grad():
        for key, arr in converted.items():
            dst = state[key]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{key}: flax shape {arr.shape} (converted) "
                                 f"!= model shape {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr))


# std of a unit normal truncated to [-2, 2]; flax's variance_scaling
# divides by it so that the truncated draws keep variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init on the CPU with flax's default initializers:
    Dense and Conv weights lecun_normal (a normal truncated at +-2 sigma,
    sigma = 1 / (sqrt(fan_in) * TRUNC_STD), so the variance is 1/fan_in),
    Embed N(0, 1/D), biases 0, LayerNorm scale 1. fan_in is the input
    width (a conv's in_channels times its kernel size). Same seed, same
    weights, on any machine."""
    g = torch.Generator().manual_seed(seed)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                fan_in = m.weight[0].numel()
                m.weight.copy_(w / (fan_in ** 0.5 * TRUNC_STD))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                d = m.weight.shape[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / d ** 0.5)
    return model


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store Linear/Conv/Embedding weights in the compute dtype. The
    reference keeps float32 params and casts them to the compute dtype at
    every use, which rounds to the same values; casting once saves that
    work on every decode step. LayerNorm params stay float32 (its
    statistics are float32)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Embedding)):
            m.to(dtype)
    return model
