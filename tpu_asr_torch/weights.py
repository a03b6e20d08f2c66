"""Weights for the port's modules: flax params carried across, or a
seeded random init.

`load_jax_params(model, params)` takes the flax variable tree of
tpu_asr.models.Transformer (transformer or conformer encoder, conv2d or
LFR + linear input layer), CifModel,
TransducerModel or lm.TransformerLM as nested dicts of numpy arrays (what
`jax.device_get(variables)` returns), or an .npz file / flat dict whose
keys are the "/"-joined flax paths. The port's module names follow the
flax paths, so each key maps mechanically:

  layer_<i>              -> layers.<i>
  LayerNorm_0/scale|bias -> norm.weight|bias (a named LayerNorm, as
                            the encoder's norm_in: <name>.weight|bias)
  Dense kernel [in, out]             -> Linear.weight [out, in]
  DenseGeneral q/k/v kernel [D,H,dh] -> [H*dh, D]; bias [H, dh] -> [H*dh]
  out_proj kernel [H, dh, D]         -> [D, H*dh]
  Conv kernel HWIO (3,3,I,O)         -> OIHW
  assigner/conv kernel WIO (3,I,O)   -> Conv1d OIW
  depthwise kernel [k, 1, C]         -> [C, 1, k] (Conv1d, groups=C)
  pos_proj kernel [D, H, dh]         -> [H*dh, D] (no bias)
  u_bias/v_bias [H, dh]              -> kept as they are
  embed/embedding [V, D]             -> embed.weight (tied output proj)
  joint_out_kernel [dj, V], joint_out_bias [V] (TransducerModel's raw
    top-level params)                -> kept as they are, same names

Any missing key, extra key or shape mismatch raises.

`torch_to_flax(model)` is the exact inverse: the model's state_dict as
the flat "/"-joined flax paths and layouts that `load_jax_params` reads
(what the reference-format export and an .npz of flax params start
from).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
from torch import nn

from tpu_asr_torch.models.modules import LayerNorm, PostNormBlock


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
        elif owner == "depthwise":                       # [k, 1, C]
            if v.ndim != 3 or v.shape[1] != 1:
                raise ValueError(f"{path}: a depthwise kernel is [k, 1, C], "
                                 f"not {list(v.shape)}")
            v = v.transpose(2, 1, 0)                     # -> [C, 1, k]
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
    """Fill `model` (a tpu_asr_torch Transformer, with either encoder,
    CifModel, TransducerModel or TransformerLM) from flax params; see the
    module docstring for the accepted forms. Strict: raises KeyError on a
    missing or extra key and ValueError on a shape mismatch (a depthwise
    kernel that is not [k, 1, C] included)."""
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


def _flax_leaf(owner: nn.Module, parent: nn.Module | None, name: str,
               leaf: str, w: np.ndarray) -> tuple[str, np.ndarray]:
    """One port parameter `<name>.<leaf>` of module `owner` (a child of
    `parent`) -> its flax leaf name and array: flax_to_torch's layout
    rules run backwards."""
    if isinstance(owner, LayerNorm):
        return ("scale" if leaf == "weight" else leaf), w
    if isinstance(owner, nn.Embedding):
        return "embedding", w
    heads = getattr(parent, "num_heads", None)
    if isinstance(owner, nn.Linear) and heads:        # DenseGeneral
        if name == "out_proj" and leaf == "weight":    # [D, H*dh]
            return "kernel", w.T.reshape(heads, -1, w.shape[0])
        if name != "out_proj":                         # q/k/v/pos_proj
            if leaf == "weight":                       # [H*dh, D]
                return "kernel", w.T.reshape(w.shape[1], heads, -1)
            return leaf, w.reshape(heads, -1)
    if leaf != "weight":
        return leaf, w
    if w.ndim == 4:                                    # OIHW -> HWIO
        return "kernel", w.transpose(2, 3, 1, 0)
    if w.ndim == 3:                                    # OIW / [C, 1, k]
        return "kernel", w.transpose(2, 1, 0)
    return "kernel", w.T


def torch_to_flax(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's parameters as the flat "/"-joined flax paths (no
    "params/" head) and flax layouts, float32: the inverse of
    load_jax_params. Each leaf is checked by running flax_to_torch on it,
    which must give back the state_dict key and the same bits."""
    modules = dict(model.named_modules())
    out = {}
    for key, t in model.state_dict().items():
        w = t.detach().cpu().float().numpy()
        owner_name, _, leaf = key.rpartition(".")
        parts = owner_name.split(".") if owner_name else []
        flax_parts = []
        for i, part in enumerate(parts):
            prefix = ".".join(parts[:i])
            if part.isdigit() and parts[i - 1] == "layers":
                flax_parts[-1] = f"layer_{part}"
            elif part == "norm" and isinstance(
                    modules.get(prefix), PostNormBlock):
                flax_parts.append("LayerNorm_0")
            else:
                flax_parts.append(part)
        parent = modules.get(".".join(parts[:-1])) if parts else None
        flax_leaf, arr = _flax_leaf(modules[owner_name], parent,
                                    parts[-1] if parts else "", leaf, w)
        path = "/".join(flax_parts + [flax_leaf])
        arr = np.ascontiguousarray(arr)
        back_key, back = flax_to_torch(path, arr)
        if back_key != key or not np.array_equal(back, w):
            raise ValueError(f"{key}: flax path {path} does not map back "
                             f"(to {back_key})")
        out[path] = arr
    return out


# std of a unit normal truncated to [-2, 2]; flax's variance_scaling
# divides by it so that the truncated draws keep variance 1 / fan_in
TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    return w / (fan_in ** 0.5 * TRUNC_STD)


def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init on the CPU with flax's default initializers:
    Dense and Conv weights lecun_normal (a normal truncated at +-2 sigma,
    sigma = 1 / (sqrt(fan_in) * TRUNC_STD), so the variance is 1/fan_in),
    Embed N(0, 1/D) (nn.Embed's variance_scaling(1, fan_in, normal) over
    [V, D]; also the TransformerLM's `embed`), biases 0, LayerNorm scale
    1. fan_in is the input width (a conv's in_channels times its kernel
    size; dim 0 of the TransducerModel's raw joint_out_kernel [d_joint,
    V], whose joint_out_bias is 0). Same seed, same weights, on any
    machine."""
    g = torch.Generator().manual_seed(seed)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                m.weight.copy_(_lecun_normal(m.weight.shape,
                                             m.weight[0].numel(), g))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                d = m.weight.shape[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / d ** 0.5)
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "joint_out_kernel":
                p.copy_(_lecun_normal(p.shape, p.shape[0], g))
            elif leaf == "joint_out_bias":
                p.zero_()
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
