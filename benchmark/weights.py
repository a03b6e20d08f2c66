"""Seeded weights, made on the device in one draw, handed to the program
and to the reference alike.

Every parameter that is drawn takes its slice of ONE `torch.randn` call
on a generator of the device seeded from the run's seed, in the order of
the reference's parameter spec: matrices and convolution kernels scaled
to variance 1 / fan_in, the embedding to 1 / d_model; biases start at 0
and LayerNorm scales at 1.
"""

from __future__ import annotations

import math

import torch

WEIGHT_SEED_SALT = 0x5EED


def make_weights(spec, seed: int, device, d_model: int) -> dict:
    """spec: [(name, shape, init)] -> {name: float32 tensor on device}."""
    drawn = [(n, s) for n, s, init in spec if init in ("fan_in", "embed")]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ WEIGHT_SEED_SALT) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init in ("zeros", "ones"):
            fill = 0.0 if init == "zeros" else 1.0
            out[name] = torch.full(shape, fill, device=device)
            continue
        n = math.prod(shape)
        fan_in = d_model if init == "embed" else math.prod(shape[1:])
        out[name] = flat[at:at + n].view(shape) / math.sqrt(fan_in)
        at += n
    return out
