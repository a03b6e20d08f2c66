"""Named model presets (port of tpu_asr/configs/presets.py).

Only the hybrid CTC/attention presets that the serving slice runs are
here; the other families' presets come with their ports.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Preset:
    model: ModelConfig
    beam: BeamConfig = BeamConfig()
    decode_mode: str = "beam"


_BASE = ModelConfig()  # d512/h8/6+6, conv2d input — reference defaults

PRESETS: dict[str, Preset] = {
    # CPU-runnable hybrid slice (tests, demos)
    "hybrid_dev": Preset(
        model=dataclasses.replace(
            _BASE, model_type="hybrid", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_dec_layers=2,
            dropout=0.0),
        decode_mode="joint",
        beam=BeamConfig(beam=5, max_len=24, ctc_weight=0.3)),
    # full-scale AISHELL hybrid model (the flagship the bench measures);
    # the reference preset decodes with attn_rescore by default, which is
    # not ported yet — the port serves it in joint mode.
    "aishell": Preset(
        model=dataclasses.replace(_BASE, model_type="hybrid",
                                  ctc_weight=0.3, dtype=torch.bfloat16,
                                  conv_channels=(32, 128), pallas_ctc=True),
        decode_mode="joint",
        beam=BeamConfig(beam=10, max_len=100, ctc_weight=0.3)),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
