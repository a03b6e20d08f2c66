"""Named experiment presets (port of tpu_asr/configs/presets.py).

Only the presets of the families the port runs are here (hybrid
CTC/attention and CIF); the other families' presets come with their
ports. Each preset is a TrainConfig with the reference's field names and
values; the CLIs override fields from flags.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_asr_torch.augment import SpecAugmentConfig
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.frontend import FrontendConfig
from tpu_asr_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    epochs: int = 30
    warmup_steps: int = 4000
    lr_k: float = 1.0
    grad_clip: float = 5.0
    accum_steps: int = 1           # >1: the Noam/Adam update applies every
    #                                k-th step on the averaged grads
    batch_frames: int = 16000      # per-batch input budget (bucket planning)
    batch_size: int | None = None  # fixed utts/batch (overrides the budget)
    num_buckets: int = 4
    max_frames_cap: int = 3000
    max_tokens_cap: int = 200
    specaug: SpecAugmentConfig | None = None
    frontend: FrontendConfig = FrontendConfig()
    beam: BeamConfig = BeamConfig()
    decode_mode: str = "beam"
    print_freq: int = 50
    seed: int = 0


_BASE = ModelConfig()  # d512/h8/6+6, conv2d input — reference defaults

PRESETS: dict[str, TrainConfig] = {
    # CPU-runnable hybrid slice (tests, demos)
    "hybrid_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="hybrid", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_dec_layers=2,
            dropout=0.0),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="joint",
        beam=BeamConfig(beam=5, max_len=24, ctc_weight=0.3)),
    # full-scale AISHELL hybrid model (the flagship the bench measures)
    "aishell": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="hybrid",
                                  ctc_weight=0.3, dtype=torch.bfloat16,
                                  conv_channels=(32, 128), pallas_ctc=True),
        epochs=80, batch_frames=32000, num_buckets=6,
        specaug=SpecAugmentConfig(),
        decode_mode="attn_rescore",
        beam=BeamConfig(beam=10, max_len=100, ctc_weight=0.3)),
    # CPU-runnable CIF slice (tests, demos)
    "cif_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="cif", ctc_weight=0.5,
            cif_quantity_weight=1.0, d_model=64, d_inner=128, num_heads=2,
            num_enc_layers=2, num_dec_layers=2, dropout=0.0),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="cif_greedy",
        beam=BeamConfig(beam=1, max_len=24)),
    # CIF (the reference's config #4): d512/h8/6+6, conv 256, float32
    "cif": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="cif", ctc_weight=0.5,
                                  cif_quantity_weight=1.0),
        decode_mode="cif_greedy",
        beam=BeamConfig(beam=1, max_len=100)),
}


def get_preset(name: str) -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
