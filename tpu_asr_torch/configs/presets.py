"""Named experiment presets (port of tpu_asr/configs/presets.py).

Only the presets of the families the port runs are here (CTC,
attention, with the conv2d or the LFR + linear input layer, hybrid
CTC/attention with the transformer or the conformer encoder, CIF, the
transducer with either encoder, and the chunk-masked streaming CTC and
transducer models), and Whisper, which the reference has not (openai/
whisper: large-v3 at its published dimensions, and a CPU-sized slice).
Each preset is a TrainConfig with the reference's field names and
values; the CLIs override fields from flags.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_asr_torch.augment import SpecAugmentConfig
from tpu_asr_torch.decode.beam import BeamConfig
from tpu_asr_torch.frontend import FrontendConfig, WhisperFrontendConfig
from tpu_asr_torch.models.config import ModelConfig, WhisperConfig


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
    # Transformer-CTC encoder, greedy decode (CPU-runnable slice)
    "ctc_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="ctc", d_model=256, d_inner=1024,
            num_enc_layers=4, num_dec_layers=0),
        epochs=20, warmup_steps=1000, batch_frames=8000,
        decode_mode="greedy_ctc",
        beam=BeamConfig(beam=1)),
    # attention-only Speech-Transformer: label smoothing + beam search
    "attention": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="transformer"),
        decode_mode="beam",
        beam=BeamConfig(beam=5, max_len=100)),
    # the same with the reference lineage's default LFR(4, 3) + linear
    # input layer (kaituoxu/Speech-Transformer) instead of conv2d
    "attention_lfr": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="transformer",
                                  input_layer="linear", lfr_m=4, lfr_n=3),
        decode_mode="beam",
        beam=BeamConfig(beam=5, max_len=100)),
    # CPU-runnable hybrid slice (tests, demos)
    "hybrid_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="hybrid", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_dec_layers=2,
            dropout=0.0),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="joint",
        beam=BeamConfig(beam=5, max_len=24, ctc_weight=0.3)),
    # hybrid CTC/attention at the reference's widths, float32; the
    # reference's own held-out table picks attn_rescore as its default
    # decode, and ctc_beam with an external LM (--lm-weight 0.1) as its
    # best (tpu_asr/configs/presets.py)
    "hybrid": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="hybrid",
                                  ctc_weight=0.3),
        decode_mode="attn_rescore",
        beam=BeamConfig(beam=10, max_len=100, ctc_weight=0.3)),
    # full-scale AISHELL hybrid model (the flagship the bench measures)
    "aishell": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="hybrid",
                                  ctc_weight=0.3, dtype=torch.bfloat16,
                                  conv_channels=(32, 128), pallas_ctc=True),
        epochs=80, batch_frames=32000, num_buckets=6,
        specaug=SpecAugmentConfig(),
        decode_mode="attn_rescore",
        beam=BeamConfig(beam=10, max_len=100, ctc_weight=0.3)),
    # conformer encoder: macaron blocks with relative-position MHSA and a
    # depthwise-conv module under the hybrid objective (the encoder type
    # swapped, everything else unchanged)
    "conformer_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="hybrid", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_dec_layers=2,
            dropout=0.0, encoder_type="conformer", conv_kernel=7),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="joint",
        beam=BeamConfig(beam=5, max_len=24, ctc_weight=0.3)),
    # the aishell recipe with the conformer encoder
    "conformer": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="hybrid",
                                  ctc_weight=0.3, dtype=torch.bfloat16,
                                  conv_channels=(32, 128), pallas_ctc=True,
                                  encoder_type="conformer"),
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
    # transducer: RNN-T with a causal-transformer predictor and an aux
    # CTC head (ctc_weight), which also gives greedy_ctc/ctc_beam
    "transducer_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="transducer", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_pred_layers=1,
            d_joint=64, dropout=0.0),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="transducer_greedy",
        beam=BeamConfig(beam=1, max_len=24)),
    # the transducer with the conformer encoder (CPU-runnable slice)
    "conformer_transducer_dev": TrainConfig(
        model=dataclasses.replace(
            _BASE, model_type="transducer", ctc_weight=0.3, d_model=64,
            d_inner=128, num_heads=2, num_enc_layers=2, num_pred_layers=1,
            d_joint=64, dropout=0.0, encoder_type="conformer",
            conv_kernel=7),
        epochs=30, warmup_steps=100, lr_k=1.0, batch_frames=8000,
        num_buckets=2, decode_mode="transducer_greedy",
        beam=BeamConfig(beam=1, max_len=24)),
    # d512/h8/6 encoder layers, 2 predictor layers, d_joint 512; the
    # reference's default decode is the two-pass rescore (CTC prefix beam
    # n-best ranked by the exact transducer marginal)
    "transducer": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="transducer",
                                  ctc_weight=0.3, num_pred_layers=2,
                                  d_joint=512),
        decode_mode="transducer_rescore",
        beam=BeamConfig(beam=10, max_len=100, ctc_weight=0.5)),
    # the conformer-transducer with the offline chunk mask (16 frames)
    "conformer_transducer": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="transducer",
                                  ctc_weight=0.3, num_pred_layers=2,
                                  d_joint=512, encoder_type="conformer",
                                  enc_chunk_size=16),
        decode_mode="transducer_greedy",
        beam=BeamConfig(beam=1, max_len=100)),
    # the streaming transducer: the chunk-masked transformer encoder
    # (16 frames a chunk) under the transducer's frame-synchronous decode
    "transducer_streaming": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="transducer",
                                  ctc_weight=0.3, num_pred_layers=2,
                                  d_joint=512, enc_chunk_size=16),
        decode_mode="transducer_greedy",
        beam=BeamConfig(beam=1, max_len=100)),
    # streaming CTC: the chunk-masked encoder, 16 encoder frames (0.64 s)
    # a chunk; decoded offline (greedy_ctc) or as it arrives
    # (decode/streaming.py, python -m tpu_asr_torch.stream_demo)
    "streaming": TrainConfig(
        model=dataclasses.replace(_BASE, model_type="ctc",
                                  enc_chunk_size=16),
        decode_mode="greedy_ctc",
        beam=BeamConfig(beam=1, max_len=100)),
    # Whisper large-v3 (openai/whisper __init__.py _MODELS["large-v3"],
    # model.py ModelDimensions): n_mels 128, n_audio_ctx 1500, n_state
    # 1280, 20 heads, 32 + 32 layers, n_vocab 51866, n_text_ctx 448;
    # bf16 compute over float32 parameters (openai serves fp16); decoded
    # by the attention beam after its 4-token prompt (<|zh|>
    # <|transcribe|> <|notimestamps|>), beam 5 as openai's CLI
    "whisper_large_v3": TrainConfig(
        model=WhisperConfig(
            vocab_size=51866, d_input=128, d_model=1280, d_inner=5120,
            num_heads=20, num_enc_layers=32, num_dec_layers=32,
            pe_maxlen=448, audio_ctx=1500, dtype=torch.bfloat16,
            use_pallas=True),
        frontend=WhisperFrontendConfig(),
        decode_mode="beam",
        beam=BeamConfig(beam=5, max_len=100)),
    # CPU-runnable Whisper slice (tests, demos): 1 s windows of 128 mel
    # bins, a 96-id vocabulary whose last six ids are the specials
    "whisper_dev": TrainConfig(
        model=WhisperConfig(
            vocab_size=96, d_input=128, d_model=64, d_inner=256,
            num_heads=2, num_enc_layers=2, num_dec_layers=2, pe_maxlen=128,
            audio_ctx=50, eot=90, sot_sequence=(91, 92, 93, 94)),
        frontend=WhisperFrontendConfig(chunk_s=1.0),
        decode_mode="beam",
        beam=BeamConfig(beam=5, max_len=24)),
}


# the presets of models the reference (tpu_asr) does not have
PORT_ONLY = ("whisper_large_v3", "whisper_dev")


def get_preset(name: str) -> TrainConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
