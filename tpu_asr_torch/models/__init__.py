from tpu_asr_torch.models.cif import CifModel
from tpu_asr_torch.models.config import ModelConfig, WhisperConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.transducer import TransducerModel
from tpu_asr_torch.models.transformer import Transformer
from tpu_asr_torch.models.whisper import Whisper


def build_model(cfg: ModelConfig):
    """Model-type dispatch (port of tpu_asr.models.build_model): a
    WhisperConfig -> Whisper; cif -> CifModel; transducer ->
    TransducerModel; transformer/ctc/hybrid share the Transformer glue
    (which raises for any other type)."""
    if isinstance(cfg, WhisperConfig):
        return Whisper(cfg)
    if cfg.model_type == "cif":
        return CifModel(cfg)
    if cfg.model_type == "transducer":
        return TransducerModel(cfg)
    return Transformer(cfg)


__all__ = ["ModelConfig", "WhisperConfig", "Encoder", "Decoder",
           "Transformer", "CifModel", "TransducerModel", "Whisper",
           "build_model"]
