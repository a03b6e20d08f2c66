from tpu_asr_torch.models.cif import CifModel
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.transducer import TransducerModel
from tpu_asr_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig):
    """Model-type dispatch (port of tpu_asr.models.build_model): cif ->
    CifModel; transducer -> TransducerModel; transformer/ctc/hybrid share
    the Transformer glue (which raises for any other type)."""
    if cfg.model_type == "cif":
        return CifModel(cfg)
    if cfg.model_type == "transducer":
        return TransducerModel(cfg)
    return Transformer(cfg)


__all__ = ["ModelConfig", "Encoder", "Decoder", "Transformer", "CifModel",
           "TransducerModel", "build_model"]
