from tpu_asr_torch.models.cif import CifModel
from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig):
    """Model-type dispatch (port of tpu_asr.models.build_model): cif ->
    CifModel; transformer/ctc/hybrid share the Transformer glue (which
    raises for the families not ported yet)."""
    if cfg.model_type == "cif":
        return CifModel(cfg)
    return Transformer(cfg)


__all__ = ["ModelConfig", "Encoder", "Decoder", "Transformer", "CifModel",
           "build_model"]
