from tpu_asr_torch.models.config import ModelConfig
from tpu_asr_torch.models.decoder import Decoder
from tpu_asr_torch.models.encoder import Encoder
from tpu_asr_torch.models.transformer import Transformer

__all__ = ["ModelConfig", "Encoder", "Decoder", "Transformer"]
