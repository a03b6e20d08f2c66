"""The original PyTorch repo's checkpoint format (`.pth.tar`, its
`Transformer.serialize` layout) into and out of the port (port of
tpu_asr/parity/torch_import.py and torch_export.py; torch and numpy
only)."""

from tpu_asr_torch.parity.torch_export import (export_torch_checkpoint,
                                               flax_to_reference_state_dict)
from tpu_asr_torch.parity.torch_import import (KEY_ALIASES,
                                               infer_config_overrides,
                                               load_torch_checkpoint,
                                               load_torch_model,
                                               torch_state_dict_to_flax)

__all__ = ["KEY_ALIASES", "export_torch_checkpoint",
           "flax_to_reference_state_dict", "infer_config_overrides",
           "load_torch_checkpoint", "load_torch_model",
           "torch_state_dict_to_flax"]
