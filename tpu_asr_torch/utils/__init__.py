from tpu_asr_torch.utils.device import resolve_device
from tpu_asr_torch.utils.padding import (make_causal_mask, make_valid_mask,
                                         pad_list)

__all__ = ["resolve_device", "make_causal_mask", "make_valid_mask",
           "pad_list"]
