from tpu_asr_torch.ops.ctc import ctc_greedy_collapse
from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                          ctc_prefix_scan_reference)
from tpu_asr_torch.ops.topk import exact_top_k

__all__ = ["ctc_greedy_collapse", "ctc_prefix_scan",
           "ctc_prefix_scan_reference", "exact_top_k"]
