from tpu_asr_torch.ops.cif import (cif_fire, cif_weights, fire_count,
                                   quantity_loss, scale_alphas)
from tpu_asr_torch.ops.cif_fire import CifFire, cif_fire_fwd, cif_fire_kernel
from tpu_asr_torch.ops.ctc import ctc_greedy_collapse
from tpu_asr_torch.ops.ctc_prefix import (ctc_prefix_scan,
                                          ctc_prefix_scan_reference)
from tpu_asr_torch.ops.topk import exact_top_k

__all__ = ["CifFire", "cif_fire", "cif_fire_fwd", "cif_fire_kernel",
           "cif_weights", "ctc_greedy_collapse", "ctc_prefix_scan",
           "ctc_prefix_scan_reference", "exact_top_k", "fire_count",
           "quantity_loss", "scale_alphas"]
