from tpu_asr_torch.decode.beam import BeamConfig, attention_beam_search
from tpu_asr_torch.decode.ctc_prefix import CTCPrefixScorer
from tpu_asr_torch.decode.greedy_ctc import ctc_greedy_decode

__all__ = ["BeamConfig", "attention_beam_search", "CTCPrefixScorer",
           "ctc_greedy_decode"]
